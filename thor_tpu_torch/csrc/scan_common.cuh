// The schedule shared by the two intra scans whose TUs run side by side on
// all SMs: the decoder's (intra_scan.cu) and the encoder's
// (enc_intra_scan.cu). Each includes it once, into its own library; its
// kernels and host helpers are static there.
//
// Both scans hand out units of work (a TU on one plane, or a slice of one)
// in the scan's order from an atomic ticket to warps that already run. A
// unit reads a context sample from the output planes only when an earlier
// TU of the launch writes it, and polls it there until it is no longer
// PENDING: every TU pixel is marked PENDING before the scan starts, and a
// pixel is written once, so it is its own flag. Every other sample comes
// from the input planes, which the launch never writes.

#pragma once

#include <cuda_runtime.h>

#include "intra_predict.cuh"

namespace thor {

constexpr int SCAN_NF = 7;  // record: ty, tx, size, mode, toplen, leftlen, cbx

// Pixels of the output planes are read by other SMs while the scan runs:
// both sides go to L2 with strong accesses.
__device__ __forceinline__ void st_pixel(int* p, int v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_pixel(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// the ticket and the owner map as the scans expect them
static __global__ void scan_init_kernel(int* ticket, int* owner, int ncell) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) *ticket = 0;
  if (i < ncell) owner[i] = -1;
}

// owner[cell] = index of the TU that covers the 4x4 cell, and the TU's
// pixels PENDING in all C output planes; one block per record, and the
// records from *count on (when count is not null) are left alone
static __global__ void scan_owner_kernel(const int* __restrict__ recs,
                                         const int* __restrict__ count,
                                         int* __restrict__ owner, int cw,
                                         int* __restrict__ out, int C,
                                         int H, int W) {
  const int t = blockIdx.x;
  if (count != nullptr && t >= __ldg(count)) return;
  const int* rc = recs + static_cast<size_t>(t) * SCAN_NF;
  const int ty = rc[0], tx = rc[1], s = rc[2], n = s >> 2;
  for (int p = threadIdx.x; p < n * n; p += blockDim.x) {
    owner[((ty >> 2) + p / n) * cw + (tx >> 2) + p % n] = t;
  }
  const size_t HW = static_cast<size_t>(H) * W;
  for (int p = threadIdx.x; p < s * s * C; p += blockDim.x) {
    const int plane = p / (s * s), r = p - plane * s * s;
    out[plane * HW + static_cast<size_t>(ty + r / s) * W + tx + r % s] =
        PENDING;
  }
}

// Clears the ticket and the owner map, then fills the map and marks the
// TUs' pixels PENDING in `out`: the two prologue kernels of either scan,
// on `s`. owner: ceil(H/4) ceil(W/4) ints. count: null, or the device's
// count of the records that are real (at most nrec; the rest pad a
// bucket).
static inline void scan_prologue(const int* recs, int nrec, int* ticket,
                                 int* owner, int* out, int C, int H, int W,
                                 cudaStream_t s,
                                 const int* count = nullptr) {
  const int cw = (W + 3) >> 2, ncell = ((H + 3) >> 2) * cw;
  scan_init_kernel<<<(ncell + 255) / 256, 256, 0, s>>>(ticket, owner, ncell);
  scan_owner_kernel<<<nrec, 128, 0, s>>>(recs, count, owner, cw, out, C, H,
                                         W);
}

// The samples one unit of work reads: see the note at the top.
struct ScanSamples {
  const int* in;        // this plane as it was before the scan
  const int* out;       // this plane, written by the scan's units
  const int* owner;     // [ceil(H/4), cw]
  int H, W, cw, t;
  __device__ __forceinline__ bool inside(int y, int x) const {
    return y >= 0 && y < H && x >= 0 && x < W;
  }
  __device__ __forceinline__ int writer(int y, int x) const {
    if (!inside(y, x)) return -1;
    const int o = __ldg(owner + (y >> 2) * cw + (x >> 2));
    return o < t ? o : -1;
  }
  __device__ __forceinline__ int peek(bool w, int y, int x) const {
    if (!inside(y, x)) return 0;
    return w ? ld_pixel(out + y * W + x) : __ldg(in + y * W + x);
  }
};

// SMs of the current device (cached after the first call, which a
// launch makes before any CUDA-graph capture of it)
static inline int sm_count() {
  static int sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 1;
  }
  return sms[dev];
}

}  // namespace thor
