// Block motion compensation for the Thor decoder, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel thor_tpu/ops/pallas_mc.py:_mc_band_kernel
// (public wrapper mc_frame_pallas). Same function: for every prediction
// unit (PU), a T x T phase-weighted tap sum (T = 6 luma 1/4-pel, T = 4
// chroma 1/8-pel) over the codec-padded reference, (acc + 2048) >> 12,
// clip to 0..255, and for bipred PUs (p0 + p1) >> 1 of the two clipped
// predictions, written under the PU rectangle.
//
// Design. The TPU kernel banded the frame, DMA'd aligned windows into
// VMEM and rolled them so every tap slice had a static offset. None of
// that carries over. Here one CUDA block handles one record: a PU, or a
// TILE x TILE piece of a larger PU (the host splits PUs into tiles, so a
// 64x64 luma PU is 16 blocks). One thread computes one output pixel,
// reading its taps straight from the reference in global memory; the
// record's T*T weights sit in shared memory. U and V share one record set
// and one launch (blockIdx.y selects the plane).
//
// Bound. At 1080p the work is a few hundred million integer MACs and a
// few MB of reference and output traffic, so on paper the card could do
// it in microseconds either way. What bounds this simple version is
// latency and occupancy: neighbouring threads read neighbouring bytes, so
// tap loads coalesce and the window rows are reused through L1/L2, but
// small PUs leave most of a block's threads idle (an 8x8 luma PU uses 64
// of 256 threads, a 2x2 chroma PU 4 of 64). Staging the window in shared
// memory and packing several small PUs per block is later work.
//
// Every tap window must lie inside the padded plane; the host record
// builder (ops/mc.py:build_mc_records) clamps each MV cell's window
// origin into the plane where a PU's window would leave it, and gives a
// uni-predicted PU's list 1 the window of its list 0, so no load here
// leaves its reference plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// record fields (ops/mc.py)
constexpr int NF = 13;
enum { Y0, X0, RH, RW, S0, P0, IY0, IX0, BI, S1, P1, IY1, IX1 };

template <int T>
__device__ __forceinline__ int tap_sum(const uint8_t* __restrict__ src,
                                       int Wp, const int* w) {
  int acc = 2048;
#pragma unroll
  for (int m = 0; m < T; ++m) {
#pragma unroll
    for (int n = 0; n < T; ++n) {
      acc += w[m * T + n] * static_cast<int>(src[m * Wp + n]);
    }
  }
  int v = acc >> 12;  // arithmetic shift: floor, as in the reference
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

template <int T, int TILE>
__global__ void __launch_bounds__(TILE * TILE)
mc_kernel(const uint8_t* __restrict__ ref, int R, int Hp, int Wp,
          const int* __restrict__ recs, const int* __restrict__ lut,
          int* __restrict__ out, int H, int W) {
  __shared__ int rec[NF];
  __shared__ int w0[T * T];
  __shared__ int w1[T * T];
  const int k = blockIdx.x;
  const int c = blockIdx.y;
  const int t = threadIdx.x;
  if (t < NF) rec[t] = recs[static_cast<size_t>(k) * NF + t];
  __syncthreads();
  const int bi = rec[BI];
  if (t < T * T) {
    w0[t] = lut[rec[P0] * T * T + t];
    w1[t] = bi ? lut[rec[P1] * T * T + t] : 0;
  }
  __syncthreads();

  const int r = t / TILE;
  const int col = t % TILE;
  if (r >= rec[RH] || col >= rec[RW]) return;

  const size_t plane = static_cast<size_t>(Hp) * Wp;
  const uint8_t* base = ref + static_cast<size_t>(c) * R * plane;
  const uint8_t* s0 = base + rec[S0] * plane
                      + static_cast<size_t>(rec[IY0] + r) * Wp + rec[IX0] + col;
  int p = tap_sum<T>(s0, Wp, w0);
  if (bi) {
    const uint8_t* s1 = base + rec[S1] * plane
                        + static_cast<size_t>(rec[IY1] + r) * Wp + rec[IX1]
                        + col;
    p = (p + tap_sum<T>(s1, Wp, w1)) >> 1;
  }
  out[(static_cast<size_t>(c) * H + rec[Y0] + r) * W + rec[X0] + col] = p;
}

}  // namespace

// ref: [C, R, Hp, Wp] uint8; recs: [nrec, 13] int32 (PU pieces of at most
// TILE x TILE, TILE = 16 for T = 6 and 8 for T = 4); lut: [P, T*T] int32;
// out: [C, H, W] int32. Launches on `stream`; returns cudaGetLastError().
extern "C" int thor_mc_frame(const void* ref, int C, int R, int Hp, int Wp,
                             const void* recs, int nrec, const void* lut,
                             int T, void* out, int H, int W, void* stream) {
  if (nrec <= 0) return 0;
  dim3 grid(nrec, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* rp = static_cast<const uint8_t*>(ref);
  const int* rc = static_cast<const int*>(recs);
  const int* lp = static_cast<const int*>(lut);
  int* op = static_cast<int*>(out);
  if (T == 6) {
    mc_kernel<6, 16><<<grid, 16 * 16, 0, s>>>(rp, R, Hp, Wp, rc, lp, op, H, W);
  } else if (T == 4) {
    mc_kernel<4, 8><<<grid, 8 * 8, 0, s>>>(rp, R, Hp, Wp, rc, lp, op, H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
