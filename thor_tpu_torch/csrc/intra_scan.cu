// Intra reconstruction scan for the Thor decoder, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel thor_tpu/ops/pallas_intra.py:_intra_scan_kernel
// (public wrapper intra_scan_pallas). Same function: transform units (TUs)
// in decode order; per TU build the top / left / top-left context from
// already reconstructed pixels with the replication rule, predict with one
// of 10 modes (sizes 4..64), add the residual, clip to 0..255 and write
// back. The arithmetic follows ops/np_kernels.py make_top_and_left /
// intra_prediction, with the exact scan semantics of
// ops/jax_kernels.py:intra_scan (context reads outside the plane see 0,
// top[k] = row[tx + min(k, toplen - 1)], 128 at the frame's top / left
// edge, the cbx rule for the top-left sample).
//
// Design. The scan is strictly sequential, so one CUDA block walks the
// whole record list of one plane (gridDim.x = C: 1 for luma, 2 for U and
// V, which share TU geometry). Per TU: (1) threads k < 128 load the 2s+1
// context samples into shared memory; (2) they build the filtered context
// arrays the modes read (121 filters at s and 2s, the planar 5-tap
// filter) and warp 0 sums the DC context (both in intra_predict.cuh,
// shared with the encoder's scan); (3) all threads predict the
// s x s tile in parallel, add the residual, clip and store into the plane
// in global memory; (4) __syncthreads() before the next TU, which makes
// the stores visible to its context loads. The TPU kernel's tricks (a
// transposed plane copy for column reads, 0/1 permutation matmuls, aligned
// window rolls, placement matmuls for the blend) exist because the TPU
// has no cheap gathers or scalar addressing; here a thread simply indexes.
//
// Bound. The work is a few bytes per pixel of the intra TUs (a 1080p
// int32 luma plane is 8 MB and stays in the 50 MB L2), but the TUs form a
// chain: every TU pays three barriers and two dependent L2 round trips,
// so the time is (number of TUs) x (per-TU latency), not bytes over
// bandwidth, and one SM of 132 does the work. A wavefront over
// independent TUs, or several blocks cooperating through flags in global
// memory, is the later PR's work.

#include "intra_predict.cuh"

namespace {

using namespace thor;

constexpr int NF = 7;       // ty, tx, size, mode, toplen, leftlen, cbx
constexpr int NT = 256;     // threads per block

__global__ void __launch_bounds__(NT)
intra_scan_kernel(int* __restrict__ planes, const int* __restrict__ resid,
                  int H, int W, const int* __restrict__ recs, int nrec) {
  __shared__ Ctx c;
  const size_t HW = static_cast<size_t>(H) * W;
  int* P = planes + blockIdx.x * HW;
  const int* Rz = resid + blockIdx.x * HW;
  const int k = threadIdx.x;

  for (int t = 0; t < nrec; ++t) {
    const int* rc = recs + static_cast<size_t>(t) * NF;
    const int ty = rc[0], tx = rc[1], s = rc[2], mode = rc[3];
    const int toplen = rc[4], leftlen = rc[5], cbx = rc[6];

    // (1), (2) context samples, filtered context, top-left, DC value
    load_context(c, P, H, W, ty, tx, s, toplen, leftlen, cbx);

    // (3) predict, add residual, clip, store
    const int sh = __ffs(s) - 1;               // s is a power of two
    for (int p = k; p < s * s; p += NT) {
      const int i = p >> sh, j = p & (s - 1);
      const size_t o = static_cast<size_t>(ty + i) * W + tx + j;
      P[o] = clip255(predict(c, s, mode, i, j) + Rz[o]);
    }
    // (4) stores visible before the next TU reads its context
    __syncthreads();
  }
}

}  // namespace

// planes/resid: [C, H, W] int32 (planes updated in place); recs: [nrec, 7]
// int32 TU records in decode order, every TU inside the plane. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int thor_intra_scan(void* planes, const void* resid, int C, int H,
                               int W, const void* recs, int nrec,
                               void* stream) {
  if (nrec <= 0) return 0;
  intra_scan_kernel<<<C, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(planes), static_cast<const int*>(resid), H, W,
      static_cast<const int*>(recs), nrec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
