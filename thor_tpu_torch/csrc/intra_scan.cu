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
// filter) and warp 0 sums the DC context; (3) all threads predict the
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NF = 7;       // ty, tx, size, mode, toplen, leftlen, cbx
constexpr int NT = 256;     // threads per block

__device__ __forceinline__ int ld(const int* P, int H, int W, int y, int x) {
  return (y >= 0 && y < H && x >= 0 && x < W) ? P[y * W + x] : 0;
}

__device__ __forceinline__ int c127(int v) {
  return v < 0 ? 0 : (v > 127 ? 127 : v);
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

struct Ctx {
  int top[128], left[128];
  int topF[128], leftF[128];     // 121 filter, replication at s
  int topF2[128], leftF2[128];   // 121 filter, replication at 2s
  int topP[64], leftP[64];       // planar 5-tap filter
};

__device__ int predict(const Ctx& c, int tl, int dc, int s, int mode,
                       int i, int j) {
  switch (mode) {
    case 1: {                                   // PLANAR
      int tlF = c.left[1] + 2 * c.left[0] + 2 * tl + 2 * c.top[0] + c.top[1];
      int v = c.leftP[i] + c.topP[j] - tlF + 4;
      return clip255(v / 8);                    // C division truncates
    }
    case 2: return c.left[i];                   // HOR
    case 3: return c.top[j];                    // VER
    case 4: {                                   // UPLEFT
      int tlF = (2 * tl + c.left[0] + c.top[0] + 2) >> 2;
      int diag = i - j;
      int ad = c127((diag < 0 ? -diag : diag) - 1);
      return diag > 0 ? c.leftF[ad] : (diag == 0 ? tlF : c.topF[ad]);
    }
    case 5:                                     // UPRIGHT
      return c.topF2[c127(i + j + 1)];
    case 6: {                                   // UPUPRIGHT
      int diag = i + 2 * j;
      if (diag & 1) return c.topF2[c127((diag + 1) >> 1)];
      return (c.topF2[c127(diag >> 1)] + c.topF2[c127((diag >> 1) + 1)]) >> 1;
    }
    case 7: {                                   // UPUPLEFT
      int tlF = (2 * tl + c.left[0] + c.top[0] + 2) >> 2;
      int diag = i - 2 * j;
      if (diag > 1) return c.leftF[c127(diag - 2)];
      if (diag == 1) return tlF;
      if (diag == 0) return (tlF + c.topF[0]) >> 1;
      int nd = -diag;
      int hi = min(nd >> 1, s - 1);
      if (nd & 1) return c.topF[hi];
      return (c.topF[hi] + c.topF[max((nd >> 1) - 1, 0)]) >> 1;
    }
    case 8: {                                   // UPLEFTLEFT
      int tlF = (2 * tl + c.left[0] + c.top[0] + 2) >> 2;
      int diag = 2 * i - j;
      if (diag < -1) return c.topF[c127(-diag - 2)];
      if (diag == -1) return tlF;
      if (diag == 0) return (tlF + c.leftF[0]) >> 1;
      int hi = min(diag >> 1, s - 1);
      if (diag & 1) return c.leftF[hi];
      return (c.leftF[hi] + c.leftF[max((diag >> 1) - 1, 0)]) >> 1;
    }
    case 9: {                                   // DOWNLEFTLEFT
      int diag = 2 * i + j;
      if (diag & 1) return c.leftF2[c127((diag + 1) >> 1)];
      return (c.leftF2[c127(diag >> 1)]
              + c.leftF2[min(c127((diag >> 1) + 1), 2 * s - 1)]) >> 1;
    }
    default:                                    // DC (0, and >= 10)
      return dc;
  }
}

__global__ void __launch_bounds__(NT)
intra_scan_kernel(int* __restrict__ planes, const int* __restrict__ resid,
                  int H, int W, const int* __restrict__ recs, int nrec) {
  __shared__ Ctx c;
  __shared__ int s_tl, s_dc;
  const size_t HW = static_cast<size_t>(H) * W;
  int* P = planes + blockIdx.x * HW;
  const int* Rz = resid + blockIdx.x * HW;
  const int k = threadIdx.x;

  for (int t = 0; t < nrec; ++t) {
    const int* rc = recs + static_cast<size_t>(t) * NF;
    const int ty = rc[0], tx = rc[1], s = rc[2], mode = rc[3];
    const int toplen = rc[4], leftlen = rc[5], cbx = rc[6];

    // (1) context samples
    if (k < 128) {
      c.top[k] = ty == 0 ? 128 : ld(P, H, W, ty - 1, tx + min(k, toplen - 1));
      c.left[k] = tx == 0 ? 128 : ld(P, H, W, ty + min(k, leftlen - 1), tx - 1);
    }
    __syncthreads();

    // (2) filtered context, top-left sample, DC value
    if (k < 128) {
      const int km = max(k - 1, 0);
      const int n1 = min(k + 1, s - 1), n2 = min(k + 1, 2 * s - 1);
      c.topF[k] = (c.top[km] + 2 * c.top[k] + c.top[n1] + 2) >> 2;
      c.leftF[k] = (c.left[km] + 2 * c.left[k] + c.left[n1] + 2) >> 2;
      c.topF2[k] = (c.top[km] + 2 * c.top[k] + c.top[n2] + 2) >> 2;
      c.leftF2[k] = (c.left[km] + 2 * c.left[k] + c.left[n2] + 2) >> 2;
      if (k < s) {
        const int a = max(k - 2, 0), b = max(k - 1, 0);
        const int d = min(k + 1, s - 1), e = min(k + 2, s - 1);
        c.topP[k] = c.top[a] + 2 * c.top[b] + 2 * c.top[k] + 2 * c.top[d]
                    + c.top[e];
        c.leftP[k] = c.left[a] + 2 * c.left[b] + 2 * c.left[k]
                     + 2 * c.left[d] + c.left[e];
      }
    }
    if (k == 0) {
      s_tl = ty == 0 ? c.left[0]
                     : (cbx ? ld(P, H, W, ty - 1, tx - 1) : c.top[0]);
    }
    if (k < 32) {
      const int* lv = tx != 0 ? c.left : c.top;
      const int* tv = ty != 0 ? c.top : c.left;
      int sum = 0;
      for (int q = k; q < s; q += 32) sum += lv[q] + tv[q];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_down_sync(0xffffffffu, sum, off);
      if (k == 0) s_dc = (sum + s) / (2 * s);
    }
    __syncthreads();

    // (3) predict, add residual, clip, store
    const int tl = s_tl, dc = s_dc;
    const int sh = __ffs(s) - 1;               // s is a power of two
    for (int p = k; p < s * s; p += NT) {
      const int i = p >> sh, j = p & (s - 1);
      const size_t o = static_cast<size_t>(ty + i) * W + tx + j;
      P[o] = clip255(predict(c, tl, dc, s, mode, i, j) + Rz[o]);
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
