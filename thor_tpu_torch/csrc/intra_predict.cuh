// Intra prediction context and the 10 prediction modes, shared by the
// decoder's intra scan (intra_scan.cu) and the encoder's (enc_intra_scan.cu).
//
// The arithmetic follows ops/np_kernels.py make_top_and_left /
// intra_prediction of the JAX package, with the scan semantics of
// ops/jax_kernels.py:intra_scan: context reads outside the plane see 0,
// top[k] = row[tx + min(k, toplen - 1)], 128 at the frame's top / left
// edge, the cbx rule for the top-left sample, planar's truncating division.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace thor {

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
  int tl, dc;                    // top-left sample, DC value
};

// Builds the context of one TU in shared memory from the plane P. Every
// thread of the block calls it (blockDim.x >= 128); it holds two barriers
// and returns with the context complete and visible to all threads.
__device__ __forceinline__ void load_context(Ctx& c, const int* P, int H,
                                             int W, int ty, int tx, int s,
                                             int toplen, int leftlen,
                                             int cbx) {
  const int k = threadIdx.x;
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
    c.tl = ty == 0 ? c.left[0]
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
    if (k == 0) c.dc = (sum + s) / (2 * s);
  }
  __syncthreads();
}

// Prediction of pixel (i, j) of an s x s TU from a complete context.
__device__ __forceinline__ int predict(const Ctx& c, int s, int mode, int i,
                                       int j) {
  const int tl = c.tl;
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
      return c.dc;
  }
}

}  // namespace thor
