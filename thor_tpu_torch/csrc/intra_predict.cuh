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

__device__ __forceinline__ int c127(int v) {
  return v < 0 ? 0 : (v > 127 ? 127 : v);
}

__device__ __forceinline__ int clip255(int v) {
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// The context of one TU. Every value fits in 16 bits (samples and
// filtered samples 0..255, planar sums up to 8 * 255): the decoder's scan
// keeps it in 32-bit words (Ctx), the encoder's, which holds more per warp,
// in 16-bit ones (Ctx16).
template <class V>
struct CtxOf {
  V top[128], left[128];
  V topF[128], leftF[128];       // 121 filter, replication at s
  V topF2[128], leftF2[128];     // 121 filter, replication at 2s
  V topP[64], leftP[64];         // planar 5-tap filter
  V tl, dc;                      // top-left sample, DC value
};
using Ctx = CtxOf<int>;
using Ctx16 = CtxOf<short>;

// Second half of a TU's context: from the complete top / left samples, the
// filtered arrays that predict() reads for `mode` and the DC value, no
// entry beyond 2s - 1, the highest any mode reads. One warp calls it, with
// the samples visible to all its lanes; it ends in a warp barrier, after
// which the context is complete for every lane.
template <class Cx>
__device__ __forceinline__ void filter_context(Cx& c, int lane, int ty,
                                               int tx, int s, int mode) {
  const bool f1 = mode == 4 || mode == 7 || mode == 8;
  const bool f2t = mode == 5 || mode == 6, f2l = mode == 9;
  const bool planar = mode == 1;
  const int kmax = min(128, 2 * s);
  for (int k = lane; k < kmax; k += 32) {
    const int km = max(k - 1, 0);
    const int n1 = min(k + 1, s - 1), n2 = min(k + 1, 2 * s - 1);
    if (f1) {
      c.topF[k] = (c.top[km] + 2 * c.top[k] + c.top[n1] + 2) >> 2;
      c.leftF[k] = (c.left[km] + 2 * c.left[k] + c.left[n1] + 2) >> 2;
    }
    if (f2t) c.topF2[k] = (c.top[km] + 2 * c.top[k] + c.top[n2] + 2) >> 2;
    if (f2l) c.leftF2[k] = (c.left[km] + 2 * c.left[k] + c.left[n2] + 2) >> 2;
    if (planar && k < s) {
      const int a = max(k - 2, 0), b = max(k - 1, 0);
      const int d = min(k + 1, s - 1), e = min(k + 2, s - 1);
      c.topP[k] = c.top[a] + 2 * c.top[b] + 2 * c.top[k] + 2 * c.top[d]
                  + c.top[e];
      c.leftP[k] = c.left[a] + 2 * c.left[b] + 2 * c.left[k]
                   + 2 * c.left[d] + c.left[e];
    }
  }
  if (mode == 0 || mode >= 10) {
    const auto* lv = tx != 0 ? c.left : c.top;
    const auto* tv = ty != 0 ? c.top : c.left;
    int sum = 0;
    for (int q = lane; q < s; q += 32) sum += lv[q] + tv[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_down_sync(0xffffffffu, sum, off);
    if (lane == 0) c.dc = (sum + s) / (2 * s);
  }
  __syncwarp();
}

// A sample that an earlier TU of the same launch has yet to write reads
// PENDING; no reconstructed pixel does (they are clipped to 0..255).
constexpr int PENDING = static_cast<int>(0x80000000u);

// The same context built by one warp, for one mode, in a scan whose TUs
// run side by side on the card. `at` knows the planes: at.writer(y, x) is
// the rank, in the scan's order, of the earlier TU of this launch that
// writes the 4x4 cell of sample (y, x), or -1 (no such TU, or outside the
// plane); at.peek(w, y, x) loads the sample once (0 outside the plane) and
// gives PENDING where w is set and that TU has not stored it yet. ty and
// tx are multiples of 4, so four context samples in a row lie in one cell:
// a lane takes a cell, asks once who writes it, has its four loads in
// flight together and repeats those that came back PENDING. The warp first
// lets only the lane with the latest writer poll, and the others after
// it, when most of them find their samples there: a waiting warp then
// costs L2 one load at a time, not one per lane. Only the samples that
// differ are fetched (toplen above, leftlen to the left, the top-left one
// under the cbx rule); the replication beyond them is done in shared
// memory, as far as the modes read (2s entries). All 32 lanes call it; it
// returns with the context complete and visible to the warp.
template <class Samples, class Cx>
__device__ __forceinline__ void load_context_warp(Cx& c, const Samples& at,
                                                  int lane, int ty, int tx,
                                                  int s, int mode, int toplen,
                                                  int leftlen, int cbx) {
  const int nt = ty > 0 ? min(toplen, 128) : 0;
  const int nl = tx > 0 ? min(leftlen, 128) : 0;
  const int ct = (nt + 3) >> 2, cl = (nl + 3) >> 2;
  const bool corner = ty > 0 && cbx;
  // (1) context samples
  for (int i0 = 0; i0 < ct + cl + corner; i0 += 32) {
    const int i = i0 + lane;
    const bool top = i < ct, left = !top && i < ct + cl;
    const int m = top ? i : i - ct;
    const int y0 = top ? ty - 1 : (left ? ty + 4 * m : ty - 1);
    const int x0 = top ? tx + 4 * m : tx - 1;
    const int dy = left ? 1 : 0, dx = top ? 1 : 0;
    const int cnt = top ? min(4, nt - 4 * m)
                        : (left ? min(4, nl - 4 * m)
                                : (i < ct + cl + corner ? 1 : 0));
    const int o = cnt > 0 ? at.writer(y0, x0) : -1;
    const bool w = o >= 0;
    const int latest = __reduce_max_sync(0xffffffffu, o);
    unsigned spins = 0;
    if (w && o == latest) {
      while (at.peek(true, y0, x0) == PENDING) {
        if (++spins > (1u << 24)) __trap();   // the TU that writes it is lost
      }
    }
    __syncwarp();
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v[u] = u < cnt ? at.peek(w, y0 + u * dy, x0 + u * dx) : 0;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      while (v[u] == PENDING) {
        if (++spins > (1u << 24)) __trap();
        v[u] = at.peek(w, y0 + u * dy, x0 + u * dx);
      }
      if (u < cnt) {
        if (top) {
          c.top[4 * m + u] = v[u];
        } else if (left) {
          c.left[4 * m + u] = v[u];
        } else {
          c.tl = v[u];
        }
      }
    }
  }
  __syncwarp();
  const int kmax = min(128, 2 * s);
  for (int k = lane; k < kmax; k += 32) {
    if (k >= nt) c.top[k] = ty == 0 ? 128 : c.top[nt - 1];
    if (k >= nl) c.left[k] = tx == 0 ? 128 : c.left[nl - 1];
  }
  __syncwarp();
  // (2) top-left sample, filtered context, DC value
  if (lane == 0 && !corner) c.tl = ty == 0 ? c.left[0] : c.top[0];
  filter_context(c, lane, ty, tx, s, mode);
}

// Prediction of pixel (i, j) of an s x s TU from a complete context.
template <class Cx>
__device__ __forceinline__ int predict(const Cx& c, int s, int mode, int i,
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
