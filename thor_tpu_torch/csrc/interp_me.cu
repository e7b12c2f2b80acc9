// One pyramid level of the bidirectional block motion estimation behind
// Thor's temporally interpolated reference frame, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel thor_tpu/ops/pallas_interp.py:_me_level_kernel
// (wrapper me_level_pallas). Same function (motion_estimate_bi and the
// merge pass, common/temporal_interp.c:852-918): the 16x16 blocks of the
// level are decided in raster order. A block takes the medoid of its
// decided neighbours (up-right, left, up) as skip vector and keeps it if
// the four 8x8 sub-SADs of the window pair it names are small and the
// windows lie inside the padded planes. Otherwise it searches: up to five
// candidates (zero, the coarser level's guide, up-right, left, up, without
// repeats), each refined by an adaptive cross search, cost = bi-SAD + a
// rate term against the neighbours' vectors; a candidate is refined only
// if its base cost passes a pruning gate against the best so far. Then the
// merge pass lets every 8x8 cell take the vector of a cell one or two away
// (up, down, left, right) where that lowers its own 8x8 bi-SAD. Every
// window pixel coordinate is clipped on its own to the padded plane.
//
// Design. Block (r, c) needs the decisions of (r-1, c+1) and (r, c-1): the
// walk is a true chain, so one thread block walks it, and what can run
// side by side inside one step does: a warp owns one 16x16 SAD evaluation
// (8 pixels a lane, the lanes along x so that a load touches two rows of
// the plane, reduced by shuffles, no barrier). Warp 0 makes the
// skip test while warps 1..5 take the candidates' base costs. A candidate's
// refinement does not depend on the other candidates; only whether it is
// used does (the gate compares with the best cost so far). So all
// candidates are refined at once, ahead of the gate: warp 4k+d evaluates
// cross point d of candidate k, one barrier per refinement step, and the
// gate is applied afterwards, in candidate order, exactly as the serial
// search applies it. A block costs two barriers plus one per refinement
// step. Each thread keeps the scalar state itself, so nothing is broadcast.
// The maps live in global memory (a block's 2x2 cells are written before
// the barrier that ends its step). The merge pass reads only the finished
// pre-merge map, so it is a second kernel: one warp per 8x8 cell, all
// cells in parallel. Nothing of the TPU kernel's aligned fetches, rolls,
// one-hot resampling products or row read-modify-writes is carried over.
//
// Bound. Bytes and operations are both tiny against the card (1080p
// level 0: 5.4 MB of planes, about 10^8 integer operations: microseconds).
// What bounds this kernel is the serial chain: 8 160 blocks at 1080p
// level 0, each a few dependent rounds of L2-latency loads, shuffles and
// barriers on one SM. A wavefront over block rows (row r two blocks behind
// row r-1) would cut the chain from BH*BW steps to BW + 2*BH.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COST_MAX = 0x3FFFFFFF;
constexpr int LAMBDA = 3000;
constexpr int LAMBDA_SHIFT = 4;
constexpr int SKIP_THRESHOLD = 8;
constexpr int ACC_BITS = 3;
constexpr int ACC_ROUND = 1 << (ACC_BITS - 1);
constexpr int MAX_K = 5;                 // candidate slots
constexpr int WALK_WARPS = 4 * MAX_K;    // one per (candidate, cross point)
constexpr int WALK_THREADS = 32 * WALK_WARPS;
constexpr int MERGE_WARPS = 8;
constexpr unsigned FULL = 0xffffffffu;

struct Level {
  const uint8_t* p0;   // [h + 2 pad, w + 2 pad]
  const uint8_t* p1;
  int w, h, pad, stride;
  int bw, bh;          // grid of 8x8 cells (whole 16x16 blocks)
  int wt0, wt1;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ int iabs(int v) { return v < 0 ? -v : v; }

// round half away from zero; denom > 0
__device__ __forceinline__ int scale_val(int v, int numer, int denom) {
  const int prod = v * numer;
  const int mag = (iabs(prod) + denom / 2) / denom;
  return prod >= 0 ? mag : -mag;
}

// whole-pel offset of a 1/8-pel vector component (arithmetic shift)
__device__ __forceinline__ int rs(int v) { return (v + ACC_ROUND) >> ACC_BITS; }

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// This lane's share of the SAD between the window of p0 at (xs0, ys0) and
// the window of p1 at (xs1, ys1), N pixels of row `row` from column `col`,
// each coordinate clipped to [-pad, dim + pad - 1].
template <int N>
__device__ __forceinline__ int lane_sad(const Level& L, int xs0, int ys0,
                                        int xs1, int ys1, int row, int col) {
  const int hi_y = L.h + L.pad - 1, hi_x = L.w + L.pad - 1;
  const uint8_t* r0 = L.p0 +
      static_cast<size_t>(clampi(ys0 + row, -L.pad, hi_y) + L.pad) * L.stride +
      L.pad;
  const uint8_t* r1 = L.p1 +
      static_cast<size_t>(clampi(ys1 + row, -L.pad, hi_y) + L.pad) * L.stride +
      L.pad;
  int s = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int a = r0[clampi(xs0 + col + i, -L.pad, hi_x)];
    const int b = r1[clampi(xs1 + col + i, -L.pad, hi_x)];
    s += iabs(a - b);
  }
  return s;
}

// cross point d of a refinement step: left, right, up, down
__device__ __forceinline__ int cross_dx(int d) { return d == 0 ? -1 : (d == 1 ? 1 : 0); }
__device__ __forceinline__ int cross_dy(int d) { return d == 2 ? -1 : (d == 3 ? 1 : 0); }

// an 8-wide window at s lies inside [-pad, lim)
__device__ __forceinline__ bool span_in(int s, int pad, int lim) {
  return s >= -pad && s + 8 <= lim;
}

struct Neigh {
  int ux, uy, rx, ry, lx, ly, dx, dy;   // up, up-right, left, up-left
  bool in4, row0, col0;
};

template <int LAM>
__device__ __forceinline__ int mv_cost(const Neigh& n, int mx, int my) {
  const int d_r = iabs(mx - n.rx) + iabs(my - n.ry);
  const int d_u = iabs(mx - n.ux) + iabs(my - n.uy);
  const int d_l = iabs(mx - n.lx) + iabs(my - n.ly);
  const int d_d = iabs(mx - n.dx) + iabs(my - n.dy);
  const int diff = n.in4 ? d_r + d_u + d_d + d_l
                         : (n.row0 ? d_l : (n.col0 ? d_r + d_u : 0));
  return (diff * LAM) >> (LAMBDA_SHIFT + ACC_BITS);
}

// This lane's share of a 16x16 SAD between the window of p0 at (xs0, ys0)
// and the window of p1 at (xs1, ys1), split into the upper and the lower
// eight rows. The lanes lie along x: lane l takes column l & 15 of rows
// (l >> 4) + 2i, so one load of the warp touches two rows of the plane and
// not sixteen. Each coordinate is clipped to [-pad, dim + pad - 1].
__device__ __forceinline__ void lane_sad16(const Level& L, int xs0, int ys0,
                                           int xs1, int ys1, int lane,
                                           int& top, int& bot) {
  const int hi_y = L.h + L.pad - 1, hi_x = L.w + L.pad - 1;
  const int col = lane & 15, row0 = lane >> 4;
  const uint8_t* c0 = L.p0 + clampi(xs0 + col, -L.pad, hi_x) + L.pad;
  const uint8_t* c1 = L.p1 + clampi(xs1 + col, -L.pad, hi_x) + L.pad;
  unsigned s[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + 2 * i;
    const int a = c0[static_cast<size_t>(clampi(ys0 + row, -L.pad, hi_y) +
                                         L.pad) * L.stride];
    const int b = c1[static_cast<size_t>(clampi(ys1 + row, -L.pad, hi_y) +
                                         L.pad) * L.stride];
    s[i >> 2] = __sad(a, b, s[i >> 2]);
  }
  top = static_cast<int>(s[0]);
  bot = static_cast<int>(s[1]);
}

// Rate + 16x16 bi-SAD of vector (mx, my) for the block at (xstart,
// ystart), computed by one warp; every lane returns the cost.
template <int LAM>
__device__ __forceinline__ int full_cost(const Level& L, const Neigh& n,
                                         int xstart, int ystart, int mx,
                                         int my, int lane) {
  const int a0x = scale_val(mx, -L.wt1, L.wt0);
  const int a0y = scale_val(my, -L.wt1, L.wt0);
  int top, bot;
  lane_sad16(L, xstart + rs(a0x), ystart + rs(a0y), xstart + rs(mx),
             ystart + rs(my), lane, top, bot);
  return mv_cost<LAM>(n, mx, my) + warp_sum(top + bot);
}

// The raster walk over the 16x16 blocks. pre: [5, bh, bw] int32, zeroed by
// the caller: mv0x, mv0y, mv1x, mv1y, bg before the merge pass.
template <bool GUIDED>
__global__ void __launch_bounds__(WALK_THREADS, 1)
me_walk_kernel(Level L, const int* __restrict__ gx, const int* __restrict__ gy,
               int* pre, unsigned long long* stats) {
  constexpr int K = GUIDED ? 5 : 4;
  constexpr int N_ITERS = GUIDED ? 2 : 16;
  constexpr int SHIFT0 = GUIDED ? ACC_BITS : 3 + ACC_BITS;
  constexpr int LAM = GUIDED ? LAMBDA / 4 : LAMBDA;
  constexpr int THR = SKIP_THRESHOLD * 8 * 8;

  __shared__ int s_base[MAX_K + 1];        // base costs; [MAX_K]: skip flag
  __shared__ int s_res[2][WALK_WARPS];     // cross-point costs, by parity

  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int bw = L.bw, bh = L.bh, BW = bw / 2, BH = bh / 2;
  const int ncell = bw * bh;
  int* m0x = pre;
  int* m0y = pre + ncell;
  int* m1x = pre + 2 * ncell;
  int* m1y = pre + 3 * ncell;
  int* bgm = pre + 4 * ncell;
  const int hP = L.h + L.pad, wP = L.w + L.pad;
  unsigned long long evals = 0;

  for (int t = 0; t < BH * BW; ++t) {
    const int yp = (t / BW) * 2, xp = (t % BW) * 2;
    const int xstart = xp * 8, ystart = yp * 8;
    const bool up_ok = yp > 0;
    const bool upr_ok = up_ok && xp < bw - 2;
    const bool left_ok = xp > 0;

    // decided mv1 of the neighbours; the cell index is clamped (an
    // undecided cell reads as zero) and every use is masked by validity
    Neigh n;
    {
      const int yu = clampi(yp - 2, 0, bh - 1) * bw;
      const int xr = clampi(xp + 2, 0, bw - 1), xl = clampi(xp - 2, 0, bw - 1);
      n.ux = m1x[yu + xp];
      n.uy = m1y[yu + xp];
      n.rx = m1x[yu + xr];
      n.ry = m1y[yu + xr];
      n.lx = m1x[yp * bw + xl];
      n.ly = m1y[yp * bw + xl];
      n.dx = m1x[yu + xl];
      n.dy = m1y[yu + xl];
    }
    n.in4 = up_ok && left_ok && xp < bw - 2;
    n.row0 = yp == 0 && left_ok;
    n.col0 = xp == 0 && up_ok;

    // skip vector: medoid of the valid neighbours in the order up-right,
    // left, up; ties keep the last <=
    int skx = 0, sky = 0;
    {
      const int cxs[3] = {n.rx, n.lx, n.ux}, cys[3] = {n.ry, n.ly, n.uy};
      const bool cvs[3] = {upr_ok, left_ok, up_ok};
      int best_c = COST_MAX;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        int d = 0;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          d += cvs[i] ? iabs(cxs[j] - cxs[i]) + iabs(cys[j] - cys[i]) : 0;
        }
        if (cvs[j] && d <= best_c) {
          best_c = d;
          skx = cxs[j];
          sky = cys[j];
        }
      }
    }
    const int ssx = scale_val(skx, -L.wt1, L.wt0);
    const int ssy = scale_val(sky, -L.wt1, L.wt0);

    // candidates: zero, guide (guided levels), up-right, left, up; a slot
    // equal to an earlier valid slot is dropped
    int cx[K], cy[K];
    bool cv[K];
    {
      int k = 0;
      cx[k] = 0, cy[k] = 0, cv[k] = true, ++k;
      if (GUIDED) {
        cx[k] = gx[yp * bw + xp], cy[k] = gy[yp * bw + xp], cv[k] = true, ++k;
      }
      cx[k] = n.rx, cy[k] = n.ry, cv[k] = upr_ok, ++k;
      cx[k] = n.lx, cy[k] = n.ly, cv[k] = left_ok, ++k;
      cx[k] = n.ux, cy[k] = n.uy, cv[k] = up_ok;
#pragma unroll
      for (int j = 1; j < K; ++j) {
        bool dup = false;
#pragma unroll
        for (int i = 0; i < j; ++i) {
          dup = dup || (cx[j] == cx[i] && cy[j] == cy[i] && cv[i]);
        }
        cv[j] = cv[j] && !dup;
      }
    }

    // step 1: warp 0 makes the skip test, warp k+1 takes candidate k's
    // base cost
    if (wid == 0) {
      const int xs0 = xstart + rs(ssx), ys0 = ystart + rs(ssy);
      const int xs1 = xstart + rs(skx), ys1 = ystart + rs(sky);
      // a lane's column half is lane bit 3; xor over the other lane bits
      // sums the left and right 8x8 quadrants of the upper and lower rows
      int top, bot;
      lane_sad16(L, xs0, ys0, xs1, ys1, lane, top, bot);
#pragma unroll
      for (int o = 1; o <= 16; o <<= 1) {
        if (o == 8) continue;
        top += __shfl_xor_sync(FULL, top, o);
        bot += __shfl_xor_sync(FULL, bot, o);
      }
      bool sk = true;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int dy = (q >> 1) * 8, dx = (q & 1) * 8;
        const int s8 = __shfl_sync(FULL, (q >> 1) ? bot : top, (q & 1) * 8);
        sk = sk && s8 <= THR && span_in(xs0 + dx, L.pad, wP) &&
             span_in(ys0 + dy, L.pad, hP) && span_in(xs1 + dx, L.pad, wP) &&
             span_in(ys1 + dy, L.pad, hP);
      }
      if (lane == 0) s_base[MAX_K] = sk;
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (wid == k + 1 && cv[k]) {
          const int c = full_cost<LAM>(L, n, xstart, ystart, cx[k], cy[k], lane);
          if (lane == 0) s_base[k] = c;
        }
      }
    }
    __syncthreads();
    const bool sk = s_base[MAX_K] != 0;
    evals += 1;

    int best_x = skx, best_y = sky;
    if (!sk) {
      // step 2: refine every valid candidate at once, ahead of the gate
      int cost0[K], cost[K], rx[K], ry[K], shift[K], iters[K];
      bool active[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        cost0[k] = cv[k] ? s_base[k] : COST_MAX;
        cost[k] = cost0[k];
        rx[k] = cx[k];
        ry[k] = cy[k];
        shift[k] = SHIFT0;
        iters[k] = 0;
        active[k] = cv[k];
      }
      for (int it = 0; it < N_ITERS; ++it) {
        bool any = false;
#pragma unroll
        for (int k = 0; k < K; ++k) any = any || active[k];
        if (!any) break;                 // the same in every thread
        int* res = s_res[it & 1];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if ((wid >> 2) == k && active[k]) {
            const int off = 1 << (shift[k] > 0 ? shift[k] : 0);
            const int d = wid & 3;
            const int c = full_cost<LAM>(L, n, xstart, ystart,
                                         rx[k] + cross_dx(d) * off,
                                         ry[k] + cross_dy(d) * off, lane);
            if (lane == 0) res[wid] = c;
          }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!active[k]) continue;
          // the four cross points are built from the step's start vector
          const int off = 1 << (shift[k] > 0 ? shift[k] : 0);
          const int rx0 = rx[k], ry0 = ry[k];
          bool better = false;
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const int bc = res[4 * k + d];
            if (bc < cost[k]) {
              cost[k] = bc;
              rx[k] = rx0 + cross_dx(d) * off;
              ry[k] = ry0 + cross_dy(d) * off;
              better = true;
            }
          }
          if (!better) --shift[k];
          active[k] = shift[k] >= ACC_BITS;
          ++iters[k];
        }
      }
      // the gate and the choice, in candidate order; the multiplier
      // counts valid candidates, not slots
      int best_cost = COST_MAX, c_eff = 0;
      best_x = cx[0];
      best_y = cy[0];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!cv[k]) continue;
        const bool gate = ((4 + c_eff) * cost0[k]) / 8 < best_cost;
        ++c_eff;
        const int ck = gate ? cost[k] : cost0[k];
        if (ck < best_cost) {
          best_cost = ck;
          best_x = gate ? rx[k] : cx[k];
          best_y = gate ? ry[k] : cy[k];
        }
        evals += 1 + (gate ? 4 * iters[k] : 0);
      }
    }

    // on a skip block mv1 is the skip vector and mv0 its scaled twin
    if (threadIdx.x < 4) {
      const int cell = (yp + (threadIdx.x >> 1)) * bw + xp + (threadIdx.x & 1);
      m1x[cell] = best_x;
      m1y[cell] = best_y;
      m0x[cell] = sk ? ssx : scale_val(best_x, -L.wt1, L.wt0);
      m0y[cell] = sk ? ssy : scale_val(best_y, -L.wt1, L.wt0);
      bgm[cell] = sk ? 1 : 0;
    }
    __syncthreads();    // the next block reads these cells
  }
  if (stats != nullptr && threadIdx.x == 0) atomicAdd(stats, evals);
}

// The merge pass: one warp per 8x8 cell. pre: the walk's maps; out: the
// final [5, bh, bw] maps.
__global__ void __launch_bounds__(32 * MERGE_WARPS)
me_merge_kernel(Level L, const int* __restrict__ pre, int* __restrict__ out,
                unsigned long long* stats) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * MERGE_WARPS + (threadIdx.x >> 5);
  const int bw = L.bw, bh = L.bh, ncell = bw * bh;
  if (cell >= ncell) return;
  const int* m1x = pre + 2 * ncell;
  const int* m1y = pre + 3 * ncell;
  const int ii = cell / bw, jj = cell % bw;
  const int off = (ii & 1) ? 2 : 1;      // keyed on the row, for both axes

  // candidates: the cell itself, then up, down, left, right at `off`
  const int ys[5] = {ii, ii - off, ii + off, ii, ii};
  const int xs[5] = {jj, jj, jj, jj - off, jj + off};
  int cx[5], cy[5];
  bool ok[5];
  int nvalid = 0;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int at = clampi(ys[j], 0, bh - 1) * bw + clampi(xs[j], 0, bw - 1);
    cx[j] = m1x[at];
    cy[j] = m1y[at];
    bool v = ys[j] >= 0 && ys[j] < bh && xs[j] >= 0 && xs[j] < bw;
#pragma unroll
    for (int i = 0; i < j; ++i) {
      v = v && !(cx[j] == cx[i] && cy[j] == cy[i] && ok[i]);
    }
    ok[j] = v;
    nvalid += v;
  }

  int o1x = cx[0], o1y = cy[0];
  int o0x = pre[cell], o0y = pre[ncell + cell];
  if (nvalid > 1) {
    int bcost = COST_MAX, bx = 0, by = 0;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      if (!ok[c]) continue;
      const int a0x = scale_val(cx[c], -L.wt1, L.wt0);
      const int a0y = scale_val(cy[c], -L.wt1, L.wt0);
      const int s = warp_sum(lane_sad<2>(
          L, jj * 8 + rs(a0x), ii * 8 + rs(a0y), jj * 8 + rs(cx[c]),
          ii * 8 + rs(cy[c]), lane >> 2, (lane & 3) * 2));
      if (s < bcost) {
        bcost = s;
        bx = cx[c];
        by = cy[c];
      }
    }
    o1x = bx;
    o1y = by;
    o0x = scale_val(bx, -L.wt1, L.wt0);
    o0y = scale_val(by, -L.wt1, L.wt0);
    if (stats != nullptr && lane == 0) {
      atomicAdd(stats + 1, static_cast<unsigned long long>(nvalid));
    }
  }
  if (lane == 0) {
    out[cell] = o0x;
    out[ncell + cell] = o0y;
    out[2 * ncell + cell] = o1x;
    out[3 * ncell + cell] = o1y;
    out[4 * ncell + cell] = pre[4 * ncell + cell];
  }
}

}  // namespace

// pic0, pic1: [h + 2 pad, w + 2 pad] uint8; gx, gy: [bh, bw] int32 guide
// (read only if guided); pre: [5, bh, bw] int32 scratch, zeroed by the
// caller; out: [5, bh, bw] int32 (mv0x, mv0y, mv1x, mv1y, bg); stats: null
// or two 64-bit counters to which the 16x16 and the 8x8 SAD evaluations
// the level needed are added. Launches both kernels on `stream`; returns
// cudaGetLastError().
extern "C" int thor_interp_me_level(const void* pic0, const void* pic1, int w,
                                    int h, int pad, int wt0, int wt1,
                                    int guided, const void* gx, const void* gy,
                                    void* pre, void* out, void* stats,
                                    void* stream) {
  if (w <= 0 || h <= 0 || pad < 0 || wt0 <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Level L;
  L.p0 = static_cast<const uint8_t*>(pic0);
  L.p1 = static_cast<const uint8_t*>(pic1);
  L.w = w;
  L.h = h;
  L.pad = pad;
  L.stride = w + 2 * pad;
  L.bw = 2 * ((w + 15) / 16);
  L.bh = 2 * ((h + 15) / 16);
  L.wt0 = wt0;
  L.wt1 = wt1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* pp = static_cast<int*>(pre);
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  if (guided) {
    me_walk_kernel<true><<<1, WALK_THREADS, 0, s>>>(
        L, static_cast<const int*>(gx), static_cast<const int*>(gy), pp, st);
  } else {
    me_walk_kernel<false><<<1, WALK_THREADS, 0, s>>>(L, nullptr, nullptr, pp,
                                                     st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ncell = L.bw * L.bh;
  me_merge_kernel<<<(ncell + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS,
                    0, s>>>(L, pp, static_cast<int*>(out), st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
