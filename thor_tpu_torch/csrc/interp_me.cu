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
// Design. Block (r, c) reads the decisions of (r, c-1), (r-1, c-1),
// (r-1, c) and (r-1, c+1), so block row r may run two blocks behind row
// r-1 and the chain is BW + 2 (BH - 1) steps long, not BH x BW. One thread
// block walks one block row, left to right; the rows run side by side on
// the card's SMs. What a step needs of its own row (the left neighbour) it
// carries in registers, and of the row above only the up-right block is
// new: the up and up-left ones are the previous step's up-right and up.
// Rows meet through global memory: after a step the row's last warp stores
// the block's 2x2 cells of the five maps and then, with a release store,
// the row's progress counter; before a step lane 0 of every warp polls the
// counter of the row above with acquire loads until block min(c+1, BW-1)
// is there, reads that block's vector past L1 (ld.global.cg) and hands it
// to its warp by shuffle. No block barrier is spent on the handshake.
// Rows are handed out in order by an atomic ticket, a new one whenever a
// block finishes a row, so a block only ever waits on a row that a running
// block holds: any grid size is free of deadlock, whatever else occupies
// the card (a wait that never ends traps instead of hanging the card). The
// ticket and the counters follow the five maps in the scratch array that
// the caller zeroes on the stream.
// Inside a step, what can run side by side does: a warp owns one 16x16 SAD
// evaluation (8 pixels a lane, the lanes along x so that a load touches
// two rows of the plane, reduced by shuffles, no barrier). Warp 0 makes the
// skip test while warps 1..5 take the candidates' base costs. A candidate's
// refinement does not depend on the other candidates; only whether it is
// used does (the gate compares with the best cost so far). So all
// candidates are refined at once, ahead of the gate: warp 4k+d evaluates
// cross point d of candidate k, one barrier per refinement step, and the
// gate is applied afterwards, in candidate order, exactly as the serial
// search applies it. A step costs one barrier plus one per refinement
// step (the base costs are double-buffered by step parity). Each thread
// keeps the scalar state itself, so nothing is broadcast. The merge pass
// reads only the finished pre-merge map, so it is a second kernel: one
// warp per 8x8 cell, all cells in parallel. Nothing of the TPU kernel's
// aligned fetches, rolls, one-hot resampling products or row
// read-modify-writes is carried over.
//
// Bound. Bytes and operations are both tiny against the card (1080p
// level 0: 5.4 MB of planes, about 10^8 integer operations: microseconds).
// What bounds this kernel is the chain: 120 + 2 x 67 = 254 steps at 1080p
// level 0 (8 160 in raster order), each a few dependent rounds of
// L2-latency loads, shuffles and barriers, plus one trip through L2 per
// block row for the handshake.

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

// Handshake between block rows: a release store publishes every store the
// thread made before it, an acquire load orders every load it makes after.
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

// The wavefront walk over the 16x16 blocks: one thread block per block
// row. pre: [5, bh, bw] int32, zeroed by the caller: mv0x, mv0y, mv1x,
// mv1y, bg before the merge pass. sync: [1 + BH] int32, zeroed by the
// caller: the row ticket, then the number of blocks each row has decided.
template <bool GUIDED>
__global__ void __launch_bounds__(WALK_THREADS, 1)
me_walk_kernel(Level L, const int* __restrict__ gx, const int* __restrict__ gy,
               int* pre, int* sync, unsigned long long* stats) {
  constexpr int K = GUIDED ? 5 : 4;
  constexpr int N_ITERS = GUIDED ? 2 : 16;
  constexpr int SHIFT0 = GUIDED ? ACC_BITS : 3 + ACC_BITS;
  constexpr int LAM = GUIDED ? LAMBDA / 4 : LAMBDA;
  constexpr int THR = SKIP_THRESHOLD * 8 * 8;

  __shared__ int s_base[2][MAX_K + 1];     // base costs; [MAX_K]: skip flag
  __shared__ int s_res[2][WALK_WARPS];     // cross-point costs, by parity
  __shared__ int s_row;

  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int bw = L.bw, bh = L.bh, BW = bw / 2, BH = bh / 2;
  const int ncell = bw * bh;
  int* m0x = pre;
  int* m0y = pre + ncell;
  int* m1x = pre + 2 * ncell;
  int* m1y = pre + 3 * ncell;
  int* bgm = pre + 4 * ncell;
  int* progress = sync + 1;
  const int hP = L.h + L.pad, wP = L.w + L.pad;
  unsigned long long evals = 0;
  unsigned step = 0;                       // parity of s_base

  for (;;) {
    if (threadIdx.x == 0) s_row = atomicAdd(sync, 1);
    __syncthreads();
    const int r = s_row;
    __syncthreads();                       // s_row may be taken again
    if (r >= BH) break;
    const int yp = 2 * r, ystart = yp * 8;
    const bool up_ok = r > 0;
    const int* above = progress + r - 1;   // read only if up_ok
    const int row_up = (yp - 2) * bw;
    int seen = 0;                          // lane 0: row r-1's progress
    // decided mv1 of the neighbours: up, up-right, left, up-left. Where a
    // neighbour does not exist the value is never used: every use is
    // masked by validity.
    Neigh n;
    n.ux = n.uy = n.rx = n.ry = n.lx = n.ly = n.dx = n.dy = 0;

    for (int c = 0; c < BW; ++c, ++step) {
      const int xp = 2 * c, xstart = xp * 8;
      const bool upr_ok = up_ok && c < BW - 1;
      const bool left_ok = c > 0;

      if (up_ok) {
        // the row above must have decided block min(c+1, BW-1); at the last
        // column the up-right index is clamped onto the up block
        const int cr = min(c + 1, BW - 1);
        int v[4] = {0, 0, 0, 0};
        if (lane == 0) {
          unsigned spins = 0;
          while (seen < cr + 1) {
            seen = ld_acquire(above);
            if (++spins > (1u << 24)) __trap();   // the row above is lost
          }
          v[0] = __ldcg(m1x + row_up + 2 * cr);
          v[1] = __ldcg(m1y + row_up + 2 * cr);
          if (c == 0) {
            v[2] = __ldcg(m1x + row_up);
            v[3] = __ldcg(m1y + row_up);
          }
        }
        n.dx = n.ux, n.dy = n.uy;
        n.ux = n.rx, n.uy = n.ry;
        n.rx = __shfl_sync(FULL, v[0], 0);
        n.ry = __shfl_sync(FULL, v[1], 0);
        if (c == 0) {                    // the clamped up-left is the up one
          n.ux = n.dx = __shfl_sync(FULL, v[2], 0);
          n.uy = n.dy = __shfl_sync(FULL, v[3], 0);
        }
      }
      n.in4 = up_ok && left_ok && c < BW - 1;
      n.row0 = r == 0 && left_ok;
      n.col0 = c == 0 && up_ok;

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
          cx[k] = gx[yp * bw + xp], cy[k] = gy[yp * bw + xp], cv[k] = true;
          ++k;
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
      int* base = s_base[step & 1];
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
        if (lane == 0) base[MAX_K] = sk;
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (wid == k + 1 && cv[k]) {
            const int cst =
                full_cost<LAM>(L, n, xstart, ystart, cx[k], cy[k], lane);
            if (lane == 0) base[k] = cst;
          }
        }
      }
      __syncthreads();
      const bool sk = base[MAX_K] != 0;
      evals += 1;

      int best_x = skx, best_y = sky;
      if (!sk) {
        // step 2: refine every valid candidate at once, ahead of the gate
        int cost0[K], cost[K], rx[K], ry[K], shift[K], iters[K];
        bool active[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          cost0[k] = cv[k] ? base[k] : COST_MAX;
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
              const int cst = full_cost<LAM>(L, n, xstart, ystart,
                                             rx[k] + cross_dx(d) * off,
                                             ry[k] + cross_dy(d) * off, lane);
              if (lane == 0) res[wid] = cst;
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

      // Every thread holds the decision; the last warp, which has no SAD
      // to take at the start of the next step, stores and publishes it. On
      // a skip block mv1 is the skip vector and mv0 its scaled twin.
      if (threadIdx.x == WALK_THREADS - 32) {
        const int v0x = sk ? ssx : scale_val(best_x, -L.wt1, L.wt0);
        const int v0y = sk ? ssy : scale_val(best_y, -L.wt1, L.wt0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int cell = (yp + (q >> 1)) * bw + xp + (q & 1);
          m1x[cell] = best_x;
          m1y[cell] = best_y;
          m0x[cell] = v0x;
          m0y[cell] = v0y;
          bgm[cell] = sk ? 1 : 0;
        }
        st_release(progress + r, c + 1);
      }
      n.lx = best_x, n.ly = best_y;        // the next step's left neighbour
    }
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

// Thread blocks of the walk: one per block row, at most one per SM.
static int walk_blocks(int rows) {
  static int sms[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 1;
  }
  return rows < sms[dev] ? rows : sms[dev];
}

// pic0, pic1: [h + 2 pad, w + 2 pad] uint8; gx, gy: [bh, bw] int32 guide
// (read only if guided); pre: int32 scratch of 5 bh bw + bh / 2 + 1
// elements, zeroed by the caller on `stream`: the five pre-merge maps,
// then the row ticket and one progress counter per row of 16x16 blocks;
// out: [5, bh, bw] int32 (mv0x, mv0y, mv1x, mv1y, bg); stats: null or two
// 64-bit counters to which the 16x16 and the 8x8 SAD evaluations the level
// needed are added. Launches both kernels on `stream`; returns
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
  const int ncell = L.bw * L.bh;
  int* pp = static_cast<int*>(pre);
  int* sync = pp + 5 * ncell;
  unsigned long long* st = static_cast<unsigned long long*>(stats);
  const int blocks = walk_blocks(L.bh / 2);
  if (guided) {
    me_walk_kernel<true><<<blocks, WALK_THREADS, 0, s>>>(
        L, static_cast<const int*>(gx), static_cast<const int*>(gy), pp, sync,
        st);
  } else {
    me_walk_kernel<false><<<blocks, WALK_THREADS, 0, s>>>(L, nullptr, nullptr,
                                                          pp, sync, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  me_merge_kernel<<<(ncell + MERGE_WARPS - 1) / MERGE_WARPS, 32 * MERGE_WARPS,
                    0, s>>>(L, pp, static_cast<int*>(out), st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
