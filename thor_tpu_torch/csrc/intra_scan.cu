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
// Design. Decode order is a total order, but a TU depends only on the
// earlier TUs that wrote its context samples (row ty-1 from tx-1 to
// tx+toplen-1, column tx-1 from ty to ty+leftlen-1). On an I frame that is
// a wavefront over the superblocks and a finer one inside them; on a P or B
// frame the intra TUs are scattered and mostly independent. So the TUs run
// on all SMs, each as soon as what it reads is there:
//   - three small kernels prepare the schedule on the card (the host
//     hands over the same records as before; the first and the last are
//     shared with the encoder's scan, scan_common.cuh): one clears the
//     ticket and the owner map; one cuts the TUs into units of work, a
//     (TU, plane) pair, or one of its slices of 512 pixels where the TU is
//     larger, by a prefix sum over the TUs' slice counts, and writes the
//     unit table in decode order; one writes, for every 4x4 cell of the
//     plane, the index of the TU that covers it (-1: none), all TUs at
//     once, and marks every pixel of every TU in the output planes as
//     PENDING;
//   - the scan's warps take units in that order from an atomic ticket. A
//     lane fetches the context samples of one 4x4 cell: it looks up the
//     cell's owner. An owner earlier in decode order writes those samples
//     in this launch: the lane reads them from the output planes at L2
//     (ld.relaxed.gpu) until none is PENDING any more (the lane with the
//     latest owner polls first, the others after it). The pixel is its own
//     flag: one word, written once, so no fence and no second location are
//     needed, and a link of the chain is one store, one trip through L2 and
//     the tile. Any other sample (no owner, or an owner that comes later,
//     which the serial scan would not have run yet) is read from the input
//     planes, which the launch never writes, so no TU has to wait for its
//     readers;
//   - the warp predicts its slice of the s x s tile (every slice builds the
//     TU's context for itself), adds the residual, which was on its way
//     while the warp waited, clips and stores into the output planes.
// A unit only waits on units with lower tickets, and a ticket is taken
// only by a running warp, so every grid size is free of deadlock, whatever
// else occupies the card (a wait that never ends traps instead of hanging
// the card). A unit that waits holds its warp, so the units in flight are
// the resident warps: 56 on each SM (the context in shared memory is the
// limit), 7 392 on the card, about a 1080p plane's units. With fewer in
// flight the scan slows down, because decode order keeps the units of a
// wavefront far apart (measured on an H100 with thread blocks as the unit:
// 132 in flight took 2.3 times as long as 1 056; slices of 128 pixels,
// which make twice the units of a 1080p I frame, 1.8 times as long as
// slices of 512).
// A warp and not a block per unit also turns the unit's three block
// barriers into warp barriers, and the slices keep a 64x64 TU, which one
// warp would walk for 128 rounds, a link of the chain not much longer than
// an 8x8 one. The TPU kernel's tricks (a transposed plane copy for column
// reads, 0/1 permutation matmuls, aligned window rolls, placement matmuls
// for the blend) exist because the TPU has no cheap gathers or scalar
// addressing; here a thread simply indexes.
//
// Bound. The work is a few bytes per pixel of the intra TUs (a 1080p
// int32 luma plane is 8 MB and stays in the 50 MB L2). What bounds the
// kernel is the longest dependency chain among the TUs (ops/intra.py:
// intra_levels) times the latency of one link: a store, the poll that
// sees it at L2, the context and the tile.

#include "intra_predict.cuh"
#include "scan_common.cuh"

namespace {

using namespace thor;

constexpr int WARPS = 8;    // per block, each with its own context
constexpr int NT = 32 * WARPS;
constexpr int BLOCKS_PER_SM = 7;    // 7 x 8 contexts of 3.6 KB fill an SM
constexpr int SLICE = 512;  // pixels of a unit of work (ops/intra.py too)
constexpr int PREP_THREADS = 1024;

// units of work one plane of an s x s TU is cut into
__host__ __device__ __forceinline__ int slices(int s) {
  return s * s > SLICE ? s * s / SLICE : 1;
}

// One block. table[q] = the unit with ticket q as (t * C + plane) << 5 |
// slice, TU after TU; *nunits = their number. Units that do not fit into
// `cap` entries are left out (more slices than the planes' pixels allow:
// overlapping TUs). count: null, or the number of real records on the
// device (the rest pad a bucket and make no unit).
__global__ void __launch_bounds__(PREP_THREADS)
intra_scan_units_kernel(const int* __restrict__ recs, int nrec,
                        const int* __restrict__ count, int C, int* nunits,
                        int* table, int cap) {
  __shared__ int part[PREP_THREADS];
  const int k = threadIdx.x;
  if (count != nullptr) nrec = min(nrec, __ldg(count));
  const int per = (nrec + PREP_THREADS - 1) / PREP_THREADS;
  const int lo = min(k * per, nrec), hi = min(lo + per, nrec);
  int sum = 0;
  for (int t = lo; t < hi; ++t) sum += slices(recs[t * SCAN_NF + 2]);
  part[k] = sum;
  __syncthreads();
  for (int off = 1; off < PREP_THREADS; off <<= 1) {   // inclusive scan
    const int v = k >= off ? part[k - off] : 0;
    __syncthreads();
    part[k] += v;
    __syncthreads();
  }
  int q = (part[k] - sum) * C;           // first unit of this thread's TUs
  if (k == PREP_THREADS - 1) *nunits = min(part[k] * C, cap);
  for (int t = lo; t < hi; ++t) {
    const int n = slices(recs[t * SCAN_NF + 2]);
    for (int plane = 0; plane < C; ++plane) {
      for (int j = 0; j < n; ++j, ++q) {
        if (q < cap) table[q] = ((t * C + plane) << 5) | j;
      }
    }
  }
}

__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
intra_scan_kernel(const int* __restrict__ in, int* out,
                  const int* __restrict__ resid, int C, int H, int W,
                  const int* __restrict__ recs,
                  const int* __restrict__ owner,
                  const int* __restrict__ table,
                  const int* __restrict__ nunits, int* ticket) {
  __shared__ Ctx ctx[WARPS];
  Ctx& c = ctx[threadIdx.x >> 5];
  const size_t HW = static_cast<size_t>(H) * W;
  const int lane = threadIdx.x & 31;
  const int units = *nunits;

  int q = 0;
  if (lane == 0) q = atomicAdd(ticket, 1);
  q = __shfl_sync(0xffffffffu, q, 0);
  while (q < units) {
    // the next unit's ticket, drawn now and needed after this unit
    int next = 0;
    if (lane == 0) next = atomicAdd(ticket, 1);
    const int e = table[q];
    const int tp = e >> 5, t = tp / C, plane = tp - t * C;
    const int* rc = recs + static_cast<size_t>(t) * SCAN_NF;
    const int ty = rc[0], tx = rc[1], s = rc[2], mode = rc[3];
    const int toplen = rc[4], leftlen = rc[5], cbx = rc[6];
    int* P = out + plane * HW;
    const int* Rz = resid + plane * HW;

    // The residual does not wait for the neighbours: a round of it (4
    // pixels a lane) is on its way while the context is built, and the next
    // round while this one is predicted.
    const int sh = __ffs(s) - 1;               // s is a power of two
    const int first = (e & 31) * SLICE, end = min(s * s, first + SLICE);
    int r[4];
    auto residual = [&](int base) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = base + 32 * u + lane;
        r[u] = p < end ? __ldg(Rz + static_cast<size_t>(ty + (p >> sh)) * W
                               + tx + (p & (s - 1)))
                       : 0;
      }
    };
    residual(first);

    // (1), (2) context samples, filtered context, top-left, DC value
    const ScanSamples at{in + plane * HW, P, owner, H, W, (W + 3) >> 2, t};
    load_context_warp(c, at, lane, ty, tx, s, mode, toplen, leftlen, cbx);

    // (3) predict, add residual, clip, store
    for (int base = first; base < end; base += 128) {
      const int cur[4] = {r[0], r[1], r[2], r[3]};
      if (base + 128 < end) residual(base + 128);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = base + 32 * u + lane;
        if (p < end) {
          const int i = p >> sh, j = p & (s - 1);
          st_pixel(P + static_cast<size_t>(ty + i) * W + tx + j,
                   clip255(predict(c, s, mode, i, j) + cur[u]));
        }
      }
    }
    __syncwarp();                // the context may be rebuilt
    q = __shfl_sync(0xffffffffu, next, 0);
  }
}

}  // namespace

// planes: [C, H, W] int32, read only; out: [C, H, W] int32, a copy of
// planes that the scan updates in place; resid: [C, H, W] int32; recs:
// [nrec, 7] int32 TU records in decode order, every TU inside the plane,
// ty, tx and size multiples of 4, no two TUs overlapping; count: null (all
// nrec records are real), or one int32 on the device, the number of real
// records at the head of recs (a frame's records padded to a bucket: the
// grid and the scratch follow nrec, the work follows *count, so a CUDA
// graph captured for the bucket serves every count in it); scratch:
// int32, uninitialised, 2 + cap + ceil(H/4) ceil(W/4) elements with cap
// = C min(8 nrec, nrec + H W / 512), the most units the records can make
// (ops/intra.py: scan_scratch). Launches its four kernels on `stream`;
// returns cudaGetLastError().
extern "C" int thor_intra_scan_count(const void* planes, void* out,
                                     const void* resid, int C, int H, int W,
                                     const void* recs, int nrec,
                                     const void* count, void* scratch,
                                     void* stream) {
  if (nrec <= 0) return 0;
  const int* cnt = static_cast<const int*>(count);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int by_size = 64 * 64 / SLICE * nrec, by_area = nrec + H * W / SLICE;
  const int cap = C * (by_size < by_area ? by_size : by_area);
  int* ticket = static_cast<int*>(scratch);
  int* nunits = ticket + 1;
  int* table = ticket + 2;
  int* owner = table + cap;
  const int* rc = static_cast<const int*>(recs);
  scan_prologue(rc, nrec, ticket, owner, static_cast<int*>(out), C, H, W, s,
                cnt);
  intra_scan_units_kernel<<<1, PREP_THREADS, 0, s>>>(rc, nrec, cnt, C,
                                                     nunits, table, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = sm_count() * BLOCKS_PER_SM;
  const int wanted = (cap + WARPS - 1) / WARPS;
  intra_scan_kernel<<<wanted < resident ? wanted : resident, NT, 0, s>>>(
      static_cast<const int*>(planes), static_cast<int*>(out),
      static_cast<const int*>(resid), C, H, W, rc, owner, table, nunits,
      ticket);
  return static_cast<int>(cudaGetLastError());
}

// The same with every record real (the entry point of the builds before
// the count; tools/ab_kernel.py calls it on either build).
extern "C" int thor_intra_scan(const void* planes, void* out,
                               const void* resid, int C, int H, int W,
                               const void* recs, int nrec, void* scratch,
                               void* stream) {
  return thor_intra_scan_count(planes, out, resid, C, H, W, recs, nrec,
                               nullptr, scratch, stream);
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
