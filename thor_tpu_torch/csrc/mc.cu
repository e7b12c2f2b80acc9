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
// VMEM and rolled them so every tap slice had a static offset. Here a warp
// takes one record (a PU, a TILE x TILE piece of a larger one, or a
// clamped 4x4 / 2x2 cell: ops/mc.py:build_mc_records) and a block packs
// WARPS consecutive records, so an 8x8 PU no longer leaves three quarters
// of a block idle; U and V share one record set and one launch (blockIdx.y
// selects the plane). Per list the warp
//   - stages the record's (h+T-1) x (w+T-1) reference window in shared
//     memory as the aligned 4-byte words that hold it, one load and one
//     store a word and lane, instead of T*T byte loads from global memory
//     per output pixel;
//   - loads the phase's T x T weights and tests whether they are an outer
//     product fv (x) fh with fv, fh the row and column sums over 64 (every
//     phase of the codec's tables but the luma (1/2, 1/2) low-pass, whose
//     sums it still takes but whose test fails). The test is exact, so the
//     separable path runs only where it gives the same integers;
//   - separable: a horizontal pass, 4 outputs a lane from three words of
//     the window (realigned by a funnel shift where the plane's rows do
//     not start on a word), into an int32 tile, then a vertical pass; the
//     reference
//     has no rounding between the two (ops/kernels.py:build_luma_mc_lut),
//     and the integer sums are the same in either order. 2 T taps per
//     output instead of T*T;
//   - otherwise the T x T sum straight from the window;
//   - a lane computes RPI outputs of one column (4 rows luma, 2 chroma),
//     so a 16x16 luma piece is two rounds of the warp and an 8x8 chroma
//     one; the first list's results stay in registers for the bipred
//     average.
//
// Bound. At 1080p the work is a few hundred million integer MACs and a
// few MB of reference and output traffic: microseconds on paper. The
// kernel is latency-bound per record (the record, then its window, two
// dependent trips to L2, then the passes on one warp): 8 warps a block
// and 4 (luma, 64 registers) or 6 (chroma, 40) blocks an SM keep 4 224
// or 6 336 records in flight, against 8 260 a plane of a 1080p P frame.
// Six blocks an SM for luma (at most 40 registers) spilled and were no
// faster on an H100.
//
// Every tap window must lie inside the padded plane; the host record
// builder (ops/mc.py:build_mc_records) clamps each MV cell's window
// origin into the plane where a PU's window would leave it, and gives a
// uni-predicted PU's list 1 the window of its list 0, so no byte of a
// window lies outside its reference plane (the aligned words around it
// may reach up to 3 bytes further, never past the 4-byte-aligned word of
// a byte inside the plane).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// record fields (ops/mc.py)
constexpr int NF = 13;
enum { Y0, X0, RH, RW, S0, P0, IY0, IX0, BI, S1, P1, IY1, IX1 };
constexpr int WARPS = 8;            // records of a block, one a warp
constexpr unsigned ALL = 0xffffffffu;

template <int T>
struct Geo {
  static constexpr int TILE = T == 6 ? 16 : 8;   // largest piece side
  static constexpr int WIN = TILE + T - 1;        // window side
  static constexpr int NW = (3 + WIN + 3) / 4;    // words of a window row
  static constexpr int HS = TILE + 1;             // horizontal tile stride
  static constexpr int RPI = T == 6 ? 4 : 2;      // rows a lane computes
  static constexpr int ITEMS = TILE / RPI * TILE / 32;   // per lane
};

template <int T>
struct WarpBuf {
  // the reference window: NW aligned words a row, as they lie in the
  // plane (a row starts `lead` bytes into its first word), and one word
  // that the last row's realignment may read
  uint32_t win[Geo<T>::WIN * Geo<T>::NW + 1];
  int hz[Geo<T>::WIN * Geo<T>::HS];        // horizontal pass
  int wt[T * T];                           // the phase's weights
  int f[2 * T];                            // fv, then fh
};

__device__ __forceinline__ int byte_of(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 255;
}

// bytes of a window row's first word before the row starts
__device__ __forceinline__ int lead_of(const uint8_t* row) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(row) & 3);
}

template <int T>
__global__ void __launch_bounds__(32 * WARPS)
mc_kernel(const uint8_t* __restrict__ ref, int R, int Hp, int Wp,
          const int* __restrict__ recs, int nrec,
          const int* __restrict__ count, const int* __restrict__ lut,
          int* __restrict__ out, int H, int W) {
  using G = Geo<T>;
  __shared__ __align__(16) WarpBuf<T> bufs[WARPS];
  WarpBuf<T>& b = bufs[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (k >= nrec || (count != nullptr && k >= __ldg(count))) return;
  const int c = blockIdx.y;

  const int rv = lane < NF ? __ldg(recs + static_cast<size_t>(k) * NF + lane)
                           : 0;
  const int h = __shfl_sync(ALL, rv, RH), w = __shfl_sync(ALL, rv, RW);
  const int bi = __shfl_sync(ALL, rv, BI);
  const int wh = h + T - 1, ww = w + T - 1;
  const int groups = (h + G::RPI - 1) / G::RPI, items = groups * w;
  const size_t plane = static_cast<size_t>(Hp) * Wp;
  int acc[G::ITEMS][G::RPI];

  for (int list = 0; list <= (bi ? 1 : 0); ++list) {
    const int slot = __shfl_sync(ALL, rv, list ? S1 : S0);
    const int phase = __shfl_sync(ALL, rv, list ? P1 : P0);
    const int iy = __shfl_sync(ALL, rv, list ? IY1 : IY0);
    const int ix = __shfl_sync(ALL, rv, list ? IX1 : IX0);
    if (list) __syncwarp();        // the first list's buffers are read out
    // (1) the weights and the window, one aligned word a lane
    for (int t = lane; t < T * T; t += 32)
      b.wt[t] = __ldg(lut + phase * T * T + t);
    const uint8_t* src = ref + (static_cast<size_t>(c) * R + slot) * plane
                         + static_cast<size_t>(iy) * Wp + ix;
    for (int o = lane; o < wh * G::NW; o += 32) {
      const int r = o / G::NW, wi = o - r * G::NW;
      const uint8_t* a = src + static_cast<size_t>(r) * Wp;
      const int lead = lead_of(a);
      if (4 * wi - lead < ww)                // a word the window touches
        b.win[r * G::NW + wi] =
            __ldg(reinterpret_cast<const uint32_t*>(a - lead) + wi);
    }
    __syncwarp();
    // (2) outer-product test: row sums (lanes 0..T-1) and column sums
    // (lanes T..2T-1) over 64 are fv and fh where the weights factor
    bool ok = true;
    if (lane < 2 * T) {
      int sum = 0;
      for (int q = 0; q < T; ++q)
        sum += lane < T ? b.wt[lane * T + q] : b.wt[q * T + lane - T];
      ok = (sum & 63) == 0;
      b.f[lane] = sum >> 6;
    }
    __syncwarp();
    for (int t = lane; t < T * T; t += 32)
      ok = ok && b.wt[t] == b.f[t / T] * b.f[T + t % T];
    const bool sep = __all_sync(ALL, ok);

    int p[G::ITEMS][G::RPI] = {};
    if (sep) {
      // (3a) horizontal pass: 4 outputs a lane from 3 (T = 6) or 2
      // (T = 4) words of a window row, realigned to the window's columns
      const int gw = (w + 3) >> 2;
      for (int o = lane; o < wh * gw; o += 32) {
        const int r = o / gw, x0 = 4 * (o - r * gw);
        const int sh = 8 * lead_of(src + static_cast<size_t>(r) * Wp);
        const uint32_t* row = b.win + r * G::NW + (x0 >> 2);
        uint32_t wd[(T + 6) / 4];
#pragma unroll
        for (int q = 0; q < (T + 6) / 4; ++q)
          wd[q] = __funnelshift_r(row[q], row[q + 1], sh);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int s = 0;
#pragma unroll
          for (int n = 0; n < T; ++n) s += b.f[T + n] * byte_of(wd, j + n);
          if (x0 + j < w) b.hz[r * G::HS + x0 + j] = s;
        }
      }
      __syncwarp();
      // (3b) vertical pass: RPI outputs of one column a lane
#pragma unroll
      for (int it = 0; it < G::ITEMS; ++it) {
        const int o = lane + 32 * it;
        if (o >= items) break;
        const int g = o / w, x = o - g * w, y0 = g * G::RPI;
        int col[G::RPI + T - 1];
#pragma unroll
        for (int m = 0; m < G::RPI + T - 1; ++m)
          col[m] = y0 + m < wh ? b.hz[(y0 + m) * G::HS + x] : 0;
#pragma unroll
        for (int j = 0; j < G::RPI; ++j) {
          int s = 2048;
#pragma unroll
          for (int m = 0; m < T; ++m) s += b.f[m] * col[j + m];
          p[it][j] = s;
        }
      }
    } else {
      // (3) the T x T sum from the window
#pragma unroll
      for (int it = 0; it < G::ITEMS; ++it) {
        const int o = lane + 32 * it;
        if (o >= items) break;
        const int g = o / w, x = o - g * w, y0 = g * G::RPI;
#pragma unroll
        for (int j = 0; j < G::RPI; ++j) p[it][j] = 2048;
#pragma unroll
        for (int m = 0; m < G::RPI + T - 1; ++m) {
          if (y0 + m >= wh) break;
          const uint8_t* row =
              reinterpret_cast<const uint8_t*>(b.win + (y0 + m) * G::NW)
              + lead_of(src + static_cast<size_t>(y0 + m) * Wp) + x;
          int px[T];
#pragma unroll
          for (int n = 0; n < T; ++n) px[n] = row[n];
#pragma unroll
          for (int j = 0; j < G::RPI; ++j) {
            const int mm = m - j;
            if (mm >= 0 && mm < T) {
#pragma unroll
              for (int n = 0; n < T; ++n) p[it][j] += b.wt[mm * T + n] * px[n];
            }
          }
        }
      }
    }
    // (4) round, clip (an arithmetic shift: floor, as in the reference),
    // and the bipred average
#pragma unroll
    for (int it = 0; it < G::ITEMS; ++it) {
#pragma unroll
      for (int j = 0; j < G::RPI; ++j) {
        int v = p[it][j] >> 12;
        v = v < 0 ? 0 : (v > 255 ? 255 : v);
        acc[it][j] = list ? (acc[it][j] + v) >> 1 : v;
      }
    }
  }

  // (5) store under the PU
  const int Y = __shfl_sync(ALL, rv, Y0), X = __shfl_sync(ALL, rv, X0);
#pragma unroll
  for (int it = 0; it < G::ITEMS; ++it) {
    const int o = lane + 32 * it;
    if (o >= items) break;
    const int g = o / w, x = o - g * w, y0 = g * G::RPI;
#pragma unroll
    for (int j = 0; j < G::RPI; ++j) {
      if (y0 + j < h)
        out[(static_cast<size_t>(c) * H + Y + y0 + j) * W + X + x] =
            acc[it][j];
    }
  }
}

}  // namespace

// ref: [C, R, Hp, Wp] uint8; recs: [nrec, 13] int32 (PU pieces of at most
// TILE x TILE, TILE = 16 for T = 6 and 8 for T = 4); count: null (all nrec
// records are real), or one int32 on the device, the number of real
// records at the head of recs (the grid follows nrec, a bucket's
// capacity, and the warps past *count return at once, so a CUDA graph
// captured for the bucket serves every count in it); lut: [P, T*T]
// int32; out: [C, H, W] int32. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int thor_mc_frame_count(const void* ref, int C, int R, int Hp,
                                   int Wp, const void* recs, int nrec,
                                   const void* count, const void* lut, int T,
                                   void* out, int H, int W, void* stream) {
  if (nrec <= 0) return 0;
  dim3 grid((nrec + WARPS - 1) / WARPS, C);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* rp = static_cast<const uint8_t*>(ref);
  const int* rc = static_cast<const int*>(recs);
  const int* cp = static_cast<const int*>(count);
  const int* lp = static_cast<const int*>(lut);
  int* op = static_cast<int*>(out);
  if (T == 6) {
    mc_kernel<6><<<grid, 32 * WARPS, 0, s>>>(rp, R, Hp, Wp, rc, nrec, cp, lp,
                                            op, H, W);
  } else if (T == 4) {
    mc_kernel<4><<<grid, 32 * WARPS, 0, s>>>(rp, R, Hp, Wp, rc, nrec, cp, lp,
                                            op, H, W);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The same with every record real (the entry point of the builds before
// the count; tools/ab_kernel.py calls it on either build).
extern "C" int thor_mc_frame(const void* ref, int C, int R, int Hp, int Wp,
                             const void* recs, int nrec, const void* lut,
                             int T, void* out, int H, int W, void* stream) {
  return thor_mc_frame_count(ref, C, R, Hp, Wp, recs, nrec, nullptr, lut, T,
                             out, H, W, stream);
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
