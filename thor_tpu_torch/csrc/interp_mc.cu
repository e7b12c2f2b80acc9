// Synthesis of the temporally interpolated frame for the Thor decoder,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernels thor_tpu/ops/pallas_interp.py:_mot_comp_kernel
// (luma; wrapper mot_comp_pallas) and :_mot_comp_kernel_uv (U and V in one
// pass; wrapper mot_comp_pallas_uv). Same function (interpolate_frame +
// mot_comp_avg, common/temporal_interp.c:387-441, :920-970): every cs x cs
// cell of the output has one vector into each of two references. The
// cell's two windows start at the cell origin plus the vector rounded to
// whole pels; each pixel coordinate is clipped on its own to the halo
// [-clip_pad, dim + clip_pad - 1]. The output is the rounded average of
// the two windows, unless exactly one of them lies wholly inside the halo:
// then it is that window alone.
//
// Two things the TPU kernels left to XLA ops around them are done here
// too, so that the synthesis from level 0's vectors to the three padded
// reference planes is two launches:
//   - the output is the codec-padded plane [h + 2 pad, w + 2 pad], each
//     border pixel replicated pad pels out (edge_pad; pad = 0 gives the
//     TPU kernels' [h, w] plane);
//   - the U/V kernel takes the luma mv1 field and the weights and derives
//     each cell's chroma vectors itself: c1 = mv1 >> 1, c0 =
//     _scale_val(c1, -wt1, wt0), rounded half away from zero.
//
// Design. A thread owns one cs-byte word of one row of the padded output:
// 8 bytes of luma, or 4 of U and the 4 of V beside them. Its cell's two
// window origins and inside tests are computed once. cs and clip_pad are
// template parameters, so cell indices are shifts and the loops unroll. A
// window inside the halo (every cell but a few at the frame's edge) is read
// as the cs / 4 + 1 aligned 32-bit words that hold its row and realigned by
// a funnel shift; __vavgu4 is (a + b + 1) >> 1 on four bytes at once. Only
// a cell whose windows both leave the halo clips pixel by pixel, with byte
// loads. A word of the pad, or past w, takes its bytes from the edge pixel
// of the cell it recomputes (a byte permute); a pad row recomputes row 0 or
// h - 1, whose reads hit L2. Each thread stores its word once, as one 8- or
// 4-byte store where the destination is aligned and byte by byte where it
// is not (w + 2 pad not a multiple of cs). No thread reads another's
// output, and the grid covers exactly the padded rows, so a cell row past
// h writes nothing.
//
// Bound: bytes. At 1080p luma the two input planes within the windows'
// reach (the plane and its 4-pel halo, 2 x 2.1 MB), the vectors (0.5 MB)
// and the padded output (2.7 MB) are 7.4 MB, 2.2 us at 3.35 TB/s; U+V
// 3.7 MB, 1.1 us. The work is about 80 integer
// instructions a thread: 336 k luma and 168 k chroma threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ACC_BITS = 3;
constexpr int ACC_ROUND = 1 << (ACC_BITS - 1);
constexpr int ROWS = 8;          // output rows of a block; 32 words a row
constexpr int MARGIN = 8;        // least base - clip_pad: the aligned words
                                 // of a window row stay inside its row

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// _scale_val(v, -wt1, wt0): round half away from zero. The division by
// wt0 is a multiply by recip = floor((2^64 - 1) / wt0) + 1, exact for any
// 32-bit numerator (recip * wt0 exceeds 2^64 by less than wt0).
__device__ __forceinline__ int scale_val(int v, int wt0, int wt1,
                                         unsigned long long recip) {
  const int prod = v * -wt1;
  const unsigned long long n =
      static_cast<unsigned>(prod < 0 ? -prod : prod) +
      static_cast<unsigned>(wt0 >> 1);
  const int mag = static_cast<int>(wt0 == 1 ? n : __umul64hi(n, recip));
  return prod >= 0 ? mag : -mag;
}

// Row y of the CS-wide window at column xs, as CS / 4 little-endian words.
// clip == false: the window lies inside the halo, so the row is read as
// the aligned words that hold it. clip == true: each coordinate is clipped
// to the halo on its own.
template <int CS, int CLIP>
__device__ __forceinline__ void window_row(const uint8_t* __restrict__ plane,
                                           int stride, int base, int w, int h,
                                           int y, int xs, bool clip,
                                           uint32_t (&out)[CS / 4]) {
  constexpr int NW = CS / 4;
  if (!clip) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(
        plane + static_cast<size_t>(y + base) * stride + base + xs);
    const uint32_t* a4 = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
    const int sh = 8 * static_cast<int>(a & 3);
    uint32_t wd[NW + 1];
#pragma unroll
    for (int k = 0; k <= NW; ++k) wd[k] = __ldg(a4 + k);
#pragma unroll
    for (int j = 0; j < NW; ++j) out[j] = __funnelshift_r(wd[j], wd[j + 1], sh);
  } else {
    const uint8_t* row = plane +
        static_cast<size_t>(clampi(y, -CLIP, h + CLIP - 1) + base) * stride +
        base;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      uint32_t v = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v |= static_cast<uint32_t>(
                 __ldg(row + clampi(xs + 4 * j + i, -CLIP, w + CLIP - 1)))
             << (8 * i);
      out[j] = v;
    }
  }
}

// Luma: p0a, p1a -> outa with the vectors mv0, mv1. UV: U (a) and V (b)
// with the vectors derived from the luma mv1 field and the weights.
template <int CS, int CLIP, bool UV>
__global__ void __launch_bounds__(32 * ROWS)
mot_comp_row_kernel(const uint8_t* __restrict__ p0a,
                    const uint8_t* __restrict__ p1a, uint8_t* __restrict__ outa,
                    const uint8_t* __restrict__ p0b,
                    const uint8_t* __restrict__ p1b, uint8_t* __restrict__ outb,
                    const int* __restrict__ mv0, const int* __restrict__ mv1,
                    int bw, int w, int h, int base, int pad, int wt0, int wt1,
                    unsigned long long recip) {
  constexpr int NW = CS / 4;
  constexpr int LOG2 = CS == 8 ? 3 : 2;
  static_assert(CS == 4 || CS == 8, "a cell is 4 or 8 pixels wide");
  const int Wo = w + 2 * pad, Ho = h + 2 * pad;
  const int X0 = (blockIdx.x * 32 + threadIdx.x) * CS;   // padded column
  const int Y = blockIdx.y * ROWS + threadIdx.y;          // padded row
  if (X0 >= Wo || Y >= Ho) return;
  const int y = clampi(Y - pad, 0, h - 1);
  const int ii = y >> LOG2, jj = clampi(X0 - pad, 0, w - 1) >> LOG2;
  const int cell = (ii * bw + jj) * 2;

  // the cell's vectors (1/8 pel) and its two window origins
  int v0x, v0y, v1x, v1y;
  if constexpr (UV) {
    v1x = __ldg(mv1 + cell) >> 1;
    v1y = __ldg(mv1 + cell + 1) >> 1;
    v0x = scale_val(v1x, wt0, wt1, recip);
    v0y = scale_val(v1y, wt0, wt1, recip);
  } else {
    v0x = __ldg(mv0 + cell);
    v0y = __ldg(mv0 + cell + 1);
    v1x = __ldg(mv1 + cell);
    v1y = __ldg(mv1 + cell + 1);
  }
  const int xs0 = (jj << LOG2) + ((v0x + ACC_ROUND) >> ACC_BITS);
  const int ys0 = (ii << LOG2) + ((v0y + ACC_ROUND) >> ACC_BITS);
  const int xs1 = (jj << LOG2) + ((v1x + ACC_ROUND) >> ACC_BITS);
  const int ys1 = (ii << LOG2) + ((v1y + ACC_ROUND) >> ACC_BITS);
  const bool in0 = xs0 >= -CLIP && xs0 + CS <= w + CLIP && ys0 >= -CLIP &&
                   ys0 + CS <= h + CLIP;
  const bool in1 = xs1 >= -CLIP && xs1 + CS <= w + CLIP && ys1 >= -CLIP &&
                   ys1 + CS <= h + CLIP;
  // one window alone where exactly one lies inside; else the average, of
  // clipped windows where neither does
  const bool use0 = in0 || !in1, use1 = in1 || !in0, clip = !in0 && !in1;
  const int dy = y - (ii << LOG2);

  // byte k of the stored word is byte sel(k) of the cell row: k itself
  // inside the plane, the edge pixel's in the pad and past w
  uint32_t sel[NW];
  if (X0 >= pad && X0 + CS <= pad + w) {
#pragma unroll
    for (int j = 0; j < NW; ++j) sel[j] = j ? 0x7654u : 0x3210u;
  } else {
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      sel[j] = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        sel[j] |= static_cast<uint32_t>(
                      clampi(X0 + 4 * j + i - pad, 0, w - 1) - (jj << LOG2))
                  << (4 * i);
    }
  }

  const int stride = w + 2 * base;
  const size_t o = static_cast<size_t>(Y) * Wo + X0;
#pragma unroll
  for (int p = 0; p < (UV ? 2 : 1); ++p) {
    uint32_t a[NW], b[NW], v[NW];
    if (use0)
      window_row<CS, CLIP>(p ? p0b : p0a, stride, base, w, h, ys0 + dy, xs0,
                           clip, a);
    if (use1)
      window_row<CS, CLIP>(p ? p1b : p1a, stride, base, w, h, ys1 + dy, xs1,
                           clip, b);
#pragma unroll
    for (int j = 0; j < NW; ++j)
      v[j] = use0 && use1 ? __vavgu4(a[j], b[j]) : (use0 ? a[j] : b[j]);
    uint32_t word[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j)
      word[j] = __byte_perm(v[0], NW > 1 ? v[NW - 1] : 0u, sel[j]);
    uint8_t* dst = (p ? outb : outa) + o;
    if (X0 + CS <= Wo && (reinterpret_cast<uintptr_t>(dst) & (CS - 1)) == 0) {
      if constexpr (NW == 2) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(word[0], word[1]);
      } else {
        *reinterpret_cast<uint32_t*>(dst) = word[0];
      }
    } else {
#pragma unroll
      for (int i = 0; i < CS; ++i)
        if (X0 + i < Wo)
          dst[i] = static_cast<uint8_t>(word[i >> 2] >> (8 * (i & 3)));
    }
  }
}

// CS, CLIP: (8, 4) for luma, (4, 2) for U and V.
template <int CS, int CLIP, bool UV>
int launch(const void* p0a, const void* p1a, void* outa, const void* p0b,
           const void* p1b, void* outb, const void* mv0, const void* mv1,
           int bw, int bh, int w, int h, int base, int pad, int wt0, int wt1,
           void* stream) {
  if (w <= 0 || h <= 0 || bw * CS < w || bh * CS < h ||
      base < CLIP + MARGIN || pad < 0 || pad % CS != 0 || (UV && wt0 <= 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned long long recip =
      UV && wt0 > 1 ? ~0ull / static_cast<unsigned>(wt0) + 1 : 0;
  const int Wo = w + 2 * pad, Ho = h + 2 * pad;
  const dim3 block(32, ROWS);
  const dim3 grid(((Wo + CS - 1) / CS + 31) / 32, (Ho + ROWS - 1) / ROWS);
  mot_comp_row_kernel<CS, CLIP, UV>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint8_t*>(p0a), static_cast<const uint8_t*>(p1a),
          static_cast<uint8_t*>(outa), static_cast<const uint8_t*>(p0b),
          static_cast<const uint8_t*>(p1b), static_cast<uint8_t*>(outb),
          static_cast<const int*>(mv0), static_cast<const int*>(mv1), bw, w,
          h, base, pad, wt0, wt1, recip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Planes: [h + 2 base, w + 2 base] uint8 codec-padded inputs; outputs
// [h + 2 pad, w + 2 pad] uint8. The cells (cs, clip_pad) are (8, 4) for
// luma and (4, 2) for U and V; base >= clip_pad + 8; pad a multiple of cs.
// Each entry launches once on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for arguments outside these).

// mv0, mv1: [bh, bw, 2] int32 (x, y) cell vectors in this plane's units.
extern "C" int thor_interp_mot_comp(const void* p0, const void* p1, void* out,
                                    const void* mv0, const void* mv1, int bw,
                                    int bh, int w, int h, int base, int pad,
                                    void* stream) {
  return launch<8, 4, false>(p0, p1, out, nullptr, nullptr, nullptr, mv0,
                             mv1, bw, bh, w, h, base, pad, 1, 0, stream);
}

// m1: the luma mv1 field [bh, bw, 2] int32 on the same cell grid; wt0 > 0.
extern "C" int thor_interp_mot_comp_uv(const void* p0u, const void* p1u,
                                       const void* p0v, const void* p1v,
                                       void* outu, void* outv, const void* m1,
                                       int bw, int bh, int w, int h, int base,
                                       int pad, int wt0, int wt1,
                                       void* stream) {
  return launch<4, 2, true>(p0u, p1u, outu, p0v, p1v, outv, nullptr, m1, bw,
                            bh, w, h, base, pad, wt0, wt1, stream);
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
