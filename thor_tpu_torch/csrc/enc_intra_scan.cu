// Encoder intra scan for the Thor device encoder, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel thor_tpu/ops/pallas_enc_intra.py:_enc_scan_kernel
// (public wrapper encode_scan_pallas). Same function: the chosen transform
// units (TUs) of a frame in coding order; per TU build the prediction
// context from already reconstructed pixels, predict with one of 10 modes,
// take the residual against the original, forward-transform (two integer
// matrix stages, each wrapped to int16), zigzag, quantize with the
// reference's offsets (38/102/115 intra, -26/51/90 inter), run the
// sequential zero-run pass (enc/encode_block.c:134-168), then dequantize,
// inverse-transform (each stage saturated to int16), add, clip and write
// the reconstruction back, and put out the quantized 16x16 coefficient
// bank of the TU. Arithmetic parity: enc/device_intra._encode_scan_fn of
// the JAX package (fwd_transform_batch, quantize_fwd_batch with
// chroma=False for every plane, _recon_from_q).
//
// Design. Coding order is a total order, but a TU depends only on the
// earlier TUs that wrote its context samples: on a 1080p I frame a chain
// of about 570 links over about 4 200 TUs per plane class
// (ops/intra.intra_levels). So the TUs run on all SMs with the schedule of
// the decoder's scan (scan_common.cuh): two prologue kernels clear the
// ticket, build the owner map of the 4x4 cells and mark every TU pixel
// PENDING in the output planes; then resident warps take units, one
// (TU, plane) each, U and V of a TU being two units, in coding order from
// an atomic ticket, wait in load_context_warp for the samples an earlier
// TU writes, and run the whole TU alone:
//   - a warp, not a block, per unit: the transform needs the whole TU, so a
//     unit is never sliced, and a warp turns the dozen block barriers a TU
//     paid in a one-block walk into warp barriers;
//   - the working set of a unit is 6.2 KB of shared memory, all int16 (the
//     context, the box-summed residual, one transform stage, the scan
//     vector, the levels; the dequantized block reuses the scan vector and
//     the inverse output the residual); the prediction is recomputed where
//     it is needed rather than held as a tile, and the transform matrices
//     (int8) and the zigzag tables are kept once per block. That puts 32
//     warps on an SM, 4 224 units in flight on an H100;
//   - a link of the chain is the TU's whole predict / transform / quantize
//     / inverse / store sequence on one warp, so nothing hides a step's
//     latency but the steps beside it: the original is box-summed before
//     the warp waits for its context; the pixel loops are compiled once per
//     mode and box size and the dot products once per length (by_mode,
//     by_len, by_box), so their iterations overlap; the dot products take
//     4 products in two __dp2a (int16 data against int8 matrix rows), a
//     lane two outputs at a time; the reconstruction computes four pixels
//     a lane before it stores them. Measured on an H100, this took a
//     64x64 link from 56 to 26 us and an 8x8 one from 5.1 to 4.8 (pure
//     chains, chip_smoke.py);
//   - quantization is a lane per scan position with a warp max for the last
//     significant one; the zero-run pass (a change at p alters the tests at
//     p+1..p+4) tests 32 positions at a time under the current levels, a
//     ballot finds the first that fires, one lane applies it and the
//     window restarts behind it: (positions / 32 + changes) steps;
//   - a TU whose levels are all zero skips the inverse transform.
// A unit only waits on units with lower tickets, and only a running warp
// takes a ticket, so every grid size is free of deadlock (a wait that
// never ends traps after 2^24 polls).
//
// Bound. Bytes: the original read once, the plane written once (int32
// both), 512 B of bank per TU and plane. Operations: the four matrix
// stages, 2 * (qs*n*n + qs*qs*n) forward and 2 * (m*qs*qs + m*m*qs)
// inverse per TU (qs = min(s, 16)). Neither is what it takes: the longest
// dependency chain among the TUs, each link weighted by its TU's latency
// on one warp (the poll that sees a neighbour's pixel at L2, then the
// TU's own sequence, which grows with its size).

#include <type_traits>

#include "intra_predict.cuh"
#include "scan_common.cuh"

namespace {

using namespace thor;

constexpr int WARPS = 8;            // units a block holds at once
constexpr int NT = 32 * WARPS;
constexpr int BLOCKS_PER_SM = 4;    // 4 x 50.6 KB of shared memory
constexpr int TS = 34;   // row stride of the 32-wide int16 tiles and
constexpr int TR = 18;   // of the 16-wide ones: an odd number of words, so
//                          a row starts on a word and a walk down a column
//                          hits 32 different banks
constexpr unsigned ALL = 0xffffffffu;

// HEVC-style 32-point integer DCT basis (common/transform.c g4mat_hevc).
// The n-point matrix is its rows 0, 32/n, 2*32/n, ... cut to n columns.
__constant__ signed char kTmat32[32][32] = {
    { 64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,
      64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64,  64},
    { 90,  90,  88,  85,  82,  78,  73,  67,  61,  54,  46,  38,  31,  22,  13,   4,
      -4, -13, -22, -31, -38, -46, -54, -61, -67, -73, -78, -82, -85, -88, -90, -90},
    { 90,  87,  80,  70,  57,  43,  25,   9,  -9, -25, -43, -57, -70, -80, -87, -90,
     -90, -87, -80, -70, -57, -43, -25,  -9,   9,  25,  43,  57,  70,  80,  87,  90},
    { 90,  82,  67,  46,  22,  -4, -31, -54, -73, -85, -90, -88, -78, -61, -38, -13,
      13,  38,  61,  78,  88,  90,  85,  73,  54,  31,   4, -22, -46, -67, -82, -90},
    { 89,  75,  50,  18, -18, -50, -75, -89, -89, -75, -50, -18,  18,  50,  75,  89,
      89,  75,  50,  18, -18, -50, -75, -89, -89, -75, -50, -18,  18,  50,  75,  89},
    { 88,  67,  31, -13, -54, -82, -90, -78, -46,  -4,  38,  73,  90,  85,  61,  22,
     -22, -61, -85, -90, -73, -38,   4,  46,  78,  90,  82,  54,  13, -31, -67, -88},
    { 87,  57,   9, -43, -80, -90, -70, -25,  25,  70,  90,  80,  43,  -9, -57, -87,
     -87, -57,  -9,  43,  80,  90,  70,  25, -25, -70, -90, -80, -43,   9,  57,  87},
    { 85,  46, -13, -67, -90, -73, -22,  38,  82,  88,  54,  -4, -61, -90, -78, -31,
      31,  78,  90,  61,   4, -54, -88, -82, -38,  22,  73,  90,  67,  13, -46, -85},
    { 83,  36, -36, -83, -83, -36,  36,  83,  83,  36, -36, -83, -83, -36,  36,  83,
      83,  36, -36, -83, -83, -36,  36,  83,  83,  36, -36, -83, -83, -36,  36,  83},
    { 82,  22, -54, -90, -61,  13,  78,  85,  31, -46, -90, -67,   4,  73,  88,  38,
     -38, -88, -73,  -4,  67,  90,  46, -31, -85, -78, -13,  61,  90,  54, -22, -82},
    { 80,   9, -70, -87, -25,  57,  90,  43, -43, -90, -57,  25,  87,  70,  -9, -80,
     -80,  -9,  70,  87,  25, -57, -90, -43,  43,  90,  57, -25, -87, -70,   9,  80},
    { 78,  -4, -82, -73,  13,  85,  67, -22, -88, -61,  31,  90,  54, -38, -90, -46,
      46,  90,  38, -54, -90, -31,  61,  88,  22, -67, -85, -13,  73,  82,   4, -78},
    { 75, -18, -89, -50,  50,  89,  18, -75, -75,  18,  89,  50, -50, -89, -18,  75,
      75, -18, -89, -50,  50,  89,  18, -75, -75,  18,  89,  50, -50, -89, -18,  75},
    { 73, -31, -90, -22,  78,  67, -38, -90, -13,  82,  61, -46, -88,  -4,  85,  54,
     -54, -85,   4,  88,  46, -61, -82,  13,  90,  38, -67, -78,  22,  90,  31, -73},
    { 70, -43, -87,   9,  90,  25, -80, -57,  57,  80, -25, -90,  -9,  87,  43, -70,
     -70,  43,  87,  -9, -90, -25,  80,  57, -57, -80,  25,  90,   9, -87, -43,  70},
    { 67, -54, -78,  38,  85, -22, -90,   4,  90,  13, -88, -31,  82,  46, -73, -61,
      61,  73, -46, -82,  31,  88, -13, -90,  -4,  90,  22, -85, -38,  78,  54, -67},
    { 64, -64, -64,  64,  64, -64, -64,  64,  64, -64, -64,  64,  64, -64, -64,  64,
      64, -64, -64,  64,  64, -64, -64,  64,  64, -64, -64,  64,  64, -64, -64,  64},
    { 61, -73, -46,  82,  31, -88, -13,  90,  -4, -90,  22,  85, -38, -78,  54,  67,
     -67, -54,  78,  38, -85, -22,  90,   4, -90,  13,  88, -31, -82,  46,  73, -61},
    { 57, -80, -25,  90,  -9, -87,  43,  70, -70, -43,  87,   9, -90,  25,  80, -57,
     -57,  80,  25, -90,   9,  87, -43, -70,  70,  43, -87,  -9,  90, -25, -80,  57},
    { 54, -85,  -4,  88, -46, -61,  82,  13, -90,  38,  67, -78, -22,  90, -31, -73,
      73,  31, -90,  22,  78, -67, -38,  90, -13, -82,  61,  46, -88,   4,  85, -54},
    { 50, -89,  18,  75, -75, -18,  89, -50, -50,  89, -18, -75,  75,  18, -89,  50,
      50, -89,  18,  75, -75, -18,  89, -50, -50,  89, -18, -75,  75,  18, -89,  50},
    { 46, -90,  38,  54, -90,  31,  61, -88,  22,  67, -85,  13,  73, -82,   4,  78,
     -78,  -4,  82, -73, -13,  85, -67, -22,  88, -61, -31,  90, -54, -38,  90, -46},
    { 43, -90,  57,  25, -87,  70,   9, -80,  80,  -9, -70,  87, -25, -57,  90, -43,
     -43,  90, -57, -25,  87, -70,  -9,  80, -80,   9,  70, -87,  25,  57, -90,  43},
    { 38, -88,  73,  -4, -67,  90, -46, -31,  85, -78,  13,  61, -90,  54,  22, -82,
      82, -22, -54,  90, -61, -13,  78, -85,  31,  46, -90,  67,   4, -73,  88, -38},
    { 36, -83,  83, -36, -36,  83, -83,  36,  36, -83,  83, -36, -36,  83, -83,  36,
      36, -83,  83, -36, -36,  83, -83,  36,  36, -83,  83, -36, -36,  83, -83,  36},
    { 31, -78,  90, -61,   4,  54, -88,  82, -38, -22,  73, -90,  67, -13, -46,  85,
     -85,  46,  13, -67,  90, -73,  22,  38, -82,  88, -54,  -4,  61, -90,  78, -31},
    { 25, -70,  90, -80,  43,   9, -57,  87, -87,  57,  -9, -43,  80, -90,  70, -25,
     -25,  70, -90,  80, -43,  -9,  57, -87,  87, -57,   9,  43, -80,  90, -70,  25},
    { 22, -61,  85, -90,  73, -38,  -4,  46, -78,  90, -82,  54, -13, -31,  67, -88,
      88, -67,  31,  13, -54,  82, -90,  78, -46,   4,  38, -73,  90, -85,  61, -22},
    { 18, -50,  75, -89,  89, -75,  50, -18, -18,  50, -75,  89, -89,  75, -50,  18,
      18, -50,  75, -89,  89, -75,  50, -18, -18,  50, -75,  89, -89,  75, -50,  18},
    { 13, -38,  61, -78,  88, -90,  85, -73,  54, -31,   4,  22, -46,  67, -82,  90,
     -90,  82, -67,  46, -22,  -4,  31, -54,  73, -85,  90, -88,  78, -61,  38, -13},
    {  9, -25,  43, -57,  70, -80,  87, -90,  90, -87,  80, -70,  57, -43,  25,  -9,
      -9,  25, -43,  57, -70,  80, -87,  90, -90,  87, -80,  70, -57,  43, -25,   9},
    {  4, -13,  22, -31,  38, -46,  54, -61,  67, -73,  78, -82,  85, -88,  90, -90,
      90, -90,  88, -85,  82, -78,  73, -67,  61, -54,  46, -38,  31, -22,  13,  -4},
};

// Zigzag tables (common/common_block.c:38-73): row-major index -> scan
// position, for 4x4, 8x8 and 16x16 quantized blocks.
__constant__ unsigned char kZigzag[16 + 64 + 256] = {
      0,   1,   5,   6,   2,   4,   7,  12,   3,   8,  11,  13,   9,  10,  14,  15,
      0,   1,   5,   6,  14,  15,  27,  28,   2,   4,   7,  13,  16,  26,  29,  42,
      3,   8,  12,  17,  25,  30,  41,  43,   9,  11,  18,  24,  31,  40,  44,  53,
     10,  19,  23,  32,  39,  45,  52,  54,  20,  22,  33,  38,  46,  51,  55,  60,
     21,  34,  37,  47,  50,  56,  59,  61,  35,  36,  48,  49,  57,  58,  62,  63,
      0,   1,   5,   6,  14,  15,  27,  28,  44,  45,  65,  66,  90,  91, 119, 120,
      2,   4,   7,  13,  16,  26,  29,  43,  46,  64,  67,  89,  92, 118, 121, 150,
      3,   8,  12,  17,  25,  30,  42,  47,  63,  68,  88,  93, 117, 122, 149, 151,
      9,  11,  18,  24,  31,  41,  48,  62,  69,  87,  94, 116, 123, 148, 152, 177,
     10,  19,  23,  32,  40,  49,  61,  70,  86,  95, 115, 124, 147, 153, 176, 178,
     20,  22,  33,  39,  50,  60,  71,  85,  96, 114, 125, 146, 154, 175, 179, 200,
     21,  34,  38,  51,  59,  72,  84,  97, 113, 126, 145, 155, 174, 180, 199, 201,
     35,  37,  52,  58,  73,  83,  98, 112, 127, 144, 156, 173, 181, 198, 202, 219,
     36,  53,  57,  74,  82,  99, 111, 128, 143, 157, 172, 182, 197, 203, 218, 220,
     54,  56,  75,  81, 100, 110, 129, 142, 158, 171, 183, 196, 204, 217, 221, 234,
     55,  76,  80, 101, 109, 130, 141, 159, 170, 184, 195, 205, 216, 222, 233, 235,
     77,  79, 102, 108, 131, 140, 160, 169, 185, 194, 206, 215, 223, 232, 236, 245,
     78, 103, 107, 132, 139, 161, 168, 186, 193, 207, 214, 224, 231, 237, 244, 246,
    104, 106, 133, 138, 162, 167, 187, 192, 208, 213, 225, 230, 238, 243, 247, 252,
    105, 134, 137, 163, 166, 188, 191, 209, 212, 226, 229, 239, 242, 248, 251, 253,
    135, 136, 164, 165, 189, 190, 210, 211, 227, 228, 240, 241, 249, 250, 254, 255,
};

__device__ __forceinline__ int wrap16(int x) {      // a C int16_t store
  return ((x + 32768) & 65535) - 32768;
}

__device__ __forceinline__ int sat16(int x) {
  return x < -32768 ? -32768 : (x > 32767 ? 32767 : x);
}


// The n-point matrices (rows 0, 32/n, 2*32/n, ... of kTmat32, cut to n
// columns), n = 4, 8, 16, 32, as int8 in shared memory, once as they are
// and once transposed, so that every stage of either transform reads a
// row of each operand: 4 int8 in a word against 2 int16 in a word, two
// __dp2a per 4 products. Rows of 8 and more are padded by a word to an odd
// number of words (no bank conflict down a column).
__host__ __device__ constexpr int mat_off(int nl) {     // n = 1 << nl
  return nl == 2 ? 0 : (nl == 3 ? 16 : (nl == 4 ? 112 : 432));
}
__host__ __device__ constexpr int mat_row(int nl) {     // row stride, bytes
  return nl == 2 ? 4 : (1 << nl) + 4;
}
constexpr int MAT = mat_off(5) + 32 * mat_row(5);       // 1 584 bytes

// A warp runs a unit alone, so nothing hides the latency of a step but
// the steps beside it: the loops over a TU's pixels and the dot products
// are compiled for each mode and each length (by_mode, by_len), which lets
// their iterations overlap. f(Int<v>) for the run-time value v.
template <int V>
using Int = std::integral_constant<int, V>;

template <class F>
__device__ __forceinline__ void by_mode(int mode, F&& f) {  // >= 10: DC
  switch (mode) {
    case 1: f(Int<1>()); break;
    case 2: f(Int<2>()); break;
    case 3: f(Int<3>()); break;
    case 4: f(Int<4>()); break;
    case 5: f(Int<5>()); break;
    case 6: f(Int<6>()); break;
    case 7: f(Int<7>()); break;
    case 8: f(Int<8>()); break;
    case 9: f(Int<9>()); break;
    default: f(Int<0>());
  }
}

template <class F>
__device__ __forceinline__ void by_len(int nl, F&& f) {     // 1 << nl, 2..5
  switch (nl) {
    case 2: f(Int<2>()); break;
    case 3: f(Int<3>()); break;
    case 4: f(Int<4>()); break;
    default: f(Int<5>());
  }
}

template <class F>
__device__ __forceinline__ void by_box(int fl, F&& f) {     // 1 << fl, 0..2
  switch (fl) {
    case 0: f(Int<0>()); break;
    case 1: f(Int<1>()); break;
    default: f(Int<2>());
  }
}

// Two dot products side by side, sum_k a[k] b[k] over k < N (a multiple
// of 4): a int16, b int8, all word-aligned; the second only where `two`.
template <int N>
__device__ __forceinline__ void dot2(const short* a0, const signed char* b0,
                                     const short* a1, const signed char* b1,
                                     bool two, int& c0, int& c1) {
  const int* x0 = reinterpret_cast<const int*>(a0);
  const int* y0 = reinterpret_cast<const int*>(b0);
  const int* x1 = reinterpret_cast<const int*>(a1);
  const int* y1 = reinterpret_cast<const int*>(b1);
  c0 = c1 = 0;
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const int m0 = y0[k];
    c0 = __dp2a_lo(x0[2 * k], m0, c0);
    c0 = __dp2a_hi(x0[2 * k + 1], m0, c0);
    if (two) {
      const int m1 = y1[k];
      c1 = __dp2a_lo(x1[2 * k], m1, c1);
      c1 = __dp2a_hi(x1[2 * k + 1], m1, c1);
    }
  }
}

// One unit's working set in shared memory, a warp's own.
struct Unit {
  Ctx16 c;
  short inb[32 * TS];   // residual, box-summed; later the inverse output
  short tmp[32 * TR];   // first stage of either transform (forward: qs x n
  //                       at stride TS)
  short sco[16 * TR];   // coefficients in scan order; later the dequantized
  //                       16x16 block, transposed
  short q[256];         // levels in scan order
};
static_assert(sizeof(Unit) % 4 == 0, "every unit starts on a word");

constexpr int HEAD = 2 * MAT + 16 + 64 + 256;   // matrices, zigzag tables
constexpr int SMEM = HEAD + WARPS * static_cast<int>(sizeof(Unit));
static_assert(HEAD % 16 == 0, "the units start 16-byte aligned");

__global__ void __launch_bounds__(NT, BLOCKS_PER_SM)
enc_intra_scan_kernel(const int* __restrict__ in, int* out,
                const int* __restrict__ org, int C, int H, int W,
                const int* __restrict__ recs, int nrec,
                const int* __restrict__ count,
                const int* __restrict__ owner, int* ticket,
                short* __restrict__ q16, int scale, int qp6, int fac,
                int dq73, int fast, int intra) {
  extern __shared__ __align__(16) unsigned char smem[];
  signed char* Mn = reinterpret_cast<signed char*>(smem);
  signed char* MnT = Mn + MAT;
  unsigned char* zzs = smem + 2 * MAT;
  Unit& u = reinterpret_cast<Unit*>(smem + HEAD)[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  for (int nl = 2; nl <= 5; ++nl) {
    const int n = 1 << nl, off = mat_off(nl), rs = mat_row(nl);
    for (int o = threadIdx.x; o < n * n; o += NT) {
      const int i = o >> nl, k = o & (n - 1);
      const signed char v = kTmat32[i << (5 - nl)][k];
      Mn[off + i * rs + k] = v;
      MnT[off + k * rs + i] = v;
    }
  }
  for (int o = threadIdx.x; o < 16 + 64 + 256; o += NT) zzs[o] = kZigzag[o];
  __syncthreads();

  const size_t HW = static_cast<size_t>(H) * W;
  if (count != nullptr) nrec = min(nrec, __ldg(count));
  const int units = nrec * C;
  const int off_last_b = intra ? 38 : -26;
  const int off0_b = intra ? 102 : 51, off1_b = intra ? 115 : 90;

  int qt = 0;
  if (lane == 0) qt = atomicAdd(ticket, 1);
  qt = __shfl_sync(ALL, qt, 0);
  while (qt < units) {
    // the next unit's ticket, drawn now and needed after this unit
    int next = 0;
    if (lane == 0) next = atomicAdd(ticket, 1);
    const int t = qt / C, pl = qt - t * C;
    const int* rec = recs + static_cast<size_t>(t) * SCAN_NF;
    const int ty = rec[0], tx = rec[1], s = rec[2], mode = rec[3];
    const int toplen = rec[4], leftlen = rec[5], cbx = rec[6];
    int* P = out + pl * HW;
    const int* O = org + pl * HW + static_cast<size_t>(ty) * W + tx;

    // forward transform geometry (common/transform.c:249-330): sizes
    // above 16 with `fast` box-sum the residual to 16x16, size 64
    // otherwise to 32x32; only the first qs rows of the matrix are used
    const int lg = __ffs(s) - 1;               // s is a power of two
    int shift1 = lg, shift2 = lg + 5, fl = 0;  // fl: log2 of the box
    if (s > 16 && fast) {
      shift1 += 1 + (s == 64);
      shift2 = 9;
      fl = lg - 4;
    } else if (s == 64) {
      shift1 = 7;
      shift2 = 10;
      fl = 1;
    }
    const int nl = lg - fl, n = 1 << nl;       // transform length
    const int ql = min(lg, 4), qs = 1 << ql, Nc = qs * qs;
    const signed char* Mf = Mn + mat_off(nl);  // the n-point matrix
    const int rf = mat_row(nl);

    // (0) the original, box-summed to n x n (at most 16 * 255 a sum): it
    // does not wait for the neighbours, so its loads are issued before
    // the context is
    by_box(fl, [&](auto FL) {
      constexpr int B = 1 << decltype(FL)::value;
#pragma unroll 4
      for (int o = lane; o < n * n; o += 32) {
        const int r = o >> nl, cc = o & (n - 1);
        const int* src = O + static_cast<size_t>(r * B) * W + cc * B;
        int sum = 0;
#pragma unroll
        for (int dy = 0; dy < B; ++dy)
#pragma unroll
          for (int dx = 0; dx < B; ++dx)
            sum += __ldg(src + static_cast<size_t>(dy) * W + dx);
        u.inb[r * TS + cc] = static_cast<short>(sum);
      }
    });

    // (1), (2) context samples, filtered context, top-left, DC value
    const ScanSamples at{in + pl * HW, P, owner, H, W, (W + 3) >> 2, t};
    load_context_warp(u.c, at, lane, ty, tx, s, mode, toplen, leftlen, cbx);

    // (3) residual: the prediction's box sums taken off the original's
    by_mode(mode, [&](auto MD) {
      by_box(fl, [&](auto FL) {
        constexpr int md = decltype(MD)::value, B = 1 << decltype(FL)::value;
#pragma unroll 4
        for (int o = lane; o < n * n; o += 32) {
          const int r = o >> nl, cc = o & (n - 1);
          int sum = 0;
#pragma unroll
          for (int dy = 0; dy < B; ++dy)
#pragma unroll
            for (int dx = 0; dx < B; ++dx)
              sum += predict(u.c, s, md, r * B + dy, cc * B + dx);
          u.inb[r * TS + cc] = static_cast<short>(u.inb[r * TS + cc] - sum);
        }
      });
    });
    __syncwarp();

    // (4) tmp[i][j] = wrap16((sum_k M[i][k] in[j][k] + add1) >> shift1)
    // a lane takes outputs o and o + 32: rows i and i + 32 / n, column j
    const unsigned char* zz = zzs + (qs == 4 ? 0 : (qs == 8 ? 16 : 80));
    by_len(nl, [&](auto NL) {
      constexpr int N = 1 << decltype(NL)::value;
      for (int o = lane; o < qs * N; o += 64) {
        const int i = o / N, j = o & (N - 1), i1 = (o + 32) / N;
        const bool two = o + 32 < qs * N;
        int a0, a1;
        dot2<N>(u.inb + j * TS, Mf + i * rf, u.inb + j * TS, Mf + i1 * rf,
                two, a0, a1);
        u.tmp[i * TS + j] =
            static_cast<short>(wrap16((a0 + (1 << (shift1 - 1))) >> shift1));
        if (two)
          u.tmp[i1 * TS + j] = static_cast<short>(
              wrap16((a1 + (1 << (shift1 - 1))) >> shift1));
      }
      __syncwarp();

      // (5) coeff[i][j] = wrap16((sum_k M[i][k] tmp[j][k] + add2) >>
      // shift2), stored at its scan position
      for (int o = lane; o < Nc; o += 64) {
        const int i = o >> ql, j = o & (qs - 1), i1 = (o + 32) >> ql;
        const bool two = o + 32 < Nc;
        int a0, a1;
        dot2<N>(u.tmp + j * TS, Mf + i * rf, u.tmp + j * TS, Mf + i1 * rf,
                two, a0, a1);
        u.sco[zz[o]] =
            static_cast<short>(wrap16((a0 + (1 << (shift2 - 1))) >> shift2));
        if (two)
          u.sco[zz[o + 32]] = static_cast<short>(
              wrap16((a1 + (1 << (shift2 - 1))) >> shift2));
      }
    });
    __syncwarp();

    // (6) quantize (enc/encode_block.c:75-133), a lane per position
    const int sh2 = 21 - lg + qp6;
    int last = -1;
    for (int k = lane; k < Nc; k += 32) {
      const int absc = scale * abs(static_cast<int>(u.sco[k]));
      if ((abs(absc + off_last_b * (1 << (sh2 - 8))) >> sh2) != 0) last = k;
    }
    last = __reduce_max_sync(ALL, last);
    bool nz = false;
    for (int k = lane; k < Nc; k += 32) {
      const int v = u.sco[k], absc = scale * abs(v);
      const int off =
          ((absc >> sh2) == 0 ? off0_b : off1_b) * (1 << (sh2 - 8));
      const int level = (absc + off) >> sh2;
      const int q0 = k <= last ? (v < 0 ? -level : level) : 0;
      u.q[k] = static_cast<short>(q0);
      nz |= q0 != 0;
    }
    const bool cbp = __any_sync(ALL, nz);

    // (7) zero-run pass (enc/encode_block.c:134-168). Position p fires
    // when its level is above 1 after two zero levels, unless the level 3
    // back is above 1, or the level 4 back is above 1 and the one 3 back
    // nonzero; positions 0..2 never fire. The smallest raw coefficient of
    // p, p-1, p-2 decides which level becomes +-1.
    if (cbp) {
      const int thr = (dq73 << qp6) >> (4 + lg);
      int cursor = 3;
      while (cursor <= last) {
        const int p = cursor + lane;
        bool act = false;
        if (p <= last)
          act = abs(u.q[p]) > 1 && u.q[p - 1] == 0 && u.q[p - 2] == 0
                && !(abs(u.q[p - 3]) > 1)
                && !(p > 3 && abs(u.q[p - 4]) > 1 && u.q[p - 3] != 0);
        const unsigned m = __ballot_sync(ALL, act);
        if (m == 0) {
          cursor += 32;
          continue;
        }
        const int l = __ffs(m) - 1;
        if (lane == l) {
          const int c0 = abs(u.sco[p]), c1 = abs(u.sco[p - 1]);
          const int c2 = abs(u.sco[p - 2]);
          const int tgt = c0 + max(c1, c2) < thr ? p
                                                 : (c1 > c2 ? p - 1 : p - 2);
          u.q[tgt] = u.sco[tgt] < 0 ? -1 : 1;
        }
        __syncwarp();
        cursor += l + 1;
      }
    }
    __syncwarp();

    // (8) the TU's bank, and the dequantized levels in block layout
    // (common/common_block.c:132-146), transposed, over the scan vector;
    // both zero outside qs x qs
    const int rsh = lg - 1;
    for (int k = lane; k < 256; k += 32) {
      const int i = k >> 4, j = k & 15;
      const int lvl = (i < qs && j < qs) ? u.q[zz[(i << ql) + j]] : 0;
      q16[(static_cast<size_t>(t) * C + pl) * 256 + k] =
          static_cast<short>(lvl);
      u.sco[j * TR + i] = static_cast<short>(
          sat16((lvl * fac + (1 << (rsh - 1))) >> rsh));
    }

    // (9) inverse transform (common/transform.c:432-486); a 64x64 TU
    // inverts its low 32x32 and repeats every sample 2x2. All-zero levels
    // give an all-zero residual, so the transform is skipped then.
    const int ml = min(lg, 5), m = 1 << ml;
    if (cbp) {
      const signed char* MT = MnT + mat_off(ml);   // the m-point matrix,
      const int rt = mat_row(ml);                  // transposed
      __syncwarp();
      // tmp[i][j] = sat16((sum_k M[k][i] rc[k][j] + 64) >> 7), k < qs
      by_len(ql, [&](auto QL) {
        constexpr int Q = 1 << decltype(QL)::value;
        for (int o = lane; o < m * Q; o += 64) {
          const int i = o / Q, j = o & (Q - 1), i1 = (o + 32) / Q;
          const bool two = o + 32 < m * Q;
          int a0, a1;
          dot2<Q>(u.sco + j * TR, MT + i * rt, u.sco + j * TR, MT + i1 * rt,
                  two, a0, a1);
          u.tmp[i * TR + j] = static_cast<short>(sat16((a0 + 64) >> 7));
          if (two)
            u.tmp[i1 * TR + j] = static_cast<short>(sat16((a1 + 64) >> 7));
        }
        __syncwarp();
        // out[i][j] = sat16((sum_k tmp[i][k] M[k][j] + 2048) >> 12)
        for (int o = lane; o < m * m; o += 64) {
          const int i = o >> ml, j = o & (m - 1), i1 = (o + 32) >> ml;
          const bool two = o + 32 < m * m;
          int a0, a1;
          dot2<Q>(u.tmp + i * TR, MT + j * rt, u.tmp + i1 * TR, MT + j * rt,
                  two, a0, a1);
          u.inb[i * TS + j] = static_cast<short>(sat16((a0 + 2048) >> 12));
          if (two)
            u.inb[i1 * TS + j] = static_cast<short>(sat16((a1 + 2048) >> 12));
        }
      });
      __syncwarp();
    }

    // (10) reconstruct, clip, store: each pixel, once written, releases
    // the units that read it. Four pixels a lane are computed before any
    // is stored (a store is a compiler barrier for shared-memory loads).
    const int e = lg - ml;                     // 1 for a 64x64 TU
    by_mode(mode, [&](auto MD) {
      constexpr int md = decltype(MD)::value;
      for (int p0 = lane; p0 < s * s; p0 += 128) {
        int v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = p0 + 32 * k, i = p >> lg, j = p & (s - 1);
          const int r =
              cbp && p < s * s ? u.inb[(i >> e) * TS + (j >> e)] : 0;
          v[k] = p < s * s ? clip255(predict(u.c, s, md, i, j) + r) : 0;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = p0 + 32 * k;
          if (p < s * s)
            st_pixel(P + static_cast<size_t>(ty + (p >> lg)) * W + tx
                         + (p & (s - 1)),
                     v[k]);
        }
      }
    });
    __syncwarp();                // the unit's buffers may be reused
    qt = __shfl_sync(ALL, next, 0);
  }
}

// The kernel's shared memory is above the 48 KB a launch gets without
// asking: raised once per device, by the first launch (before any
// CUDA-graph capture of it).
int allow_smem() {
  static bool done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(enc_intra_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

}  // namespace

// planes/org: [C, H, W] int32, read only; out: [C, H, W] int32, a copy of
// planes that the scan updates in place; recs: [nrec, 7] int32 TU records
// in coding order, every TU inside the plane, ty, tx and size multiples of
// 4, no two TUs overlapping; count: null (all nrec records are real), or
// one int32 on the device, the number of real records at the head of recs
// (a frame's records padded to a bucket: the grid and the scratch follow
// nrec, the work follows *count, so a CUDA graph captured for the bucket
// serves every count in it; the padded records never run and their rows
// of q16 are left as they were); scratch: int32, uninitialised, 1 +
// ceil(H/4) ceil(W/4) elements (ops/enc_intra.py: scan_scratch); q16:
// [nrec, C, 16, 16] int16, written for every real record. scale =
// gquant[qp % 6], qp6 = qp / 6, fac = gdequant[qp % 6] << qp6, dq73 = 73 *
// gdequant[qp % 6]. Launches its three kernels on `stream`; returns
// cudaGetLastError().
extern "C" int thor_enc_intra_scan_count(const void* planes, void* out,
                                         const void* org, int C, int H,
                                         int W, const void* recs, int nrec,
                                         const void* count, void* scratch,
                                         void* q16, int scale, int qp6,
                                         int fac, int dq73, int fast,
                                         int intra, void* stream) {
  if (nrec <= 0) return 0;
  int err = allow_smem();
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* cnt = static_cast<const int*>(count);
  int* ticket = static_cast<int*>(scratch);
  int* owner = ticket + 1;
  const int* rc = static_cast<const int*>(recs);
  scan_prologue(rc, nrec, ticket, owner, static_cast<int*>(out), C, H, W, s,
                cnt);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const int resident = sm_count() * BLOCKS_PER_SM;
  const int wanted = (nrec * C + WARPS - 1) / WARPS;
  const int grid = wanted < resident ? wanted : resident;
  enc_intra_scan_kernel<<<grid, NT, SMEM, s>>>(
      static_cast<const int*>(planes), static_cast<int*>(out),
      static_cast<const int*>(org), C, H, W, rc, nrec, cnt, owner, ticket,
      static_cast<short*>(q16), scale, qp6, fac, dq73, fast, intra);
  return static_cast<int>(cudaGetLastError());
}

// The same with every record real (the entry point of the builds before
// the count; tools/ab_kernel.py calls it on either build).
extern "C" int thor_enc_intra_scan(const void* planes, void* out,
                                   const void* org, int C, int H, int W,
                                   const void* recs, int nrec, void* scratch,
                                   void* q16, int scale, int qp6, int fac,
                                   int dq73, int fast, int intra,
                                   void* stream) {
  return thor_enc_intra_scan_count(planes, out, org, C, H, W, recs, nrec,
                                   nullptr, scratch, q16, scale, qp6, fac,
                                   dq73, fast, intra, stream);
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
