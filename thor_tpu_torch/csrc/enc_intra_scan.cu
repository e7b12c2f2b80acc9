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
// Design. The TUs form a chain (each TU's context reads the
// reconstruction of earlier ones), so one CUDA block walks the whole record
// list of one plane (gridDim.x = C: 1 for luma, 2 for U and V, which share
// TU geometry), as the decoder's scan does; context and prediction are the
// decoder's code (intra_predict.cuh). Everything of a TU lives in shared
// memory (24 KB): the prediction tile, the (box-summed) residual, both
// transform stages as integer dot products a thread computes for its own
// outputs, the scan vector, the levels. The transform matrix and the
// zigzag tables are copied from constant to shared memory once, since
// lanes read different entries. Quantization runs one thread per scan
// position; the last significant position is an atomicMax in shared
// memory. The zero-run pass is sequential by nature (a change at p alters
// the tests at p+1..p+4): warp 0 tests 32 positions at a time under the
// current levels, a ballot finds the first position that fires, one lane
// applies its change and the window restarts behind it, so the pass costs
// (positions / 32 + changes) steps, not one step per position. A TU whose
// levels are all zero skips the inverse transform. What the TPU kernel
// needed and this one does not: a transposed plane copy and aligned
// window rolls, the split of int16 operands into bytes for exact f32
// matrix products, one-hot matrix products for zigzag, fold, embed and
// blend, chunked records with a valid flag.
//
// Bound. Bytes: the original read once, the plane written once (int32
// both), 512 B of bank per TU and plane. Operations: the four matrix
// stages, 2 * (qs*n*n + qs*qs*n) forward and 2 * (m*qs*qs + m*m*qs)
// inverse per TU (qs = min(s, 16)). Neither is what it takes: a TU pays
// about a dozen barriers and two dependent L2 round trips, and one SM of
// 132 does the work, so the time is (number of TUs) x (per-TU latency). A
// wavefront over independent TUs is later work, as for the decoder's scan.

#include "intra_predict.cuh"

namespace {

using namespace thor;

constexpr int NF = 7;       // ty, tx, size, mode, toplen, leftlen, cbx
constexpr int NT = 256;     // threads per block
constexpr int TS = 33;      // row stride of the 32-wide shared tiles: a
//                             walk down a column hits 32 different banks

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

__global__ void __launch_bounds__(NT)
enc_intra_scan_kernel(int* __restrict__ planes, const int* __restrict__ org,
                      int H, int W, const int* __restrict__ recs, int nrec,
                      short* __restrict__ q16, int scale, int qp6, int fac,
                      int dq73, int fast, int intra) {
  __shared__ Ctx c;
  __shared__ unsigned char pred[64 * 64];
  __shared__ int inb[32 * TS];   // folded residual; later the inverse output
  __shared__ int tmp[32 * TS];   // first stage of either transform
  __shared__ int M[32 * TS];     // kTmat32
  __shared__ int sco[256];       // coefficients in scan order
  __shared__ int q[256];         // levels in scan order
  __shared__ int rc[256];        // dequantized levels, 16x16 block layout
  __shared__ unsigned char zzs[16 + 64 + 256];
  __shared__ int s_last;

  const size_t HW = static_cast<size_t>(H) * W;
  const int C = gridDim.x, pl = blockIdx.x;
  int* P = planes + pl * HW;
  const int* O = org + pl * HW;
  const int k = threadIdx.x;

  for (int o = k; o < 32 * 32; o += NT)
    M[(o >> 5) * TS + (o & 31)] = kTmat32[o >> 5][o & 31];
  for (int o = k; o < 16 + 64 + 256; o += NT) zzs[o] = kZigzag[o];
  __syncthreads();

  const int off_last_b = intra ? 38 : -26;
  const int off0_b = intra ? 102 : 51, off1_b = intra ? 115 : 90;

  for (int t = 0; t < nrec; ++t) {
    const int* rec = recs + static_cast<size_t>(t) * NF;
    const int ty = rec[0], tx = rec[1], s = rec[2], mode = rec[3];
    const int toplen = rec[4], leftlen = rec[5], cbx = rec[6];

    // (1), (2) context, as in the decoder's scan
    load_context(c, P, H, W, ty, tx, s, toplen, leftlen, cbx);

    // (3) prediction tile
    const int lg = __ffs(s) - 1;               // s is a power of two
    for (int p = k; p < s * s; p += NT)
      pred[p] = static_cast<unsigned char>(
          predict(c, s, mode, p >> lg, p & (s - 1)));

    // forward transform geometry (common/transform.c:249-330): sizes
    // above 16 with `fast` box-sum the residual to 16x16, size 64
    // otherwise to 32x32; only the first qs rows of the matrix are used
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
    const int stf = 32 >> nl;                  // row step in M, forward
    __syncthreads();

    // (4) residual against the original, box-summed
    for (int o = k; o < n * n; o += NT) {
      const int r = o >> nl, cc = o & (n - 1);
      int sum = 0;
      for (int dy = 0; dy < (1 << fl); ++dy)
        for (int dx = 0; dx < (1 << fl); ++dx) {
          const int y = (r << fl) + dy, x = (cc << fl) + dx;
          sum += O[static_cast<size_t>(ty + y) * W + tx + x]
                 - pred[(y << lg) + x];
        }
      inb[r * TS + cc] = sum;
    }
    __syncthreads();

    // (5) tmp[i][j] = wrap16((sum_k M[i][k] in[j][k] + add1) >> shift1)
    for (int o = k; o < qs * n; o += NT) {
      const int i = o >> nl, j = o & (n - 1);
      const int* mr = M + i * stf * TS;
      const int* xr = inb + j * TS;
      int acc = 0;
      for (int kk = 0; kk < n; ++kk) acc += mr[kk] * xr[kk];
      tmp[i * TS + j] = wrap16((acc + (1 << (shift1 - 1))) >> shift1);
    }
    __syncthreads();

    // (6) coeff[i][j] = wrap16((sum_k M[i][k] tmp[j][k] + add2) >> shift2),
    // stored at its scan position
    const unsigned char* zz = zzs + (qs == 4 ? 0 : (qs == 8 ? 16 : 80));
    if (k < Nc) {
      const int i = k >> ql, j = k & (qs - 1);
      const int* mr = M + i * stf * TS;
      const int* xr = tmp + j * TS;
      int acc = 0;
      for (int kk = 0; kk < n; ++kk) acc += mr[kk] * xr[kk];
      sco[zz[k]] = wrap16((acc + (1 << (shift2 - 1))) >> shift2);
    }
    if (k == 0) s_last = -1;
    __syncthreads();

    // (7) quantize (enc/encode_block.c:75-133), a thread per position
    const int sh2 = 21 - lg + qp6;
    int v = 0, absc = 0;
    if (k < Nc) {
      v = sco[k];
      absc = scale * abs(v);
      if ((abs(absc + off_last_b * (1 << (sh2 - 8))) >> sh2) != 0)
        atomicMax(&s_last, k);
    }
    __syncthreads();
    const int last = s_last;
    int q0 = 0;
    if (k < Nc) {
      const int off =
          ((absc >> sh2) == 0 ? off0_b : off1_b) * (1 << (sh2 - 8));
      const int level = (absc + off) >> sh2;
      q0 = k <= last ? (v < 0 ? -level : level) : 0;
      q[k] = q0;
    }
    const int cbp = __syncthreads_or(q0 != 0);

    // (8) zero-run pass (enc/encode_block.c:134-168), warp 0. Position p
    // fires when its level is above 1 after two zero levels, unless the
    // level 3 back is above 1, or the level 4 back is above 1 and the one
    // 3 back nonzero; positions 0..2 never fire. The smallest raw
    // coefficient of p, p-1, p-2 decides which level becomes +-1.
    if (cbp && k < 32) {
      const int thr = (dq73 << qp6) >> (4 + lg);
      int cursor = 3;
      while (cursor <= last) {
        const int p = cursor + k;
        bool act = false;
        if (p <= last)
          act = abs(q[p]) > 1 && q[p - 1] == 0 && q[p - 2] == 0
                && !(abs(q[p - 3]) > 1)
                && !(p > 3 && abs(q[p - 4]) > 1 && q[p - 3] != 0);
        const unsigned m = __ballot_sync(0xffffffffu, act);
        if (m == 0) {
          cursor += 32;
          continue;
        }
        const int l = __ffs(m) - 1;
        if (k == l) {
          const int c0 = abs(sco[p]), c1 = abs(sco[p - 1]);
          const int c2 = abs(sco[p - 2]);
          const int tgt = c0 + max(c1, c2) < thr ? p
                                                 : (c1 > c2 ? p - 1 : p - 2);
          q[tgt] = sco[tgt] < 0 ? -1 : 1;
        }
        __syncwarp();
        cursor += l + 1;
      }
    }
    __syncthreads();

    // (9) the TU's bank, and the dequantized levels in block layout
    // (common/common_block.c:132-146); both zero outside qs x qs
    {
      const int i = k >> 4, j = k & 15;
      const int lvl = (i < qs && j < qs) ? q[zz[(i << ql) + j]] : 0;
      q16[(static_cast<size_t>(t) * C + pl) * 256 + k] =
          static_cast<short>(lvl);
      const int rsh = lg - 1;
      rc[k] = sat16((lvl * fac + (1 << (rsh - 1))) >> rsh);
    }

    // (10) inverse transform (common/transform.c:432-486); a 64x64 TU
    // inverts its low 32x32 and repeats every sample 2x2. All-zero levels
    // give an all-zero residual, so the transform is skipped then.
    const int ml = min(lg, 5), m = 1 << ml;
    if (cbp) {
      const int sti = 32 >> ml;                // row step in M, inverse
      __syncthreads();
      // tmp[i][j] = sat16((sum_k M[k][i] rc[k][j] + 64) >> 7)
      for (int o = k; o < m * qs; o += NT) {
        const int i = o >> ql, j = o & (qs - 1);
        int acc = 0;
        for (int kk = 0; kk < qs; ++kk)
          acc += M[kk * sti * TS + i] * rc[(kk << 4) + j];
        tmp[i * TS + j] = sat16((acc + 64) >> 7);
      }
      __syncthreads();
      // out[i][j] = sat16((sum_k tmp[i][k] M[k][j] + 2048) >> 12)
      for (int o = k; o < m * m; o += NT) {
        const int i = o >> ml, j = o & (m - 1);
        int acc = 0;
        for (int kk = 0; kk < qs; ++kk)
          acc += tmp[i * TS + kk] * M[kk * sti * TS + j];
        inb[i * TS + j] = sat16((acc + 2048) >> 12);
      }
      __syncthreads();
    }

    // (11) reconstruct, clip, store
    const int e = lg - ml;                     // 1 for a 64x64 TU
    for (int p = k; p < s * s; p += NT) {
      const int i = p >> lg, j = p & (s - 1);
      const int r = cbp ? inb[(i >> e) * TS + (j >> e)] : 0;
      P[static_cast<size_t>(ty + i) * W + tx + j] = clip255(pred[p] + r);
    }
    // (12) stores visible before the next TU reads its context
    __syncthreads();
  }
}

}  // namespace

// planes/org: [C, H, W] int32 (planes updated in place); recs: [nrec, 7]
// int32 TU records in coding order, every TU inside the plane; q16:
// [nrec, C, 16, 16] int16, written whole. scale = gquant[qp % 6], qp6 =
// qp / 6, fac = gdequant[qp % 6] << qp6, dq73 = 73 * gdequant[qp % 6].
// Launches on `stream`; returns cudaGetLastError().
extern "C" int thor_enc_intra_scan(void* planes, const void* org, int C,
                                   int H, int W, const void* recs, int nrec,
                                   void* q16, int scale, int qp6, int fac,
                                   int dq73, int fast, int intra,
                                   void* stream) {
  if (nrec <= 0) return 0;
  enc_intra_scan_kernel<<<C, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(planes), static_cast<const int*>(org), H, W,
      static_cast<const int*>(recs), nrec, static_cast<short*>(q16), scale,
      qp6, fac, dq73, fast, intra);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
