// The motion search's quarter-pel step for the Thor device encoder,
// hand-written for Hopper (sm_90a).
//
// No TPU kernel of its own: thor_tpu runs the step as XLA ops
// (thor_tpu/enc/device_me.py:_subpel_step), and the port's plain version
// (ops/me_subpel._subpel) materializes, per phase, the tap products of
// every block's window ([HB, WB, 6, 6, b+2, b+2] int32) and sums them:
// some 47 GB written and read back for a 1080p P frame with two
// references. This kernel keeps each block's window in shared memory and
// its phase samples and 49 SADs in registers.
//
// The step, per reference and b x b block (t, k) at full-pel (mvy, mvx):
// the window whose top-left sample is (base + t*b + mvy, base + k*b + mvx)
// in the padded reference (base = PAD - 3; samples below or right of the
// plane read 0). Phase p = 4 vf + hf at window position (y, x) is
// clamp((sum_{m,n < 6} lut[p][m][n] * win[y+m][x+n] + 2048) >> 12, 0, 255)
// in int32. Candidate (qy, qx), each -3..3, predicts pixel (i, j) of the
// block from phase (qy & 3, qx & 3) at (i + 1 + (qy >> 2), j + 1 +
// (qx >> 2)), so the candidates read positions 0 <= y, x <= b and the
// window is (b+6)^2. A candidate's cost is its SAD plus
// (lam_me * bits + 0.5) truncated, bits the quote_vlc(10) lengths of the
// quarter-pel MV minus the predictor (py, px), rounded in float32 after
// the product and after the sum (__fmul_rn, __fadd_rn: a contracted FMA
// rounds once and the search diverges). The first candidate of least
// cost in (qy, qx) row-major order wins, as torch.argmin.
//
// Design. A group of G threads takes one block (G = 32 at b = 8 and 16,
// 128 at 32, 256 at 64); a CTA of 256 threads holds 256 / G blocks, and
// one launch covers every reference. The group loads the block's window
// and samples into shared memory. Each thread then walks positions (y, x)
// of the (b+1)^2: per position it reads the 6 x 6 neighbourhood once, row
// by row, and accumulates all 16 phases' tap sums (the LUT is a kernel
// parameter, so each tap is an integer multiply-add with a constant
// operand); then, for each candidate that reads that phase sample at that
// position (1 to 4 a phase, 49 over the 16), it adds |o - s| into one of
// 49 per-thread sums. A warp reduces the sums by halving (lane l ends
// with candidate l and 32 + l), the group's warps through shared memory,
// and the group's first warp adds the rates and takes the first least
// cost with shuffles.
//
// Bound. Bytes: the windows' reference samples, the blocks' samples, the
// MVs, predictors and outputs, each once (~45 MB for a 1080p P frame with
// two references). Operations: 16 x 36 multiply-adds a position, (b+1)^2
// positions a block, about 11 G for that frame: the operations bound it.

#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int NT = 256;
constexpr int NC = 49;                     // 7 x 7 candidates
constexpr unsigned ALL = 0xffffffffu;

struct Lut {
  int v[16][36];                           // [phase][6 m + n]
};

__device__ __forceinline__ int comp_bits(int d) {
  // quote_vlc(10, 2|d| - (d < 0)): 1 + 2 floor(log2(cn + 1))
  const int cn = 2 * abs(d) - (d < 0 ? 1 : 0);
  return 1 + 2 * (31 - __clz(cn + 1));
}

// v[0..31] per lane -> v[0] = the warp's sum of element `lane`.
__device__ __forceinline__ int halve32(int (&v)[32], int lane) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = 16 >> k;
    const bool hi = lane & s;
#pragma unroll
    for (int i = 0; i < s; ++i) {
      const int send = hi ? v[i] : v[i + s];
      const int keep = hi ? v[i + s] : v[i];
      v[i] = keep + __shfl_xor_sync(ALL, send, s);
    }
  }
  return v[0];
}

template <int B, int G>
__global__ void __launch_bounds__(NT, 2)
me_subpel_kernel(const unsigned char* __restrict__ ref, int Hp, int Wp,
                 const int* __restrict__ ob, long long st, long long sk,
                 long long si, long long sj, const int* __restrict__ mvy,
                 const int* __restrict__ mvx, const int* __restrict__ py,
                 const int* __restrict__ px, const float* __restrict__ lam,
                 int R, int HB, int WB, int base, int* __restrict__ out,
                 const Lut lut) {
  constexpr int BPC = NT / G;              // blocks a CTA
  constexpr int WPG = G / 32;              // warps a block
  constexpr int W6 = B + 6;
  constexpr int NP = (B + 1) * (B + 1);    // positions the candidates read
  __shared__ int win[BPC][W6 * W6];
  __shared__ int org[BPC][B * B];
  __shared__ int red[NT / 32][64];

  const int g = threadIdx.x / G, lt = threadIdx.x % G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long total = static_cast<long long>(R) * HB * WB;
  const long long gb = static_cast<long long>(blockIdx.x) * BPC + g;
  const bool valid = gb < total;
  int r = 0, t = 0, k = 0, my = 0, mx = 0;
  if (valid) {
    r = static_cast<int>(gb / (static_cast<long long>(HB) * WB));
    const int rem = static_cast<int>(gb - static_cast<long long>(r) * HB * WB);
    t = rem / WB;
    k = rem - t * WB;
    my = __ldg(mvy + gb);
    mx = __ldg(mvx + gb);
  }
  const int y0 = base + t * B + my, x0 = base + k * B + mx;
  const unsigned char* rp = ref + static_cast<size_t>(r) * Hp * Wp;
  for (int i = lt; i < W6 * W6; i += G) {
    const int yy = y0 + i / W6, xx = x0 + i % W6;
    const bool in = valid && yy >= 0 && yy < Hp && xx >= 0 && xx < Wp;
    win[g][i] = in ? __ldg(rp + static_cast<size_t>(yy) * Wp + xx) : 0;
  }
  const int* op = ob + t * st + k * sk;
  for (int i = lt; i < B * B; i += G)
    org[g][i] = valid ? __ldg(op + (i / B) * si + (i % B) * sj) : 0;
  __syncthreads();

  int acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0;
  const int* w0 = win[g];
  const int* o = org[g];
#pragma unroll 1
  for (int pos = lt; pos < NP; pos += G) {
    const int y = pos / (B + 1), x = pos - y * (B + 1);
    int ph[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) ph[p] = 0;
    const int* wr = w0 + y * W6 + x;
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      int a[6];
#pragma unroll
      for (int n = 0; n < 6; ++n) a[n] = wr[m * W6 + n];
#pragma unroll
      for (int p = 0; p < 16; ++p)
#pragma unroll
        for (int n = 0; n < 6; ++n) ph[p] += lut.v[p][m * 6 + n] * a[n];
    }
    // the block's sample that window position (y, x) meets at the
    // offsets (oy, ox): pixel (y - oy, x - ox), inside the block or not
    const bool vy[2] = {y < B, y >= 1}, vx[2] = {x < B, x >= 1};
    const int yo[2] = {min(y, B - 1), max(y - 1, 0)};
    const int xo[2] = {min(x, B - 1), max(x - 1, 0)};
    int ov[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) ov[a][b] = o[yo[a] * B + xo[b]];
#pragma unroll
    for (int vf = 0; vf < 4; ++vf)
#pragma unroll
      for (int hf = 0; hf < 4; ++hf) {
        const int s = min(max((ph[vf * 4 + hf] + 2048) >> 12, 0), 255);
#pragma unroll
        for (int a = 0; a < 2; ++a) {      // a = oy: qy = vf - 4 or vf
          const int qy = a ? vf : vf - 4;
          if (qy < -3) continue;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int qx = b ? hf : hf - 4;
            if (qx < -3) continue;
            const int c = (qy + 3) * 7 + (qx + 3);
            acc[c] += (vy[a] && vx[b]) ? abs(ov[a][b] - s) : 0;
          }
        }
      }
  }

  // lane l: the warp's sums of candidates l and 32 + l
  int v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = acc[i];
  int sad0 = halve32(v, lane);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    v[i] = 32 + i < NC ? acc[min(32 + i, NC - 1)] : 0;
  int sad1 = halve32(v, lane);
  if (WPG > 1) {
    red[warp][lane] = sad0;
    red[warp][32 + lane] = sad1;
    __syncthreads();
    if (lt < 32) {
      sad0 = sad1 = 0;
#pragma unroll
      for (int w = 0; w < WPG; ++w) {
        sad0 += red[g * WPG + w][lane];
        sad1 += red[g * WPG + w][32 + lane];
      }
    }
  }
  if (lt >= 32 || !valid) return;          // the group's first warp, whole

  const float lm = __ldg(lam);
  const int hb = t * WB + k;
  const int cy = 4 * my, cx = 4 * mx;
  const int pyv = __ldg(py + hb), pxv = __ldg(px + hb);
  auto cost_of = [&](int c, int sad) {
    const int qy = c / 7 - 3, qx = c % 7 - 3;
    const int bits = comp_bits(cx + qx - pxv) + comp_bits(cy + qy - pyv);
    return sad + static_cast<int>(
        __fadd_rn(__fmul_rn(lm, static_cast<float>(bits)), 0.5f));
  };
  int best = cost_of(lane, sad0), bi = lane;
  if (32 + lane < NC) {
    const int c1 = cost_of(32 + lane, sad1);
    if (c1 < best) {
      best = c1;
      bi = 32 + lane;
    }
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    const int ob2 = __shfl_xor_sync(ALL, best, s);
    const int oi = __shfl_xor_sync(ALL, bi, s);
    if (ob2 < best || (ob2 == best && oi < bi)) {
      best = ob2;
      bi = oi;
    }
  }
  if (lane == 0) {
    out[gb] = cy + bi / 7 - 3;
    out[total + gb] = cx + bi % 7 - 3;
    out[2 * total + gb] = best;
  }
}

template <int B, int G>
int launch(const void* ref, int R, int Hp, int Wp, const void* ob,
           long long st, long long sk, long long si, long long sj,
           const void* mvy, const void* mvx, const void* py, const void* px,
           const void* lam, int HB, int WB, int base, const Lut& lut,
           void* out, cudaStream_t s) {
  const long long total = static_cast<long long>(R) * HB * WB;
  const long long grid = (total + NT / G - 1) / (NT / G);
  me_subpel_kernel<B, G><<<static_cast<unsigned>(grid), NT, 0, s>>>(
      static_cast<const unsigned char*>(ref), Hp, Wp,
      static_cast<const int*>(ob), st, sk, si, sj,
      static_cast<const int*>(mvy), static_cast<const int*>(mvx),
      static_cast<const int*>(py), static_cast<const int*>(px),
      static_cast<const float*>(lam), R, HB, WB, base,
      static_cast<int*>(out), lut);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ref: [R, Hp, Wp] uint8 padded references; ob: the blocks' samples, int32,
// block (t, k) pixel (i, j) at ob + t*st + k*sk + i*si + j*sj; mvy, mvx:
// [R, HB, WB] int32 full-pel MVs; py, px: [HB, WB] int32 quarter-pel
// predictors; lam: one float32 (lam_me) on the card; base: PAD - 3; lut:
// [16, 6, 6] int32 on the host (copied into the launch); out: [3, R, HB,
// WB] int32, the quarter-pel (mvy, mvx) and cost. b is 8, 16, 32 or 64.
// Launches one kernel on `stream`; returns cudaGetLastError().
extern "C" int thor_me_subpel(const void* ref, int R, int Hp, int Wp,
                              const void* ob, long long st, long long sk,
                              long long si, long long sj, const void* mvy,
                              const void* mvx, const void* py, const void* px,
                              const void* lam, int HB, int WB, int b, int base,
                              const int* lut, void* out, void* stream) {
  if (R <= 0 || HB <= 0 || WB <= 0) return 0;
  Lut L;
  std::memcpy(L.v, lut, sizeof L.v);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (b) {
    case 8:
      return launch<8, 32>(ref, R, Hp, Wp, ob, st, sk, si, sj, mvy, mvx, py,
                           px, lam, HB, WB, base, L, out, s);
    case 16:
      return launch<16, 32>(ref, R, Hp, Wp, ob, st, sk, si, sj, mvy, mvx, py,
                            px, lam, HB, WB, base, L, out, s);
    case 32:
      return launch<32, 128>(ref, R, Hp, Wp, ob, st, sk, si, sj, mvy, mvx,
                             py, px, lam, HB, WB, base, L, out, s);
    case 64:
      return launch<64, 256>(ref, R, Hp, Wp, ob, st, sk, si, sj, mvy, mvx,
                             py, px, lam, HB, WB, base, L, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
