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
// Design. The TPU kernel walked the cells one by one, fetched aligned
// tiles, rolled them, resampled them with one-hot matrix products and
// placed the cell with a masked read-modify-write. None of that is needed
// here: one thread computes one output pixel and reads its two source
// bytes straight from the codec-padded planes in global memory. The cells
// of a warp's 32 neighbouring pixels are 4 (luma) or 8 (chroma) and their
// windows are contiguous runs, so loads coalesce per cell and stores per
// row. For U and V the window origins and the inside tests are computed
// once and serve both planes: one thread writes the U and the V pixel.
//
// Bound: bytes. At 1080p luma each padded input plane is read once (2 x
// 2.7 MB), the output written once (2.1 MB), plus 0.5 MB of vectors:
// 8.0 MB, 2.4 us at 3.35 TB/s, against about 30 integer operations per
// pixel, 62 M, 0.9 us at 67 TOP/s. One launch of 2 M threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ACC_BITS = 3;
constexpr int ACC_ROUND = 1 << (ACC_BITS - 1);

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// NP planes (1: luma, 2: U and V) sharing one vector field.
template <int NP>
__global__ void __launch_bounds__(256)
mot_comp_kernel(const uint8_t* __restrict__ p0a, const uint8_t* __restrict__ p1a,
                uint8_t* __restrict__ outa, const uint8_t* __restrict__ p0b,
                const uint8_t* __restrict__ p1b, uint8_t* __restrict__ outb,
                const int* __restrict__ mv0, const int* __restrict__ mv1,
                int bw, int w, int h, int cs, int clip_pad, int base) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= w || y >= h) return;
  const int ii = y / cs, jj = x / cs;
  const int cell = (ii * bw + jj) * 2;
  // window origins: cell origin + vector rounded to whole pels (the shift
  // is arithmetic: floor for negative vectors, as in the reference)
  const int xs0 = jj * cs + ((mv0[cell] + ACC_ROUND) >> ACC_BITS);
  const int ys0 = ii * cs + ((mv0[cell + 1] + ACC_ROUND) >> ACC_BITS);
  const int xs1 = jj * cs + ((mv1[cell] + ACC_ROUND) >> ACC_BITS);
  const int ys1 = ii * cs + ((mv1[cell + 1] + ACC_ROUND) >> ACC_BITS);
  const int hP = h + clip_pad, wP = w + clip_pad;
  const bool in0 = xs0 >= -clip_pad && xs0 + cs <= wP && ys0 >= -clip_pad &&
                   ys0 + cs <= hP;
  const bool in1 = xs1 >= -clip_pad && xs1 + cs <= wP && ys1 >= -clip_pad &&
                   ys1 + cs <= hP;
  const int dy = y - ii * cs, dx = x - jj * cs;
  const int stride = w + 2 * base;
  const size_t i0 =
      static_cast<size_t>(clampi(ys0 + dy, -clip_pad, hP - 1) + base) * stride +
      clampi(xs0 + dx, -clip_pad, wP - 1) + base;
  const size_t i1 =
      static_cast<size_t>(clampi(ys1 + dy, -clip_pad, hP - 1) + base) * stride +
      clampi(xs1 + dx, -clip_pad, wP - 1) + base;
  const bool only1 = in1 && !in0, only0 = in0 && !in1;
  const size_t o = static_cast<size_t>(y) * w + x;
  {
    const int a = p0a[i0], b = p1a[i1];
    outa[o] = static_cast<uint8_t>(only1 ? b : (only0 ? a : (a + b + 1) >> 1));
  }
  if (NP == 2) {
    const int a = p0b[i0], b = p1b[i1];
    outb[o] = static_cast<uint8_t>(only1 ? b : (only0 ? a : (a + b + 1) >> 1));
  }
}

}  // namespace

// p0a, p1a (and p0b, p1b, or null for one plane): [h + 2 base, w + 2 base]
// uint8 codec-padded planes; mv0, mv1: [bh, bw, 2] int32 (x, y) per cell;
// outa (outb): [h, w] uint8. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int thor_interp_mot_comp(const void* p0a, const void* p1a, void* outa,
                                    const void* p0b, const void* p1b, void* outb,
                                    const void* mv0, const void* mv1, int bw,
                                    int bh, int w, int h, int cs, int clip_pad,
                                    int base, void* stream) {
  if (w <= 0 || h <= 0 || cs <= 0 || bw * cs < w || bh * cs < h ||
      clip_pad > base) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(32, 8);
  const dim3 grid((w + 31) / 32, (h + 7) / 8);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a0 = static_cast<const uint8_t*>(p0a);
  const uint8_t* a1 = static_cast<const uint8_t*>(p1a);
  const uint8_t* b0 = static_cast<const uint8_t*>(p0b);
  const uint8_t* b1 = static_cast<const uint8_t*>(p1b);
  const int* m0 = static_cast<const int*>(mv0);
  const int* m1 = static_cast<const int*>(mv1);
  if (p0b == nullptr) {
    mot_comp_kernel<1><<<grid, block, 0, s>>>(
        a0, a1, static_cast<uint8_t*>(outa), nullptr, nullptr, nullptr, m0, m1,
        bw, w, h, cs, clip_pad, base);
  } else {
    mot_comp_kernel<2><<<grid, block, 0, s>>>(
        a0, a1, static_cast<uint8_t*>(outa), b0, b1,
        static_cast<uint8_t*>(outb), m0, m1, bw, w, h, cs, clip_pad, base);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
