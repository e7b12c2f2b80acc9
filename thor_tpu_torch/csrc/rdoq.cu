// The forward quantizer's zero-run pass for the Thor device encoder,
// hand-written for Hopper (sm_90a).
//
// No TPU kernel of its own: thor_tpu runs this pass as XLA ops
// (thor_tpu/ops/jax_kernels.py:_rdoq_light, a scan over the scan
// positions inside quantize_fwd_batch), and the port's plain version
// (ops/kernels._rdoq_light) jumps from trigger to trigger over all rows
// at once, asking the host after every step whether a row has one left.
// On the card that question is a wait per step, and a CUDA graph cannot
// hold it; this kernel takes the walk onto the card.
//
// The pass (enc/encode_block.c:134-168) on [N, Nc] levels in scan order:
// position p fires when its level is above 1 after two zero levels,
// unless the level 3 back is above 1, or the level 4 back is above 1 and
// the one 3 back nonzero. Then the smallest of the raw coefficients at
// p, p-1, p-2 decides which level becomes +-1 (the sign of the
// coefficient there). Luma rows fire from position 3 on; chroma rows
// (the trials quantize chroma with chroma=True) also at position 2 when
// 2 <= last < 6, and never past `last`. A luma row never fires past
// `last` either: the levels there are zero and the pass writes only +-1.
//
// Design. The walk is serial within a row and data-dependent, so a row is
// one warp, as in the encoder's intra scan (enc_intra_scan.cu, step 7):
// the row's levels up to `last` go to shared memory, the warp tests 32
// positions at a time under the current levels, a ballot finds the first
// that fires, one lane applies it and the window restarts behind it:
// (last / 32 + changes) steps a row, no host round trip. A step changes
// only positions p-2..p, and a test reads only p-4..p, so restarting at
// p+1 is the reference's order. Then the warp writes the whole output row
// (the levels past `last` are zero), so the caller needs no copy of q.
// Rows are independent: 8 warps a block.
//
// Bound. Bytes: the output written once ([N, Nc] int32), the levels read
// up to each row's last, `last` read, and three raw coefficients read per
// level changed (the trigger's p, p-1, p-2; the sign is one of them).
// Operations: a handful per position; the bytes bound it.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;
constexpr unsigned ALL = 0xffffffffu;

__global__ void __launch_bounds__(NT)
rdoq_kernel(const int* __restrict__ q, int* __restrict__ out,
            const int* __restrict__ sco, const int* __restrict__ last, int N,
            int Nc, int thr, int chroma) {
  extern __shared__ int smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + w;
  if (row >= N) return;                    // the whole warp leaves
  const int lp = min(__ldg(last + row), Nc - 1);
  const int start = (chroma && lp >= 2 && lp < 6) ? 2 : 3;
  const int* qr = q + static_cast<size_t>(row) * Nc;
  int* orow = out + static_cast<size_t>(row) * Nc;
  const int* sr = sco + static_cast<size_t>(row) * Nc;
  int* s = smem + w * Nc;
  for (int k = lane; k < Nc; k += 32) s[k] = k <= lp ? __ldg(qr + k) : 0;
  __syncwarp();

  int cursor = start;
  while (cursor <= lp) {
    const int p = cursor + lane;
    bool act = false;
    if (p <= lp) {
      const int a3 = p >= 3 ? abs(s[p - 3]) : 0;
      const int a4 = p >= 4 ? abs(s[p - 4]) : 0;
      act = abs(s[p]) > 1 && s[p - 1] == 0 && s[p - 2] == 0 && !(a3 > 1)
            && !(a4 > 1 && a3 > 0);
    }
    const unsigned m = __ballot_sync(ALL, act);
    if (m == 0) {
      cursor += 32;
      continue;
    }
    const int l = __ffs(m) - 1;
    if (lane == l) {
      const int c0 = abs(__ldg(sr + p)), c1 = abs(__ldg(sr + p - 1));
      const int c2 = abs(__ldg(sr + p - 2));
      const int tgt = c0 + max(c1, c2) < thr ? p : (c1 > c2 ? p - 1 : p - 2);
      s[tgt] = __ldg(sr + tgt) < 0 ? -1 : 1;
    }
    __syncwarp();
    cursor += l + 1;
  }
  for (int k = lane; k < Nc; k += 32) orow[k] = s[k];
}

}  // namespace

// q: [N, Nc] int32 levels in scan order, zero past each row's last (read
// up to it only); out: [N, Nc] int32, the levels after the pass (may not
// alias q); sco: [N, Nc] int32 raw coefficients in scan order; last: [N]
// int32, each row's last significant position (-1: none); thr =
// (73 * gdequant[qp % 6] << (qp / 6)) >> (4 + log2(size)); chroma: the
// chroma rule. Nc <= 256. Launches one kernel on `stream`; returns
// cudaGetLastError().
extern "C" int thor_rdoq(const void* q, void* out, const void* sco,
                         const void* last, int N, int Nc, int thr, int chroma,
                         void* stream) {
  if (N <= 0 || Nc <= 0) return 0;
  if (Nc > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (N + WARPS - 1) / WARPS;
  rdoq_kernel<<<grid, NT, WARPS * Nc * sizeof(int), s>>>(
      static_cast<const int*>(q), static_cast<int*>(out),
      static_cast<const int*>(sco), static_cast<const int*>(last), N, Nc, thr,
      chroma);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* thor_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
