// Holds SMs of the card busy for a given time. A test aid, not a kernel of
// the codec: the tests of the multi-block scans (intra_scan.cu,
// interp_me.cu) launch it on a second stream to show that those kernels
// finish, with the same result, when only part of their grid can be
// resident. Each block spins on the card's nanosecond timer; `smem_bytes`
// of dynamic shared memory per block decide how many blocks share an SM.

#include <cuda_runtime.h>

namespace {

__global__ void occupy_kernel(unsigned long long ns) {
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while (t - t0 < ns);
}

}  // namespace

// Launches `blocks` blocks of `threads` threads that each hold
// `smem_bytes` of shared memory and spin for `ns` nanoseconds, on
// `stream`; returns cudaGetLastError().
extern "C" int thor_occupy(int blocks, int threads, int smem_bytes,
                           unsigned long long ns, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      occupy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  occupy_kernel<<<blocks, threads, smem_bytes,
                  static_cast<cudaStream_t>(stream)>>>(ns);
  return static_cast<int>(cudaGetLastError());
}
