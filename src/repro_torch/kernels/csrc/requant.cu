// Standalone requantization (paper Eq. 13, staged form), for Hopper.
//
// Replaces the Pallas kernel repro/kernels/requant_kernel.py
// (`_kernel` / `requant_pallas`) and covers the whole contract of
// repro.core.requant.apply_rqt:
//
//   q   = clip(q, lo[c], hi[c])
//   out = clip(((q >> s0[c]) * m[c] >> (d - s0[c])) + zp, qmin, qmax)
//
// with m/s0/lo/hi per channel c (the last axis, rq_stride 1) or scalar
// (rq_stride 0), d and zp read from device memory (so one build serves
// every layer and no host sync reads them), and int8 or int32 output.
// The port runs it at ctx_rqt (after paged attention), the MLP's h_rqt
// and the two int32-out branches of every QAdd.
//
// What bounds it on the H100: it is a pure elementwise pass, 4 bytes
// read and 1 or 4 bytes written per element with a handful of integer
// operations, so memory bandwidth bounds it.  The design is a
// grid-stride loop with consecutive threads on consecutive elements
// (coalesced), the per-channel tables served from L1/L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int sra(int x, int s) {
  return (unsigned)s >= 31u ? (x >> 31) : (x >> s);
}

__global__ void requant_kernel(const int32_t* __restrict__ q,
                               const int32_t* __restrict__ m,
                               const int32_t* __restrict__ s0,
                               const int32_t* __restrict__ lo,
                               const int32_t* __restrict__ hi,
                               int rq_stride,
                               const int32_t* __restrict__ dptr,
                               const int32_t* __restrict__ zpptr, int qmin,
                               int qmax, void* __restrict__ out,
                               int out_int8, long long numel, int N) {
  const int d = *dptr;
  const int zp = *zpptr;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < numel; i += step) {
    const int c = (int)(i % N) * rq_stride;
    int v = min(max(q[i], lo[c]), hi[c]);
    const int sh0 = s0[c];
    const int staged = (int)((unsigned)sra(v, sh0) * (unsigned)m[c]);
    int y = (int)((unsigned)sra(staged, d - sh0) + (unsigned)zp);
    y = min(max(y, qmin), qmax);
    if (out_int8)
      static_cast<int8_t*>(out)[i] = (int8_t)y;
    else
      static_cast<int32_t*>(out)[i] = y;
  }
}

}  // namespace

extern "C" int requant_launch(const int32_t* q, const int32_t* m,
                              const int32_t* s0, const int32_t* lo,
                              const int32_t* hi, int rq_stride,
                              const int32_t* d, const int32_t* zp, int qmin,
                              int qmax, void* out, int out_int8,
                              long long numel, int N, cudaStream_t stream) {
  if (numel <= 0) return 0;
  const int threads = 256;
  long long blocks = (numel + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  requant_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      q, m, s0, lo, hi, rq_stride, d, zp, qmin, qmax, out, out_int8, numel,
      N);
  return (int)cudaGetLastError();
}
