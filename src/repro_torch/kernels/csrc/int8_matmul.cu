// int8 x int8 -> int32 GEMM with a fused requant epilogue, for Hopper.
//
// Replaces the Pallas kernel repro/kernels/int8_matmul.py
// (`_kernel` / `int8_matmul_requant_pallas`), and in the port it
// carries every QLinear of the dense serving path (the reference
// leaves those products to XLA's dot_general):
//
//   acc[m, n] = sum_k x[m, k] * w[k, n]                   int32
//   mode int8 : out = clip(((clip(acc + b, lo, hi) >> s0) * mul
//                          >> (d - s0)) + zp, qmin, qmax)  -> int8
//               (the full apply_rqt of the site, pre-clip included)
//   mode int32: out = acc + b                               -> int32
//
// Layout: x (M, K) row-major with leading dimension ldx; the weights
// are stored transposed, wt (N, K) row-major (the port transposes them
// once when the tables are loaded), so both operands stream K-contiguous
// 16-byte vectors.  Any M and N: ragged tile edges are masked here, no
// padding by the caller.  K must be a multiple of 16 and the rows of
// both operands 16-byte aligned (the wrapper checks; every shape of the
// serving path is).  All int32 adds and multiplies that
// can wrap are done in unsigned arithmetic, so they wrap like XLA's
// int32 instead of being undefined signed overflow.
//
// What bounds it on the H100: at decode (M = n_slots = 8) the weight
// bytes (K*N) dominate and the product is memory bound; at chunked
// prefill (M = 256) the 2*M*N*K int8 operations dominate.  Two paths,
// chosen by M:
//   M <= 16  `gemv_kernel`: one warp per output column, lanes split K
//            in 16-byte loads, shuffle reduction — every weight byte
//            read once, coalesced, from enough blocks to fill the card;
//   M > 16   `mma_kernel`: int8 tensor cores (mma.sync m16n8k32) on
//            128 x 64 tiles staged through shared memory.
// No Hopper wgmma / TMA pipeline yet: that is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int sra(int x, int s) {
  // arithmetic right shift with XLA's semantics for s >= 32 (sign fill)
  return (unsigned)s >= 31u ? (x >> 31) : (x >> s);
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// bias add, then (requant mode) the site's full apply_rqt, and store
__device__ __forceinline__ void epilogue(
    int acc, int r, int c, int N, const int32_t* __restrict__ bias,
    const int32_t* __restrict__ mul, const int32_t* __restrict__ s0,
    const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
    int rq_stride, int d, int zp, int qmin, int qmax, void* out,
    int out_int8) {
  int v = wrap_add(acc, bias[c]);
  const long long o = (long long)r * N + c;
  if (mul == nullptr) {
    static_cast<int32_t*>(out)[o] = v;
    return;
  }
  const int cc = c * rq_stride;
  v = min(max(v, lo[cc]), hi[cc]);
  const int sh0 = s0[cc];
  const int staged = wrap_mul(sra(v, sh0), mul[cc]);
  int y = wrap_add(sra(staged, d - sh0), zp);
  y = min(max(y, qmin), qmax);
  if (out_int8)
    static_cast<int8_t*>(out)[o] = (int8_t)y;
  else
    static_cast<int32_t*>(out)[o] = y;
}

// Small M (decode, M <= 16): one warp per output column, the 32 lanes
// split K in 16-byte steps and reduce with shuffles.  Each weight byte
// is read once, as 512 contiguous bytes per warp step, which is what
// the memory-bound decode GEMM needs; a tiled kernel would leave most
// SMs idle there (N / 64 blocks).  Integer sums are exact in any
// order, so the split changes no bit of the result.
constexpr int kGemvWarps = 8;

__global__ void __launch_bounds__(32 * kGemvWarps)
gemv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
            const int32_t* __restrict__ bias,
            const int32_t* __restrict__ mul, const int32_t* __restrict__ s0,
            const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
            const int32_t* __restrict__ dptr,
            const int32_t* __restrict__ zpptr, int rq_stride, int qmin,
            int qmax, void* __restrict__ out, int out_int8, int M, int N,
            int K, long long ldx) {
  const int lane = threadIdx.x % 32;
  const int c = blockIdx.x * kGemvWarps + threadIdx.x / 32;
  if (c >= N) return;  // uniform per warp
  int acc[16];
#pragma unroll
  for (int m = 0; m < 16; ++m) acc[m] = 0;
  const int4* wr = reinterpret_cast<const int4*>(wt + (long long)c * K);
  for (int k16 = lane; k16 < K / 16; k16 += 32) {
    const int4 w = __ldg(wr + k16);
#pragma unroll
    for (int m = 0; m < 16; ++m) {
      if (m < M) {
        const int4 xv = __ldg(
            reinterpret_cast<const int4*>(x + (long long)m * ldx) + k16);
        acc[m] = __dp4a(xv.x, w.x, acc[m]);
        acc[m] = __dp4a(xv.y, w.y, acc[m]);
        acc[m] = __dp4a(xv.z, w.z, acc[m]);
        acc[m] = __dp4a(xv.w, w.w, acc[m]);
      }
    }
  }
  const bool rq = mul != nullptr;
  const int d = rq ? *dptr : 0;
  const int zp = rq ? *zpptr : 0;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    if (m < M) {
      int v = acc[m];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        v = wrap_add(v, __shfl_xor_sync(0xffffffffu, v, o));
      if (lane == m)
        epilogue(v, m, c, N, bias, mul, s0, lo, hi, rq_stride, d, zp, qmin,
                 qmax, out, out_int8);
    }
  }
}

// M > 16 (chunked prefill): the int8 tensor cores through
// mma.sync.m16n8k32 (s8 x s8 -> s32).  A block owns a 128 x 64 output
// tile; its 8 warps (4 x 2) own 32 x 32 each, i.e. 2 x 4 MMA tiles.
// Each 64-byte K step stages the A tile (128 x 64 B) and the weight
// tile (64 x 64 B, K-contiguous, which is exactly the "col" B operand)
// in shared memory with rows padded to 80 bytes, so the fragment loads
// of the 8 row groups of a warp fall in distinct banks.  No software
// pipelining yet.
constexpr int kMmaBM = 128;
constexpr int kMmaBN = 64;
constexpr int kMmaBK = 64;
constexpr int kMmaLd = kMmaBK + 16;

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(256)
mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
           const int32_t* __restrict__ bias,
           const int32_t* __restrict__ mul, const int32_t* __restrict__ s0,
           const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
           const int32_t* __restrict__ dptr,
           const int32_t* __restrict__ zpptr, int rq_stride, int qmin,
           int qmax, void* __restrict__ out, int out_int8, int M, int N,
           int K, long long ldx) {
  __shared__ __align__(16) int8_t As[kMmaBM * kMmaLd];
  __shared__ __align__(16) int8_t Bs[kMmaBN * kMmaLd];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const int g = lane >> 2, tq = lane & 3;
  const int row0 = blockIdx.y * kMmaBM, col0 = blockIdx.x * kMmaBN;
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
    for (int i = tid; i < kMmaBM * 4; i += 256) {
      const int r = i / 4, c16 = i % 4, gr = row0 + r, k = k0 + 16 * c16;
      int4 v = make_int4(0, 0, 0, 0);
      if (gr < M && k < K)
        v = *reinterpret_cast<const int4*>(x + (long long)gr * ldx + k);
      *reinterpret_cast<int4*>(As + r * kMmaLd + 16 * c16) = v;
    }
    {
      const int r = tid / 4, c16 = tid % 4, gc = col0 + r, k = k0 + 16 * c16;
      int4 v = make_int4(0, 0, 0, 0);
      if (gc < N && k < K)
        v = *reinterpret_cast<const int4*>(wt + (long long)gc * K + k);
      *reinterpret_cast<int4*>(Bs + r * kMmaLd + 16 * c16) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kMmaBK; kk += 32) {
      unsigned a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* p = As + (32 * wm + 16 * mi + g) * kMmaLd + kk + 4 * tq;
        a[mi][0] = *reinterpret_cast<const unsigned*>(p);
        a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * kMmaLd);
        a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * kMmaLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = Bs + (32 * wn + 8 * ni + g) * kMmaLd + kk + 4 * tq;
        b[ni][0] = *reinterpret_cast<const unsigned*>(p);
        b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

  const bool rq = mul != nullptr;
  const int d = rq ? *dptr : 0;
  const int zp = rq ? *zpptr : 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + 32 * wm + 16 * mi + g + 8 * (e >> 1);
        const int c = col0 + 32 * wn + 8 * ni + 2 * tq + (e & 1);
        if (r < M && c < N)
          epilogue(acc[mi][ni][e], r, c, N, bias, mul, s0, lo, hi, rq_stride,
                   d, zp, qmin, qmax, out, out_int8);
      }
    }
  }
}

}  // namespace

extern "C" int int8_matmul_launch(
    const int8_t* x, const int8_t* wt, const int32_t* bias,
    const int32_t* mul, const int32_t* s0, const int32_t* lo,
    const int32_t* hi, const int32_t* d, const int32_t* zp, int rq_stride,
    int qmin, int qmax, void* out, int out_int8, int M, int N, int K,
    long long ldx, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K % 16 != 0 || ldx % 16 != 0) return (int)cudaErrorInvalidValue;
  if (M <= 16) {
    gemv_kernel<<<(N + kGemvWarps - 1) / kGemvWarps, 32 * kGemvWarps, 0,
                  stream>>>(x, wt, bias, mul, s0, lo, hi, d, zp, rq_stride,
                            qmin, qmax, out, out_int8, M, N, K, ldx);
  } else {
    const dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM);
    mma_kernel<<<grid, 256, 0, stream>>>(x, wt, bias, mul, s0, lo, hi, d,
                                         zp, rq_stride, qmin, qmax, out,
                                         out_int8, M, N, K, ldx);
  }
  return (int)cudaGetLastError();
}
