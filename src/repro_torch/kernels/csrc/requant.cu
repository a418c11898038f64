// Standalone requantization (paper Eq. 13, staged form), for Hopper.
//
// Replaces the Pallas kernel repro/kernels/requant_kernel.py
// (`_kernel` / `requant_pallas`) and covers the whole contract of
// repro.core.requant.apply_rqt:
//
//   q   = clip(q, lo[c], hi[c])
//   out = clip(((q >> s0[c]) * m[c] >> (d - s0[c])) + zp, qmin, qmax)
//
// with m/s0/lo/hi per channel c (the last axis) or scalar, d and zp read
// from device memory (one build serves every layer, and no host sync
// reads them), the product and the sum wrapping in int32.  Three call
// forms share that transform (`rq`), one launch per site of the serving
// path:
//
//   requant_kernel       apply_rqt, int8 or int32 out; with heads-to-
//                        rows, input (B, H, S, hd) and output laid out
//                        (B, S, H, hd), what the wo GEMM reads (ctx_rqt)
//   requant_add_kernel   the whole QAdd.apply_id: each branch minus its
//                        zp, requantised to int32 in +-2^24, the two
//                        summed and clipped to int8
//   requant_gate_kernel  the MLP's gate: s_g = lut[s_pre + 128] (the
//                        256-entry LUT staged in shared memory once a
//                        block), (s_g - zp_g) * s_u, then h_rqt to int8
//
// What bounds it on the H100: each form is one elementwise pass of 2-6
// bytes per element and a dozen integer operations, so memory bandwidth,
// and at the serving path's sizes (16K-2M elements) the launch itself.
// The design: one launch per site; each thread owns 16 consecutive
// elements, moved as 16-byte vectors (one for int8, four for int32);
// scalar tables (a compile-time choice) read once a thread into
// registers; per-channel tables read as 16-byte vectors, 4 channels at
// a time; the channel and the heads-to-rows address computed once a
// vector in 32-bit arithmetic (the wrapper refuses 2^31 elements or
// more).  Where numel, N or the alignment does not fit 16-element
// vectors, a scalar path inside the same launch takes those elements.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kVec = 16;     // elements a thread owns per step
constexpr int kBranch = 1 << 24;  // QAdd's int32 branch range

struct Rq {  // one site's tables, int32 device pointers
  const int32_t *m, *s0, *lo, *hi, *d, *zp;
};

__device__ __forceinline__ int sra(int x, int s) {
  return (unsigned)s >= 31u ? (x >> 31) : (x >> s);
}

// apply_rqt of one int32 value
__device__ __forceinline__ int rq(int v, int m, int s0, int lo, int hi,
                                  int d, int zp, int qmin, int qmax) {
  v = min(max(v, lo), hi);
  const int staged = (int)((unsigned)sra(v, s0) * (unsigned)m);
  const int y = (int)((unsigned)sra(staged, d - s0) + (unsigned)zp);
  return min(max(y, qmin), qmax);
}

// One site's tables as a thread holds them: scalars in registers, or
// per-channel vectors read through the read-only cache.
template <bool PC>
struct Site {
  Rq r;
  int m, s0, lo, hi, d, zp, qmin, qmax;

  __device__ Site(const Rq& r_, int qmin_, int qmax_)
      : r(r_), m(0), s0(0), lo(0), hi(0), qmin(qmin_), qmax(qmax_) {
    d = *r.d;
    zp = *r.zp;
    if constexpr (!PC) {
      m = *r.m;
      s0 = *r.s0;
      lo = *r.lo;
      hi = *r.hi;
    }
  }

  // v[0..3] of channels c..c+3 (c a multiple of 4 when PC)
  __device__ __forceinline__ void apply4(int* v, unsigned c) const {
    if constexpr (PC) {
      const int4 M = __ldg(reinterpret_cast<const int4*>(r.m + c));
      const int4 S = __ldg(reinterpret_cast<const int4*>(r.s0 + c));
      const int4 L = __ldg(reinterpret_cast<const int4*>(r.lo + c));
      const int4 H = __ldg(reinterpret_cast<const int4*>(r.hi + c));
      v[0] = rq(v[0], M.x, S.x, L.x, H.x, d, zp, qmin, qmax);
      v[1] = rq(v[1], M.y, S.y, L.y, H.y, d, zp, qmin, qmax);
      v[2] = rq(v[2], M.z, S.z, L.z, H.z, d, zp, qmin, qmax);
      v[3] = rq(v[3], M.w, S.w, L.w, H.w, d, zp, qmin, qmax);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = rq(v[k], m, s0, lo, hi, d, zp, qmin, qmax);
    }
  }

  // one value of channel c (the scalar path)
  __device__ __forceinline__ int apply1(int v, unsigned c) const {
    if constexpr (PC)
      return rq(v, __ldg(r.m + c), __ldg(r.s0 + c), __ldg(r.lo + c),
                __ldg(r.hi + c), d, zp, qmin, qmax);
    return rq(v, m, s0, lo, hi, d, zp, qmin, qmax);
  }
};

// 16 consecutive elements <-> 16 ints (int8 sign-extended)
__device__ __forceinline__ void load16(const int8_t* p, int* v) {
  const int4 w = __ldg(reinterpret_cast<const int4*>(p));
  const int u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    v[k] = (int)((unsigned)u[k >> 2] << (24 - 8 * (k & 3))) >> 24;
}

__device__ __forceinline__ void load16(const int32_t* p, int* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 w = __ldg(reinterpret_cast<const int4*>(p) + k);
    v[4 * k] = w.x;
    v[4 * k + 1] = w.y;
    v[4 * k + 2] = w.z;
    v[4 * k + 3] = w.w;
  }
}

__device__ __forceinline__ void store16(int8_t* p, const int* v) {
  unsigned u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    u[k] = ((unsigned)v[4 * k] & 0xffu) |
           (((unsigned)v[4 * k + 1] & 0xffu) << 8) |
           (((unsigned)v[4 * k + 2] & 0xffu) << 16) |
           ((unsigned)v[4 * k + 3] << 24);
  *reinterpret_cast<int4*>(p) =
      make_int4((int)u[0], (int)u[1], (int)u[2], (int)u[3]);
}

__device__ __forceinline__ void store16(int32_t* p, const int* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    reinterpret_cast<int4*>(p)[k] =
        make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// offset in (B, S, H, hd) of element e of a contiguous (B, H, S, hd)
__device__ __forceinline__ unsigned heads_to_rows(unsigned e, unsigned hd,
                                                  unsigned H, unsigned S) {
  const unsigned row = e / hd, j = e - row * hd;  // row = (b H + h) S + s
  const unsigned bh = row / S, s = row - bh * S;
  const unsigned b = bh / H, h = bh - b * H;
  return ((b * S + s) * H + h) * hd + j;
}

// Thread t takes vectors t, t + step, ... (16 elements each) when `vec`,
// then the elements past the last whole vector one at a time; with `vec`
// 0 it takes every element that way.  -> the first scalar element.
__device__ __forceinline__ unsigned vec_end(unsigned numel, int vec) {
  return vec ? numel / kVec * kVec : 0u;
}

template <bool PC, typename TO, bool H2R>
__global__ void requant_kernel(const int32_t* __restrict__ q, Rq r,
                               int qmin, int qmax, TO* __restrict__ out,
                               unsigned numel, unsigned N, unsigned H,
                               unsigned S, int vec) {
  const Site<PC> site(r, qmin, qmax);
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned step = gridDim.x * blockDim.x;
  const unsigned end = vec_end(numel, vec);
  for (unsigned e = tid * kVec; e < end; e += step * kVec) {
    int v[kVec];
    load16(q + e, v);
    const unsigned c = PC ? e % N : 0u;
#pragma unroll
    for (unsigned g = 0; g < kVec; g += 4) site.apply4(v + g, c + g);
    store16(out + (H2R ? heads_to_rows(e, N, H, S) : e), v);
  }
  for (unsigned e = end + tid; e < numel; e += step) {
    const int y = site.apply1(q[e], PC ? e % N : 0u);
    out[H2R ? heads_to_rows(e, N, H, S) : e] = (TO)y;
  }
}

template <typename TA, bool PCA, bool PCB>
__global__ void requant_add_kernel(const TA* __restrict__ a,
                                   const int32_t* __restrict__ zpa, Rq ra,
                                   const int32_t* __restrict__ b,
                                   const int32_t* __restrict__ zpb, Rq rb,
                                   int8_t* __restrict__ out, unsigned numel,
                                   unsigned N, int vec) {
  const Site<PCA> sa(ra, -kBranch, kBranch);
  const Site<PCB> sb(rb, -kBranch, kBranch);
  const unsigned za = (unsigned)*zpa, zb = (unsigned)*zpb;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned step = gridDim.x * blockDim.x;
  const unsigned end = vec_end(numel, vec);
  for (unsigned e = tid * kVec; e < end; e += step * kVec) {
    int va[kVec], vb[kVec];
    load16(a + e, va);
    load16(b + e, vb);
#pragma unroll
    for (unsigned k = 0; k < kVec; ++k) {
      va[k] = (int)((unsigned)va[k] - za);
      vb[k] = (int)((unsigned)vb[k] - zb);
    }
    const unsigned c = (PCA || PCB) ? e % N : 0u;
#pragma unroll
    for (unsigned g = 0; g < kVec; g += 4) {
      sa.apply4(va + g, c + g);
      sb.apply4(vb + g, c + g);
    }
#pragma unroll
    for (unsigned k = 0; k < kVec; ++k)
      va[k] = min(max(va[k] + vb[k], -128), 127);
    store16(out + e, va);
  }
  for (unsigned e = end + tid; e < numel; e += step) {
    const unsigned c = (PCA || PCB) ? e % N : 0u;
    const int ya = sa.apply1((int)((unsigned)a[e] - za), c);
    const int yb = sb.apply1((int)((unsigned)b[e] - zb), c);
    out[e] = (int8_t)min(max(ya + yb, -128), 127);
  }
}

template <bool PC>
__global__ void requant_gate_kernel(const int8_t* __restrict__ s_pre,
                                    const int8_t* __restrict__ lut,
                                    const int32_t* __restrict__ zpg,
                                    const int8_t* __restrict__ s_u, Rq r,
                                    int8_t* __restrict__ out,
                                    unsigned numel, unsigned N, int vec) {
  __shared__ int tab[256];
  for (unsigned k = threadIdx.x; k < 256; k += blockDim.x) tab[k] = lut[k];
  __syncthreads();
  const Site<PC> site(r, -128, 127);
  const unsigned zg = (unsigned)*zpg;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned step = gridDim.x * blockDim.x;
  const unsigned end = vec_end(numel, vec);
  for (unsigned e = tid * kVec; e < end; e += step * kVec) {
    int p[kVec], u[kVec];
    load16(s_pre + e, p);
    load16(s_u + e, u);
#pragma unroll
    for (unsigned k = 0; k < kVec; ++k)
      p[k] = (int)(((unsigned)tab[p[k] + 128] - zg) * (unsigned)u[k]);
    const unsigned c = PC ? e % N : 0u;
#pragma unroll
    for (unsigned g = 0; g < kVec; g += 4) site.apply4(p + g, c + g);
    store16(out + e, p);
  }
  for (unsigned e = end + tid; e < numel; e += step) {
    const int v =
        (int)(((unsigned)tab[s_pre[e] + 128] - zg) * (unsigned)s_u[e]);
    out[e] = (int8_t)site.apply1(v, PC ? e % N : 0u);
  }
}

template <bool PC, typename TO>
void launch_rqt(dim3 grid, dim3 block, cudaStream_t stream,
                const int32_t* q, const Rq& r, int qmin, int qmax, void* out,
                unsigned numel, unsigned N, unsigned H, unsigned S, int vec) {
  if (H)
    requant_kernel<PC, TO, true><<<grid, block, 0, stream>>>(
        q, r, qmin, qmax, static_cast<TO*>(out), numel, N, H, S, vec);
  else
    requant_kernel<PC, TO, false><<<grid, block, 0, stream>>>(
        q, r, qmin, qmax, static_cast<TO*>(out), numel, N, 1, 1, vec);
}

template <typename TA>
void launch_add(dim3 grid, dim3 block, cudaStream_t stream, const void* a,
                const int32_t* zpa, const Rq& ra, int pca, const int32_t* b,
                const int32_t* zpb, const Rq& rb, int pcb, int8_t* out,
                unsigned numel, unsigned N, int vec) {
  const TA* at = static_cast<const TA*>(a);
  if (pca && pcb)
    requant_add_kernel<TA, true, true><<<grid, block, 0, stream>>>(
        at, zpa, ra, b, zpb, rb, out, numel, N, vec);
  else if (pca)
    requant_add_kernel<TA, true, false><<<grid, block, 0, stream>>>(
        at, zpa, ra, b, zpb, rb, out, numel, N, vec);
  else if (pcb)
    requant_add_kernel<TA, false, true><<<grid, block, 0, stream>>>(
        at, zpa, ra, b, zpb, rb, out, numel, N, vec);
  else
    requant_add_kernel<TA, false, false><<<grid, block, 0, stream>>>(
        at, zpa, ra, b, zpb, rb, out, numel, N, vec);
}

}  // namespace

// apply_rqt; heads-to-rows when H > 0 (input (B, H, S, N), N = hd)
extern "C" int requant_launch(const int32_t* q, const int32_t* m,
                              const int32_t* s0, const int32_t* lo,
                              const int32_t* hi, const int32_t* d,
                              const int32_t* zp, int pc, int qmin, int qmax,
                              void* out, int out_int8, int numel, int N,
                              int H, int S, int vec, int threads, int blocks,
                              cudaStream_t stream) {
  if (numel <= 0) return 0;
  const Rq r{m, s0, lo, hi, d, zp};
  const dim3 grid(blocks), block(threads);
  if (out_int8 && pc)
    launch_rqt<true, int8_t>(grid, block, stream, q, r, qmin, qmax, out,
                             numel, N, H, S, vec);
  else if (out_int8)
    launch_rqt<false, int8_t>(grid, block, stream, q, r, qmin, qmax, out,
                              numel, N, H, S, vec);
  else if (pc)
    launch_rqt<true, int32_t>(grid, block, stream, q, r, qmin, qmax, out,
                              numel, N, H, S, vec);
  else
    launch_rqt<false, int32_t>(grid, block, stream, q, r, qmin, qmax, out,
                               numel, N, H, S, vec);
  return (int)cudaGetLastError();
}

// QAdd.apply_id: a int8 (a_int8) or int32, b int32, int8 out
extern "C" int requant_add_launch(
    const void* a, int a_int8, const int32_t* zpa, const int32_t* ma,
    const int32_t* s0a, const int32_t* loa, const int32_t* hia,
    const int32_t* da, const int32_t* zpa_out, int pca, const int32_t* b,
    const int32_t* zpb, const int32_t* mb, const int32_t* s0b,
    const int32_t* lob, const int32_t* hib, const int32_t* db,
    const int32_t* zpb_out, int pcb, int8_t* out, int numel, int N, int vec,
    int threads, int blocks, cudaStream_t stream) {
  if (numel <= 0) return 0;
  const Rq ra{ma, s0a, loa, hia, da, zpa_out};
  const Rq rb{mb, s0b, lob, hib, db, zpb_out};
  const dim3 grid(blocks), block(threads);
  if (a_int8)
    launch_add<int8_t>(grid, block, stream, a, zpa, ra, pca, b, zpb, rb, pcb,
                       out, numel, N, vec);
  else
    launch_add<int32_t>(grid, block, stream, a, zpa, ra, pca, b, zpb, rb,
                        pcb, out, numel, N, vec);
  return (int)cudaGetLastError();
}

// the MLP's gate: lut[s_pre + 128], minus zp_g, times s_u, h_rqt to int8
extern "C" int requant_gate_launch(
    const int8_t* s_pre, const int8_t* lut, const int32_t* zpg,
    const int8_t* s_u, const int32_t* m, const int32_t* s0,
    const int32_t* lo, const int32_t* hi, const int32_t* d,
    const int32_t* zp, int pc, int8_t* out, int numel, int N, int vec,
    int threads, int blocks, cudaStream_t stream) {
  if (numel <= 0) return 0;
  const Rq r{m, s0, lo, hi, d, zp};
  const dim3 grid(blocks), block(threads);
  if (pc)
    requant_gate_kernel<true><<<grid, block, 0, stream>>>(
        s_pre, lut, zpg, s_u, r, out, numel, N, vec);
  else
    requant_gate_kernel<false><<<grid, block, 0, stream>>>(
        s_pre, lut, zpg, s_u, r, out, numel, N, vec);
  return (int)cudaGetLastError();
}
