// Unified (S, T) int8 paged attention over the paged KV arena, for
// Hopper.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py
// (`_kernel` / `paged_attention_pallas`), both pool modes.  One block
// per (slot b, head h):
//
//   scores   s[i, t] = q[b, h, i, :] . k[page(t), h // group, t % ps, :]
//   logits   x = float(s) * score_scale + (t <= pos[b] + i ? 0 : -1e9)
//   softmax  one global f32 softmax per query row (max, expf, sum, /)
//   image    qp = rint(127 * p)      (round half to even, like jnp.round)
//   out      acc[b, h, i, :] = sum_t qp[i, t] * v[page(t), ..., t % ps, :]
//
// The int32 P.V accumulator is the output; the caller applies ctx_rqt.
// The probability image is the model's GLOBAL image (never the
// flash-style per-block requant of quant_attention, which flips greedy
// tokens): every logit of a row is staged before the row's softmax.
//
// Float island: compiled without fast math and with --fmad=false, and
// written with explicit __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, so each
// logit, exponent and quotient rounds exactly like the plain PyTorch
// version (torch's CUDA expf is the same libdevice expf).  The row sum
// runs in a fixed order (lane-strided partials, then a xor butterfly)
// that the plain version reproduces (`_lane_sum`), so on the card the
// two images agree bit for bit; the optional qp_out image lets a check
// count the quanta that moved (`check_image`).
//
// Where the logits live: the (S, T) f32 rows of a block sit in shared
// memory while they fit (S = 32, T = 512 takes 64 KB).  Past that
// (S = 32 with T >= 1024) the wrapper hands in a global scratch of
// B*H*S*T floats and the same code runs with the rows in device memory.
// The int8 probability image always sits in shared memory (S*T bytes;
// the wrapper refuses S*T above what fits, e.g. S = 32 with T > 6144),
// and P.V streams V through a shared tile of kTT positions, so its
// inner loop reads shared memory only.
//
// Int4-packed pools (PACKED, kv_bits 4): a pool row holds hd/2 bytes,
// two int4 nibbles each (element 2i in the low nibble).  Every page
// load is unpacked in registers into the int8 image with the kv head's
// requant column of k_rq / v_rq ((6, K) int32: m, s0, lo, hi, d, zp):
// clip to [lo, hi], >> s0, * m, >> (d - s0), + zp, clip to [-128, 127]
// (the reference's `page_kv`); the K row is unpacked where it is loaded
// into registers, the V tile where it is staged into shared memory.
// Everything after the unpack is the int8 mode: the same float island,
// the same row-sum order, the same P.V.  Half the pool bytes are read.
//
// What bounds it on the H100: at the serving shapes it is small
// integer work per (b, h) block (S*T*hd/4 dp4a for the scores,
// S*T*hd multiply-adds for P.V) plus one read of the slot's K and V
// pages per head; with B*H = 256 blocks the card is latency bound
// rather than bandwidth or ALU bound.  The design keeps each K row in
// registers while it is dotted with every query row (q sits in shared
// memory and is broadcast), reads the page table once into shared
// memory, and folds GQA into the page loads (kv head = h / group), so
// no head-expanded K/V copy exists.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRS = 4;   // query rows per thread in the P.V pass
constexpr int kTT = 32;  // key positions per V tile staged in shared memory

// arithmetic shift right; shifts of 31 and more (and negative ones) give
// the sign, as in the requant kernel
__device__ __forceinline__ int sra(int x, int s) {
  return (unsigned)s >= 31u ? (x >> 31) : (x >> s);
}

// one kv head's unpack requant column (rows of the (6, K) operand)
struct Unpack {
  int m = 0, s0 = 0, lo = 0, hi = 0, d = 0, zp = 0;
  __device__ Unpack() {}
  __device__ Unpack(const int32_t* rq, int K, int kh)
      : m(rq[kh]), s0(rq[K + kh]), lo(rq[2 * K + kh]), hi(rq[3 * K + kh]),
        d(rq[4 * K + kh]), zp(rq[5 * K + kh]) {}
  // one sign-extended int4 value -> its int8 image value (wrapping
  // int32 multiply and add, like the reference)
  __device__ __forceinline__ int one(int x) const {
    x = min(max(x, lo), hi);
    const int staged = (int)((unsigned)sra(x, s0) * (unsigned)m);
    const int y = (int)((unsigned)sra(staged, d - s0) + (unsigned)zp);
    return min(max(y, -128), 127);
  }
  // 16 packed bits (4 nibbles, element j in bits 4j..4j+3) -> a word
  // of 4 int8 image values, element j in byte j
  __device__ __forceinline__ int word(unsigned bits) const {
    unsigned w = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nib = (int)((bits >> (4 * j)) & 0xfu);
      w |= ((unsigned)one((nib ^ 8) - 8) & 0xffu) << (8 * j);
    }
    return (int)w;
  }
};

template <int HD, bool PACKED>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const int8_t* __restrict__ q,
                  const int8_t* __restrict__ k_pool,
                  const int8_t* __restrict__ v_pool,
                  const int32_t* __restrict__ table,
                  const int32_t* __restrict__ pos,
                  const float* __restrict__ score_scale,
                  int32_t* __restrict__ out, float* __restrict__ scratch,
                  int8_t* __restrict__ qp_out,
                  const int32_t* __restrict__ k_rq,
                  const int32_t* __restrict__ v_rq, int H, int S, int K,
                  int ps, int pps, int group, int n_pool) {
  constexpr int HDW = HD / 4;
  constexpr int ROW = PACKED ? HD / 2 : HD;  // bytes of one pool row
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int kh = h / group;
  const int T = pps * ps;
  const int tid = threadIdx.x;
  const long long bh = (long long)b * H + h;

  // shared layout (the wrapper sizes it the same way):
  //   q (S*hd bytes) | table (pps ints, padded to 16 B) | V tile
  //   (kTT*hd bytes) | probability image (S*T bytes, padded to 16 B) |
  //   logits (S*T floats, unless they live in the global scratch)
  int* q_s = reinterpret_cast<int*>(smem);
  int* tab_s = q_s + S * HDW;
  int* vt_s = tab_s + ((pps + 3) & ~3);
  int8_t* qp_s = reinterpret_cast<int8_t*>(vt_s + kTT * HDW);
  float* lg = scratch != nullptr
                  ? scratch + bh * S * T
                  : reinterpret_cast<float*>(qp_s + ((S * T + 15) & ~15));

  const int* qg = reinterpret_cast<const int*>(q + bh * S * HD);
  for (int i = tid; i < S * HDW; i += kThreads) q_s[i] = qg[i];
  for (int i = tid; i < pps; i += kThreads) {
    int p = table[(long long)b * pps + i];
    tab_s[i] = min(max(p, 0), n_pool - 1);  // memory safety only
  }
  __syncthreads();

  const float scale = *score_scale;
  const int pos_b = pos[b];
  Unpack kun, vun;
  if (PACKED) {
    kun = Unpack(k_rq, K, kh);
    vun = Unpack(v_rq, K, kh);
  }

  // ---- scores: one key row per thread, dotted with every query row ----
  for (int t = tid; t < T; t += kThreads) {
    const long long row =
        (((long long)tab_s[t / ps] * K + kh) * ps + (t % ps)) * ROW;
    const int4* kr = reinterpret_cast<const int4*>(k_pool + row);
    int kw[HDW];
#pragma unroll
    for (int c = 0; c < ROW / 16; ++c) {
      const int4 v = kr[c];
      if (PACKED) {  // 16 packed bytes -> 8 words of the int8 image
        const int u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kw[8 * c + 2 * e] = kun.word((unsigned)u[e] & 0xffffu);
          kw[8 * c + 2 * e + 1] = kun.word((unsigned)u[e] >> 16);
        }
      } else {
        kw[4 * c] = v.x;
        kw[4 * c + 1] = v.y;
        kw[4 * c + 2] = v.z;
        kw[4 * c + 3] = v.w;
      }
    }
    for (int i = 0; i < S; ++i) {
      int acc = 0;
#pragma unroll
      for (int w = 0; w < HDW; ++w) acc = __dp4a(q_s[i * HDW + w], kw[w], acc);
      float x = __fmul_rn((float)acc, scale);
      x = __fadd_rn(x, (t <= pos_b + i) ? 0.0f : -1e9f);
      lg[(long long)i * T + t] = x;
    }
  }
  __syncthreads();

  // ---- float island: one warp per query row ----
  const int warp = tid / 32, lane = tid % 32;
  for (int i = warp; i < S; i += kThreads / 32) {
    float* r = lg + (long long)i * T;
    float m = -INFINITY;
    for (int t = lane; t < T; t += 32) m = fmaxf(m, r[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.0f;
    for (int t = lane; t < T; t += 32) {
      const float p = expf(__fsub_rn(r[t], m));
      r[t] = p;
      sum = __fadd_rn(sum, p);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
    for (int t = lane; t < T; t += 32) {
      const float img = rintf(__fmul_rn(__fdiv_rn(r[t], sum), 127.0f));
      qp_s[i * T + t] = (int8_t)img;
      if (qp_out != nullptr) qp_out[(bh * S + i) * T + t] = (int8_t)img;
    }
  }
  __syncthreads();

  // ---- integer P.V over the pages, V staged tile by tile ----
  const int dw = tid % HDW;      // which 4 head dims
  const int sg = tid / HDW;      // which query-row group
  constexpr int NSG = kThreads / HDW;
  for (int sb = 0; sb < S; sb += NSG * kRS) {
    int acc[kRS][4];
#pragma unroll
    for (int r = 0; r < kRS; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0;
    for (int t0 = 0; t0 < T; t0 += kTT) {
      __syncthreads();  // the previous tile is consumed
      for (int idx = tid; idx < kTT * HDW; idx += kThreads) {
        const int t = t0 + idx / HDW;
        int word = 0;
        if (t < T) {
          const long long row =
              (((long long)tab_s[t / ps] * K + kh) * ps + (t % ps)) * ROW;
          if (PACKED)
            word = vun.word(*reinterpret_cast<const unsigned short*>(
                v_pool + row + 2 * (idx % HDW)));
          else
            word = *reinterpret_cast<const int*>(v_pool + row +
                                                 4 * (idx % HDW));
        }
        vt_s[idx] = word;
      }
      __syncthreads();
      const int n_t = min(kTT, T - t0);
      for (int tt = 0; tt < n_t; ++tt) {
        const int vw = vt_s[tt * HDW + dw];
        int v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = (int)(int8_t)((vw >> (8 * j)) & 0xff);
#pragma unroll
        for (int r = 0; r < kRS; ++r) {
          const int i = sb + sg + r * NSG;
          if (i < S) {
            const int p = qp_s[i * T + t0 + tt];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[r][j] += p * v[j];
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRS; ++r) {
      const int i = sb + sg + r * NSG;
      if (i < S) {
        int32_t* o = out + (bh * S + i) * HD + 4 * dw;
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = acc[r][j];
      }
    }
  }
}

template <int HD, bool PACKED>
int launch(const int8_t* q, const int8_t* k_pool, const int8_t* v_pool,
           const int32_t* table, const int32_t* pos, const float* scale,
           int32_t* out, float* scratch, int8_t* qp_out, const int32_t* k_rq,
           const int32_t* v_rq, int B, int H, int S, int K, int ps, int pps,
           int group, int n_pool, size_t smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attn_kernel<HD, PACKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  paged_attn_kernel<HD, PACKED><<<dim3(B, H), kThreads, smem, stream>>>(
      q, k_pool, v_pool, table, pos, scale, out, scratch, qp_out, k_rq, v_rq,
      H, S, K, ps, pps, group, n_pool);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mode(const int8_t* q, const int8_t* k_pool, const int8_t* v_pool,
                const int32_t* table, const int32_t* pos, const float* scale,
                int32_t* out, float* scratch, int8_t* qp_out,
                const int32_t* k_rq, const int32_t* v_rq, int B, int H, int S,
                int K, int ps, int pps, int group, int n_pool, size_t smem,
                cudaStream_t stream) {
  if (k_rq != nullptr)
    return launch<HD, true>(q, k_pool, v_pool, table, pos, scale, out,
                            scratch, qp_out, k_rq, v_rq, B, H, S, K, ps, pps,
                            group, n_pool, smem, stream);
  return launch<HD, false>(q, k_pool, v_pool, table, pos, scale, out,
                           scratch, qp_out, k_rq, v_rq, B, H, S, K, ps, pps,
                           group, n_pool, smem, stream);
}

}  // namespace

// smem: dynamic shared bytes the caller computed for the layout above
// (logits included when scratch is null).  k_rq / v_rq: the (6, K)
// unpack operands of int4-packed pools, or null for int8 pools.
// Returns a cudaError_t.
extern "C" int paged_attention_launch(
    const int8_t* q, const int8_t* k_pool, const int8_t* v_pool,
    const int32_t* table, const int32_t* pos, const float* score_scale,
    int32_t* out, float* scratch, int8_t* qp_out, const int32_t* k_rq,
    const int32_t* v_rq, int B, int H, int S, int hd, int K, int ps,
    int pps, int group, int n_pool, long long smem, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if ((k_rq == nullptr) != (v_rq == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch_mode<32>(q, k_pool, v_pool, table, pos, score_scale, out,
                             scratch, qp_out, k_rq, v_rq, B, H, S, K, ps,
                             pps, group, n_pool, (size_t)smem, stream);
    case 64:
      return launch_mode<64>(q, k_pool, v_pool, table, pos, score_scale, out,
                             scratch, qp_out, k_rq, v_rq, B, H, S, K, ps,
                             pps, group, n_pool, (size_t)smem, stream);
    case 128:
      return launch_mode<128>(q, k_pool, v_pool, table, pos, score_scale,
                              out, scratch, qp_out, k_rq, v_rq, B, H, S, K,
                              ps, pps, group, n_pool, (size_t)smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
