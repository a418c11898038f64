// Quantized flash attention with a per-block int8 probability image,
// for Hopper.
//
// Replaces the Pallas kernel repro/kernels/quant_attention.py
// (`_kernel` / `quant_flash_attention_pallas`) behind its GQA entry
// point repro/kernels/ops.py `quant_flash_attention`.  One block per
// (query block of bq rows, batch-head bh); kv head = h / n_rep, so no
// repeated K/V copy exists.  A loop over the KV blocks (bkv keys each)
// takes the place of the TPU's sequential grid axis, carrying the
// running max m, normaliser l and f32 accumulator acc in shared memory:
//
//   s      = q . k_j^T                            int32 (dp4a)
//   logits = float(s) * score_scale, or -1e9 where key > query (causal)
//   m_new  = max(m, rowmax(logits));  p = expf(logits - m_new)
//   qp     = rint(127 p)                          int8 image
//   corr   = expf(m - m_new)
//   acc    = acc * corr + float(qp . v_j) * (1/127)   (int32 P.V)
//   l      = l * corr + float(sum qp) * (1/127)
//   out    = clip(rint(acc / max(l, 1e-9) * (1/eps_ctx)), -128, 127)
//
// Float island: compiled without fast math and with --fmad=false, and
// written with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, expf and rintf,
// so every step rounds once, in the order above, exactly like the plain
// PyTorch version (the constants are the float32 of their doubles,
// rounded by the caller).  The row sum of qp is an integer sum, exact
// in any order.
//
// Skipped blocks: with `causal`, a KV block whose first key lies past
// the last query row of this block is not computed.  That is bit-equal
// to computing it: every row already saw key 0 (q_offset >= 0, which
// the wrapper requires), so m > -1e9 and p = expf(-1e9 - m) = 0, qp = 0,
// corr = expf(0) = 1, and acc * 1 + 0 and l * 1 + 0 leave acc and l as
// they are.
//
// What bounds it on the H100: int8 products, S_q * S_kv * hd / 2 dp4a
// each for the scores and (as scalar multiply-adds) for P.V under the
// causal mask, plus one expf per visible score; the bytes (q, K, V read
// once per query block, out) are small against that, so it is bound by
// operations — far from the tensor cores' rate in this first version.
// Each thread keeps one key row in registers while it is dotted with
// the block's query rows (q in shared memory, broadcast), one warp runs
// the island of one row at a time, and the V block is staged once into
// shared memory for P.V, over the logits the island has consumed.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e9f;

template <int HD>
__global__ void __launch_bounds__(kThreads)
quant_attn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                  const int8_t* __restrict__ v, int8_t* __restrict__ out,
                  float scale, float inv127, float inv_eps, int H, int K,
                  int n_rep, int S_q, int S_kv, int bq, int bkv,
                  int q_offset, int causal) {
  constexpr int HDW = HD / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int qb = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long kvh = (long long)b * K + h / n_rep;
  const int tid = threadIdx.x;

  // shared layout (the wrapper sizes it the same way):
  //   q (bq*HD bytes) | image (bq*bkv bytes, padded to 16 B) | logits
  //   (bq*bkv f32), which the V block (bkv*HD bytes) takes over once the
  //   island has read them, so the region is the larger of the two |
  //   acc (bq*HD f32) | m, l, corr (bq f32 each)
  int* q_s = reinterpret_cast<int*>(smem);
  int8_t* qp_s = reinterpret_cast<int8_t*>(q_s + bq * HDW);
  float* lg_s = reinterpret_cast<float*>(qp_s + ((bq * bkv + 15) & ~15));
  int* v_s = reinterpret_cast<int*>(lg_s);
  float* acc_s = lg_s + (max(bq * bkv, bkv * HDW) + 3) / 4 * 4;
  float* m_s = acc_s + bq * HD;
  float* l_s = m_s + bq;
  float* c_s = l_s + bq;

  const long long row0 = (long long)bh * S_q + (long long)qb * bq;
  const int* qg = reinterpret_cast<const int*>(q + row0 * HD);
  for (int i = tid; i < bq * HDW; i += kThreads) q_s[i] = qg[i];
  for (int i = tid; i < bq * HD; i += kThreads) acc_s[i] = 0.0f;
  for (int i = tid; i < bq; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  __syncthreads();

  const int q0 = q_offset + qb * bq;  // position of the block's first row
  int n_kv = S_kv / bkv;
  if (causal) n_kv = min(n_kv, (q0 + bq - 1) / bkv + 1);
  const int8_t* kg = k + kvh * S_kv * HD;
  const int8_t* vg = v + kvh * S_kv * HD;
  const int groups = bkv < kThreads ? kThreads / bkv : 1;
  const int warp = tid / 32, lane = tid % 32;

  for (int j = 0; j < n_kv; ++j) {
    // ---- scores: key row in registers, dotted with query rows ----
    for (int u = tid; u < bkv * groups; u += kThreads) {
      const int t = u % bkv, g = u / bkv;
      const int kp = j * bkv + t;
      const int4* kr =
          reinterpret_cast<const int4*>(kg + (long long)kp * HD);
      int kw[HDW];
#pragma unroll
      for (int c = 0; c < HDW / 4; ++c) {
        const int4 x = kr[c];
        kw[4 * c] = x.x;
        kw[4 * c + 1] = x.y;
        kw[4 * c + 2] = x.z;
        kw[4 * c + 3] = x.w;
      }
      for (int r = g; r < bq; r += groups) {
        int acc = 0;
#pragma unroll
        for (int w = 0; w < HDW; ++w) acc = __dp4a(q_s[r * HDW + w], kw[w], acc);
        const bool masked = causal && kp > q0 + r;
        lg_s[r * bkv + t] = masked ? kNegInf : __fmul_rn((float)acc, scale);
      }
    }
    __syncthreads();

    // ---- float island: one warp per query row ----
    for (int r = warp; r < bq; r += kThreads / 32) {
      const float* lr = lg_s + r * bkv;
      float mx = -INFINITY;
      for (int t = lane; t < bkv; t += 32) mx = fmaxf(mx, lr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      int qsum = 0;
      for (int t = lane; t < bkv; t += 32) {
        const float p = expf(__fsub_rn(lr[t], m_new));
        const float img = rintf(__fmul_rn(p, 127.0f));
        qp_s[r * bkv + t] = (int8_t)img;
        qsum += (int)img;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        qsum += __shfl_xor_sync(0xffffffffu, qsum, o);
      if (lane == 0) {
        const float corr = expf(__fsub_rn(m_old, m_new));
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], corr),
                           __fmul_rn((float)qsum, inv127));
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // ---- stage the V block over the consumed logits ----
    const int* vb = reinterpret_cast<const int*>(vg + (long long)j * bkv * HD);
    for (int i = tid; i < bkv * HDW; i += kThreads) v_s[i] = vb[i];
    __syncthreads();

    // ---- integer P.V, folded into the running accumulator ----
    for (int u = tid; u < bq * HDW; u += kThreads) {
      const int r = u / HDW, dw = u % HDW;
      int a[4] = {0, 0, 0, 0};
      const int8_t* pr = qp_s + r * bkv;
      for (int t = 0; t < bkv; ++t) {
        const int vw = v_s[t * HDW + dw];
        const int p = pr[t];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          a[e] += p * (int)(int8_t)((vw >> (8 * e)) & 0xff);
      }
      const float corr = c_s[r];
      float* ar = acc_s + r * HD + 4 * dw;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ar[e] = __fadd_rn(__fmul_rn(ar[e], corr),
                          __fmul_rn((float)a[e], inv127));
    }
    __syncthreads();  // logits, image and V block are consumed
  }

  // ---- int8 ctx image ----
  int8_t* og = out + row0 * HD;
  for (int i = tid; i < bq * HD; i += kThreads) {
    const float ctx = __fdiv_rn(acc_s[i], fmaxf(l_s[i / HD], 1e-9f));
    const float y = rintf(__fmul_rn(ctx, inv_eps));
    og[i] = (int8_t)fminf(fmaxf(y, -128.0f), 127.0f);
  }
}

template <int HD>
int launch(const int8_t* q, const int8_t* k, const int8_t* v, int8_t* out,
           float scale, float inv127, float inv_eps, int B, int H, int K,
           int n_rep, int S_q, int S_kv, int bq, int bkv, int q_offset,
           int causal, size_t smem, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        quant_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  quant_attn_kernel<HD><<<dim3(S_q / bq, B * H), kThreads, smem, stream>>>(
      q, k, v, out, scale, inv127, inv_eps, H, K, n_rep, S_q, S_kv, bq, bkv,
      q_offset, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, S_q, hd), k/v (B, K, S_kv, hd), out (B, H, S_q, hd), all int8
// and contiguous; S_q a multiple of bq, S_kv of bkv; smem: the dynamic
// shared bytes of the layout above.  Returns a cudaError_t.
extern "C" int quant_attention_launch(
    const int8_t* q, const int8_t* k, const int8_t* v, int8_t* out,
    float score_scale, float inv127, float inv_eps, int B, int H, int K,
    int n_rep, int S_q, int S_kv, int hd, int bq, int bkv, int q_offset,
    int causal, long long smem, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || S_q <= 0) return 0;
  if (bq <= 0 || bkv <= 0 || S_q % bq || S_kv % bkv ||
      (causal && q_offset < 0))
    return (int)cudaErrorInvalidValue;
#define QA_CASE(D)                                                         \
  case D:                                                                  \
    return launch<D>(q, k, v, out, score_scale, inv127, inv_eps, B, H, K,  \
                     n_rep, S_q, S_kv, bq, bkv, q_offset, causal,          \
                     (size_t)smem, stream);
  switch (hd) {
    QA_CASE(32)
    QA_CASE(64)
    QA_CASE(128)
    QA_CASE(192)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef QA_CASE
}
