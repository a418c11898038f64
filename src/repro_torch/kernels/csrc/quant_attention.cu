// Quantized flash attention with a per-block int8 probability image,
// for Hopper.
//
// Replaces the Pallas kernel repro/kernels/quant_attention.py
// (`_kernel` / `quant_flash_attention_pallas`) behind its GQA entry
// point repro/kernels/ops.py `quant_flash_attention`.  Per query row, a
// loop over the KV blocks (bkv keys each) takes the place of the TPU's
// sequential grid axis, carrying the running max m, normaliser l and
// f32 accumulator acc:
//
//   s      = q . k_j^T                            int32
//   logits = float(s) * score_scale, or -1e9 where key > query (causal)
//   m_new  = max(m, rowmax(logits));  p = expf(logits - m_new)
//   qp     = rint(127 p)                          int8 image
//   corr   = expf(m - m_new)
//   acc    = acc * corr + float(qp . v_j) * (1/127)   (int32 P.V)
//   l      = l * corr + float(sum qp) * (1/127)
//   out    = clip(rint(acc / max(l, 1e-9) * (1/eps_ctx)), -128, 127)
//
// Float island: compiled without fast math and with --fmad=false, and
// written with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, expf and
// round-half-to-even, so every step rounds once, in the order above,
// exactly like the plain PyTorch version (the constants are the float32
// of their doubles, rounded by the caller).  The row sum of qp is an
// integer sum, exact in any order.
//
// Two kernels, chosen by the wrapper from the shape alone
// (quant_attention.py `qfa_plan`):
//
// quant_attn_mma_kernel<HD, BKV> (bkv 32, 64 or 128): both products on
// the int8 tensor cores, mma.sync.m16n8k32.s32.s8.s8.s32, FlashAttention-2
// style.  A block is 4 warps of 16 query rows; under GQA the warps take
// up to 4 query heads of one kv head (same rows), so each K/V block is
// loaded once for them.  Per KV block:
//   - K and V come by cp.async into a double-buffered ring (the next
//     block's copy overlaps this block's work); Q's A fragments stay in
//     registers for the whole tile;
//   - scores: K's stored (key, hd) rows are the "col" B operand, fed by
//     ldmatrix; the whole bkv block of scores stays in registers
//     (bkv/2 int32 a thread);
//   - island in the accumulator fragments: row max over the complete
//     block (quad shuffles), then expf, the int8 image and the integer
//     qsum, then corr;
//   - P.V: the image goes from the score C fragment straight into the A
//     fragment.  A thread holds keys {2t, 2t+1, 8+2t, 9+2t, 16+2t, ...}
//     of a 32-key chunk in C but A wants {4t..4t+3, 16+4t..16+4t+3}, so
//     A column 4t+i holds key sigma(4t+i) = (i<2 ? 2t+i : 8+2t+i-2), and
//     +16 for the upper half.  V's rows
//     get the same permutation as V is transposed into the (hd, key)
//     layout the B operand needs (ldmatrix .trans does not move bytes):
//     P.V is an integer sum over keys, so the permutation is exact;
//   - int32 to float (scores, P.V) and rint(127 p) to the image byte go
//     through the float 1.5 * 2^23 on the full-rate lanes (exact for
//     |s| < 2^22: 128 * 128 * 192 and 127 * 128 * 128 are below it),
//     not through I2F / F2I, which share the quarter-rate pipe with
//     expf's MUFU.EX2.
//
// Three constraints of the per-block image, kept here:
//   1. The KV partition is fixed by bkv: qp depends on the running max
//      after the whole block, so the block's max is complete (all of its
//      scores in registers) before any expf of it.  No sub-tile max feeds
//      the exponent.
//   2. No split over KV: a flash-decoding split would change each
//      block's m_new and so the image.  Parallelism comes from query
//      rows, heads and batch only; the kernel's 16-row tiles are
//      independent of bq, which only sets the zero padding of S_q in the
//      plain version (padded rows are dropped, rows are independent, so
//      this kernel takes S_q unpadded).
//   3. Causal blocks past the tile's last row are skipped (by both
//      kernels), and a warp skips a block past its own last row.  That
//      is bit-equal to computing it: every row saw key 0 (q_offset >= 0, which the
//      wrapper requires), so m > -1e9 once key 0's logit is above -1e9
//      (the wrapper turns skipping off, `skip` = 0, where score_scale
//      could push a logit below that), and then p = expf(-1e9 - m) = 0,
//      qp = 0, corr = expf(0) = 1, and acc * 1 + 0 and l * 1 + 0 leave
//      acc and l as they are.  Inside the diagonal block the masked
//      entries are -1e9 by replacement.  bkv is a multiple of 32, so no
//      tensor-core tile is partial along keys; rows past S_q load zero
//      queries and are not stored.
//
// What bounds it on the H100: the int8 products (2 x 2 S_q S_kv hd
// operations under no mask) take ~0.14 ms at 8192 x 8192 causal, hd 64,
// 32 heads, at the tensor cores' 1,979 TOP/s, but the exact island does
// not run on them: ~1.07e9 accurate expf plus ~10 more f32/int
// instructions per visible score, ~20 lane-instructions each, at the
// card's ~3.35e13 lane-instructions/s (132 SMs x 128 lanes x ~1.98
// GHz) is ~0.64 ms.  That island floor, not the MMA, bounds this
// kernel; a faster MMA (wgmma) would not move it, and the compiled
// island takes more instructions per score than that estimate
// (tools/attn_ab.py --sass counts them).  Registers: scores bkv/2, acc
// hd/2, Q hd/8 a thread; shared memory 4 bkv (hd+16) + hd (bkv+16)
// bytes.
//
// quant_attn_kernel<HD> (any other bkv): the first version, on CUDA
// cores.  One block per (query block of bq rows, batch-head bh); scores
// by dp4a with one key row per thread, the island one warp per query
// row through f32 logits in shared memory, P.V as scalar multiply-adds
// over a V block staged in shared memory.  Its bytes (q, K, V read once
// per query block, out) are small against its operations.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------
// tensor-core kernel
// ---------------------------------------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// four 8x8 b16 matrices = four (8 rows x 16 bytes) int8 tiles; lane l
// gives the row address of matrix l / 8, row l % 8, and receives from
// each matrix the 4 bytes at row lane / 4, bytes 4 (lane % 4)..+3
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 s32) += a (16x32 s8, row) . b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Exact conversions on the full-rate float/int lanes instead of I2F and
// F2I, which share the quarter-rate pipe with expf's MUFU.EX2.  The
// float 1.5 * 2^23 has bits 0x4B400000 and a unit last place, so for
// |s| < 2^22 its bits plus s are the float 1.5 * 2^23 + s, and
// subtracting 1.5 * 2^23 again leaves float(s) exactly.
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kMagicBits = 0x4B400000;

__device__ __forceinline__ float int_to_float(int s) {  // |s| < 2^22
  return __fsub_rn(__int_as_float(kMagicBits + s), kMagic);
}

// The reverse: y + 1.5 * 2^23 rounds y to an integer, half to even
// (rint), and for 0 <= y < 256 that integer is the low byte of the bits.
__device__ __forceinline__ uint32_t rint_bits(float y) {  // 0 <= y < 256
  return (uint32_t)__float_as_int(__fadd_rn(y, kMagic));
}

// the low bytes of four rint_bits as one A-fragment register
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b,
                                          uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

template <int HD, int BKV>
__global__ void __launch_bounds__(kMmaThreads)
quant_attn_mma_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ k,
                      const int8_t* __restrict__ v, int8_t* __restrict__ out,
                      float scale, float inv127, float inv_eps, int H, int K,
                      int n_rep, int S_q, int S_kv, int q_offset, int causal,
                      int skip, int wh) {
  constexpr int KS = HD + 16;    // K / V row stride in shared memory
  constexpr int VTS = BKV + 16;  // transposed V row stride
  constexpr int STAGE = BKV * KS;
  constexpr int NT = BKV / 8;    // score n-tiles (8 keys)
  constexpr int KC = HD / 32;    // score k-steps (32 hd)
  constexpr int PC = BKV / 32;   // P.V k-steps (32 keys)
  constexpr int DT = HD / 8;     // P.V n-tiles (8 hd columns)
  extern __shared__ __align__(16) unsigned char mma_smem[];
  int8_t* smem = reinterpret_cast<int8_t*>(mma_smem);
  int8_t* ks = smem;               // [2][BKV][KS]  K ring
  int8_t* vs = smem + 2 * STAGE;   // [2][BKV][KS]  V ring, as stored
  int8_t* vt = smem + 4 * STAGE;   // [HD][VTS]     V^T, keys permuted

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rows = 16 * (4 / wh);  // query rows of the block
  const int rt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int groups = n_rep / wh;
  const int bk = blockIdx.y / groups;  // b * K + kv head
  const int b = bk / K;
  const int h = (bk % K) * n_rep + (blockIdx.y % groups) * wh + warp % wh;
  const int r0 = rt * rows + (warp / wh) * 16;  // this warp's first row
  const int8_t* qg = q + ((long long)b * H + h) * S_q * HD;
  const int8_t* kg = k + (long long)bk * S_kv * HD;
  const int8_t* vg = v + (long long)bk * S_kv * HD;
  const int ra = r0 + g, rb = ra + 8;  // the thread's two rows
  const int pa = q_offset + ra, pb = q_offset + rb;

  // Q's A fragments, once per tile (rows past S_q are zero)
  uint32_t qa[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int col = 32 * c + 4 * t;
    qa[c][0] = ra < S_q ? *(const uint32_t*)(qg + (long long)ra * HD + col) : 0u;
    qa[c][1] = rb < S_q ? *(const uint32_t*)(qg + (long long)rb * HD + col) : 0u;
    qa[c][2] = ra < S_q ? *(const uint32_t*)(qg + (long long)ra * HD + col + 16) : 0u;
    qa[c][3] = rb < S_q ? *(const uint32_t*)(qg + (long long)rb * HD + col + 16) : 0u;
  }

  float acc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[d][e] = 0.0f;
  float m0 = -1e9f, m1 = -1e9f, l0 = 0.0f, l1 = 0.0f;

  int n_kv = S_kv / BKV;
  const int warp_last = q_offset + min(r0 + 15, S_q - 1);
  if (causal && skip) {
    const int block_last = q_offset + min(rt * rows + rows, S_q) - 1;
    n_kv = min(n_kv, block_last / BKV + 1);
  }

  auto load = [&](int j) {
    const int8_t* kb = kg + (long long)j * BKV * HD;
    const int8_t* vb = vg + (long long)j * BKV * HD;
    int8_t* kd = ks + (j & 1) * STAGE;
    int8_t* vd = vs + (j & 1) * STAGE;
    for (int i = tid; i < BKV * HD / 16; i += kMmaThreads) {
      const int r = i / (HD / 16), c = i % (HD / 16);
      cp_async16(kd + r * KS + 16 * c, kb + 16 * i);
      cp_async16(vd + r * KS + 16 * c, vb + 16 * i);
    }
    cp_async_commit();
  };

  if (n_kv > 0) load(0);
  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait_all();
    __syncthreads();  // block j landed; every warp is done with j - 1
    if (j + 1 < n_kv) load(j + 1);

    // ---- V^T with keys permuted: vt[d][32c + 4u + i] = v[32c + key_i][d]
    // for keys {base, base+1, base+8, base+9}, base = 16 (u / 4) +
    // 2 (u % 4); one 4 x 4 byte transpose per (c, u, 4 hd columns)
    {
      const int8_t* vsrc = vs + (j & 1) * STAGE;
      for (int i = tid; i < BKV * HD / 16; i += kMmaThreads) {
        const int u = i & 7, rest = i >> 5;
        const int c = rest % PC;
        const int d4 = (rest / PC) * 4 + ((i >> 3) & 3);
        const int key = 32 * c + 4 * (u & 4) + 2 * (u & 3);
        const int8_t* src = vsrc + key * KS + 4 * d4;
        const uint32_t w0 = *(const uint32_t*)src;
        const uint32_t w1 = *(const uint32_t*)(src + KS);
        const uint32_t w2 = *(const uint32_t*)(src + 8 * KS);
        const uint32_t w3 = *(const uint32_t*)(src + 9 * KS);
        const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
        const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
        const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
        const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
        int8_t* dst = vt + 4 * d4 * VTS + 32 * c + 4 * u;
        *(uint32_t*)dst = __byte_perm(t0, t2, 0x5410);
        *(uint32_t*)(dst + VTS) = __byte_perm(t0, t2, 0x7632);
        *(uint32_t*)(dst + 2 * VTS) = __byte_perm(t1, t3, 0x5410);
        *(uint32_t*)(dst + 3 * VTS) = __byte_perm(t1, t3, 0x7632);
      }
    }

    const int key0 = j * BKV;
    // a block wholly past this warp's last row changes nothing (note 3)
    const bool active = !(causal && skip) || key0 <= warp_last;
    uint32_t pfrag[PC][4];
    float corr0 = 1.0f, corr1 = 1.0f;
    if (active) {
      // ---- scores: s[n][.] = rows (g, g+8) x keys 8n + 2t + {0, 1}
      int s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0;
      const int8_t* kt = ks + (j & 1) * STAGE;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t bf[4];
          // matrices: keys 8n+0..7 at hd 32c and 32c+16, keys 8n+8..15
          ldsm_x4(bf, kt + (8 * n + (lane >> 4) * 8 + (lane & 7)) * KS +
                          32 * c + ((lane >> 3) & 1) * 16);
          mma_s8(s[n], qa[c], bf[0], bf[1]);
          mma_s8(s[n + 1], qa[c], bf[2], bf[3]);
        }
      }

      // ---- island: logits, the block's row max, then the image
      float lg[NT][4];
      const bool diag = causal && key0 + BKV - 1 > q_offset + r0;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = __fmul_rn(int_to_float(s[n][e]), scale);
          if (diag) {
            const int key = key0 + 8 * n + 2 * t + (e & 1);
            if (key > (e < 2 ? pa : pb)) x = -1e9f;
          }
          lg[n][e] = x;
        }
        mx0 = fmaxf(mx0, fmaxf(lg[n][0], lg[n][1]));
        mx1 = fmaxf(mx1, fmaxf(lg[n][2], lg[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // image qp = rint(127 p) in the low byte of img; p <= 1
      uint32_t img[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(__fsub_rn(lg[n][e], e < 2 ? mn0 : mn1));
          img[n][e] = rint_bits(__fmul_rn(p, 127.0f));
        }
      // A fragments of the image, keys in the order sigma (header); the
      // row sums of qp from the packed bytes
      uint32_t qs0 = 0, qs1 = 0;
#pragma unroll
      for (int c = 0; c < PC; ++c) {
        const int n = 4 * c;
        pfrag[c][0] = pack4(img[n][0], img[n][1], img[n + 1][0], img[n + 1][1]);
        pfrag[c][1] = pack4(img[n][2], img[n][3], img[n + 1][2], img[n + 1][3]);
        pfrag[c][2] = pack4(img[n + 2][0], img[n + 2][1], img[n + 3][0], img[n + 3][1]);
        pfrag[c][3] = pack4(img[n + 2][2], img[n + 2][3], img[n + 3][2], img[n + 3][3]);
        qs0 = __dp4a(pfrag[c][0], 0x01010101u,
                     __dp4a(pfrag[c][2], 0x01010101u, qs0));
        qs1 = __dp4a(pfrag[c][1], 0x01010101u,
                     __dp4a(pfrag[c][3], 0x01010101u, qs1));
      }
      qs0 += __shfl_xor_sync(0xffffffffu, qs0, 1);
      qs1 += __shfl_xor_sync(0xffffffffu, qs1, 1);
      qs0 += __shfl_xor_sync(0xffffffffu, qs0, 2);
      qs1 += __shfl_xor_sync(0xffffffffu, qs1, 2);
      corr0 = expf(__fsub_rn(m0, mn0));
      corr1 = expf(__fsub_rn(m1, mn1));
      l0 = __fadd_rn(__fmul_rn(l0, corr0),
                     __fmul_rn(int_to_float((int)qs0), inv127));
      l1 = __fadd_rn(__fmul_rn(l1, corr1),
                     __fmul_rn(int_to_float((int)qs1), inv127));
      m0 = mn0;
      m1 = mn1;
    }
    __syncthreads();  // V^T is in place

    if (active) {
      // ---- P.V on the tensor cores, folded into acc 16 columns at a time
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        int pv[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
        for (int c = 0; c < PC; ++c) {
          uint32_t bf[4];
          // matrices: hd rows 8d+0..7 at keys 32c and 32c+16, rows 8d+8..15
          ldsm_x4(bf, vt + (8 * d + (lane >> 4) * 8 + (lane & 7)) * VTS +
                          32 * c + ((lane >> 3) & 1) * 16);
          mma_s8(pv[0], pfrag[c], bf[0], bf[1]);
          mma_s8(pv[1], pfrag[c], bf[2], bf[3]);
        }
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[d + x][e] =
                __fadd_rn(__fmul_rn(acc[d + x][e], e < 2 ? corr0 : corr1),
                          __fmul_rn(int_to_float(pv[x][e]), inv127));
      }
    }
  }

  // ---- int8 ctx image: rows (g, g+8), columns 8d + 2t + {0, 1}
  const float den0 = fmaxf(l0, 1e-9f), den1 = fmaxf(l1, 1e-9f);
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    int o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float ctx = __fdiv_rn(acc[d][e], e < 2 ? den0 : den1);
      const float y = rintf(__fmul_rn(ctx, inv_eps));
      o[e] = (int)fminf(fmaxf(y, -128.0f), 127.0f);
    }
    const int col = 8 * d + 2 * t;
    if (ra < S_q)
      *(uint16_t*)(out + ((long long)(b * H + h) * S_q + ra) * HD + col) =
          (uint16_t)((o[0] & 0xff) | ((o[1] & 0xff) << 8));
    if (rb < S_q)
      *(uint16_t*)(out + ((long long)(b * H + h) * S_q + rb) * HD + col) =
          (uint16_t)((o[2] & 0xff) | ((o[3] & 0xff) << 8));
  }
}

template <int HD, int BKV>
int launch_mma(const int8_t* q, const int8_t* k, const int8_t* v,
               int8_t* out, float scale, float inv127, float inv_eps, int B,
               int H, int K, int n_rep, int S_q, int S_kv, int q_offset,
               int causal, int skip, int wh, size_t smem,
               cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        quant_attn_mma_kernel<HD, BKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int rows = 16 * (4 / wh);
  const dim3 grid((S_q + rows - 1) / rows, B * K * (n_rep / wh));
  quant_attn_mma_kernel<HD, BKV><<<grid, kMmaThreads, smem, stream>>>(
      q, k, v, out, scale, inv127, inv_eps, H, K, n_rep, S_q, S_kv,
      q_offset, causal, skip, wh);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_mma_bkv(const int8_t* q, const int8_t* k, const int8_t* v,
                   int8_t* out, float scale, float inv127, float inv_eps,
                   int B, int H, int K, int n_rep, int S_q, int S_kv,
                   int bkv, int q_offset, int causal, int skip, int wh,
                   size_t smem, cudaStream_t stream) {
  switch (bkv) {
    case 32:
      return launch_mma<HD, 32>(q, k, v, out, scale, inv127, inv_eps, B, H,
                                K, n_rep, S_q, S_kv, q_offset, causal, skip,
                                wh, smem, stream);
    case 64:
      return launch_mma<HD, 64>(q, k, v, out, scale, inv127, inv_eps, B, H,
                                K, n_rep, S_q, S_kv, q_offset, causal, skip,
                                wh, smem, stream);
    case 128:
      return launch_mma<HD, 128>(q, k, v, out, scale, inv127, inv_eps, B, H,
                                 K, n_rep, S_q, S_kv, q_offset, causal, skip,
                                 wh, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------
// CUDA-core kernel (the first version): the path for every other bkv
// ---------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr float kNegInf = -1e9f;

template <int HD>
__global__ void __launch_bounds__(kThreads)
quant_attn_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                  const int8_t* __restrict__ v, int8_t* __restrict__ out,
                  float scale, float inv127, float inv_eps, int H, int K,
                  int n_rep, int S_q, int S_kv, int bq, int bkv,
                  int q_offset, int causal, int skip) {
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
  if (causal && skip) n_kv = min(n_kv, (q0 + bq - 1) / bkv + 1);  // note 3
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
int launch_simt(const int8_t* q, const int8_t* k, const int8_t* v, int8_t* out,
           float scale, float inv127, float inv_eps, int B, int H, int K,
           int n_rep, int S_q, int S_kv, int bq, int bkv, int q_offset,
           int causal, int skip, size_t smem, cudaStream_t stream) {
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
      q_offset, causal, skip);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, H, S_q, hd), k/v (B, K, S_kv, hd), out (B, H, S_q, hd), all int8
// and contiguous; S_kv a multiple of bkv; smem: the dynamic shared bytes
// of the chosen kernel's layout.  mma != 0: the tensor-core kernel (bkv
// 32, 64 or 128; wh query heads of one kv head per block, wh in {1, 2,
// 4} dividing n_rep; S_q any).  mma == 0: the CUDA-core kernel (S_q a
// multiple of bq).  skip: either kernel may skip causal blocks past a
// tile (note 3).
// Returns a cudaError_t.
extern "C" int quant_attention_launch(
    const int8_t* q, const int8_t* k, const int8_t* v, int8_t* out,
    float score_scale, float inv127, float inv_eps, int B, int H, int K,
    int n_rep, int S_q, int S_kv, int hd, int bq, int bkv, int q_offset,
    int causal, int mma, int wh, int skip, long long smem,
    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || S_q <= 0) return 0;
  if (bkv <= 0 || S_kv % bkv || (causal && q_offset < 0))
    return (int)cudaErrorInvalidValue;
  if (mma) {
    if ((wh != 1 && wh != 2 && wh != 4) || n_rep % wh)
      return (int)cudaErrorInvalidValue;
#define QA_MMA_CASE(D)                                                     \
  case D:                                                                  \
    return launch_mma_bkv<D>(q, k, v, out, score_scale, inv127, inv_eps,   \
                             B, H, K, n_rep, S_q, S_kv, bkv, q_offset,     \
                             causal, skip, wh, (size_t)smem, stream);
    switch (hd) {
      QA_MMA_CASE(32)
      QA_MMA_CASE(64)
      QA_MMA_CASE(128)
      QA_MMA_CASE(192)
      default:
        return (int)cudaErrorInvalidValue;
    }
#undef QA_MMA_CASE
  }
  if (bq <= 0 || S_q % bq) return (int)cudaErrorInvalidValue;
#define QA_CASE(D)                                                         \
  case D:                                                                  \
    return launch_simt<D>(q, k, v, out, score_scale, inv127, inv_eps, B,   \
                          H, K, n_rep, S_q, S_kv, bq, bkv, q_offset,       \
                          causal, skip, (size_t)smem, stream);
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
