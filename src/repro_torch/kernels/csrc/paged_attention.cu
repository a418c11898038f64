// Unified (S, T) int8 paged attention over the paged KV arena, for
// Hopper, over int8 pools and int4-packed ones.
//
// Replaces the Pallas kernel repro/kernels/paged_attention.py
// (`_kernel` / `paged_attention_pallas`), both pool modes.  For slot b
// and query head h:
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
// tokens): a row's max and sum cover all of its keys before any image.
//
// Float island: compiled without fast math and with --fmad=false, and
// written with explicit __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, so each
// logit, exponent and quotient rounds exactly like the plain PyTorch
// version (torch's CUDA expf is the same libdevice expf).  The row sum
// runs in a fixed order that the plain version reproduces (`_lane_sum`):
// 32 partials, partial l adding the keys t = l (mod 32) in increasing t,
// then a xor butterfly over the partials (offsets 16, 8, 4, 2, 1).  So
// on the card the two images agree bit for bit; the optional qp_out
// image lets a check count the quanta that moved (`check_image`).
//
// One kernel for both pool modes, launched as paged_attn_mma_kernel<HD,
// WC, RT, KEEP> over int8 pools and paged_attn_mma_packed_kernel<HD, WC,
// RT, KEEP> over int4-packed ones (two names, so a profile tells them
// apart); both run the body paged_attn_mma<HD, WC, RT, KEEP, PACKED>,
// which differs between the modes only where pool bytes are read, with
// the launch kernels/paged_attention.py `paged_plan` picks.
//
// The group's query heads and rows are stacked as rows r = g * S + i (g
// the head in the group), so a kv head's pages serve the whole group;
// one m16 tile holds 16 of those rows (decode at group 4: 4 rows).  A
// block takes one slot, one kv head and RT row tiles, with WC warps on
// each tile splitting its keys: a staged tile holds 32 WC keys, one
// 32-key chunk a warp, and is read once for all RT tiles.  Decode takes
// (WC, RT) = (8, 1), chunked prefill (4, 2): 8 warps either way.  The
// scores are int8 tensor-core products (mma.sync.m16n8k32.s32.s8.s8.s32,
// K's stored (key, hd) rows the "col" B operand, Q's A fragments in
// registers).  Three passes over the keys:
//   pass 0  scores and logits; the row max (fmaxf: exact in any
//           order), combined over the row tile's warps in shared
//           memory.  KEEP: the logits stay in shared memory (f32, the
//           block's rows below M over T);
//   pass 1  p = expf(x - max), and the row sum in `_lane_sum`'s order:
//           the warp that owns a row (16 / WC rows a warp) adds, lane l
//           to partial l, column l of each 32-key chunk, chunk after
//           chunk, then the butterfly.  The 32 partials are independent,
//           so which warp owns a row and when it adds are free, as long
//           as each partial adds its keys in increasing t.  KEEP: from
//           the kept logits, p written back in place; else the scores
//           are taken again and each tile's p staged for the owners;
//   pass 2  the image rint(127 * (p / sum)) in the score C fragment (p
//           read back, or recomputed), then P.V on the tensor cores: a
//           lane holds keys {2t, 2t+1, 8+2t, 9+2t, ...} of its chunk in C
//           but the A operand wants {4t..4t+3, ...}, so A column 4t+i
//           holds key sigma(4t+i) = (i<2 ? 2t+i : 8+2t+i-2) (+16 for the
//           upper half), and V's keys take the same permutation as V is
//           transposed into shared memory (the B operand wants (hd, key)
//           rows); P.V is an integer sum over keys, so the permutation
//           is exact.  The WC warps' int32 partial products are added at
//           the end.
// KEEP loads each K and V tile once (pass 0, pass 2) and takes one
// expf a score; without it (long T: the logits do not fit) K is read
// in every pass and expf taken twice.  K and V pages come by cp.async
// into a ring of `stages` tiles through the page table (clamped to the
// pool for memory safety); a page of one kv head is one contiguous
// ps * row run.  A warp whose tile has no valid row g + 8 (decode)
// skips that half's island.  int32 to float and rint to the image byte
// go through the float 1.5 * 2^23 on the full-rate lanes: exact for
// |s| < 2^22, and here |s| <= 128 * 128 * 128 = 2^21.
//
// Int8 pools: the ring holds hd-byte rows; K's B fragments come by
// ldmatrix, V is transposed as it stands.
//
// Int4-packed pools: a pool row holds hd/2 bytes, two int4 nibbles each
// (element 2i in the low nibble), and its int8 image is the kv head's
// requant column of k_rq / v_rq ((6, K) int32: m, s0, lo, hi, d, zp)
// applied to each nibble: clip to [lo, hi], >> s0, * m, >> (d - s0),
// + zp, clip to [-128, 127], in wrapping int32 (the reference's
// `page_kv`).  A block serves one kv head, so that image is a function
// of the nibble alone: 32 lanes evaluate it once for each of the 16
// nibble values of K and of V (`Unpack::one`: the same function on the
// same inputs, so exact, wrapping included) into two 16-byte tables,
// and every later expansion is a lookup.  The little-endian u16 at
// packed byte 2i holds elements 4i..4i+3, element 4i+j in bits
// 4j..4j+3: exactly the selector of a byte permute, so 4 elements take
// two permutes over the table's halves and a per-byte select on each
// nibble's top bit (`unpack4`, 6 steps).  The ring holds the packed
// rows (hd/2 bytes: 16, 32 or 64, whole 16-byte vectors), half the
// bytes of an int8 tile.  K needs no int8 tile: the dot over hd is an
// integer sum, so any order of hd inside a 32-wide k-step is exact as
// long as Q and K agree.  Packed, lane t's k-columns 4t..4t+3 and
// 16+4t..16+4t+3 hold hd 8t..8t+3 and 8t+4..8t+7, so its two B
// registers for a key are the two u16 halves of the 4 bytes at packed
// byte 4t of that key's row: one shared load and two lookups (Q's A
// fragments are loaded in the same hd order).  V is expanded where it
// is transposed into V^T: four u16 of four keys through the V table,
// then the int8 mode's byte transpose.  Everything after is the int8
// mode's.
//
// The causal horizon stop.  Row i of slot b needs keys t <= pos[b] + i;
// the block loads and scores keys t < min(T, pos[b] + i_max + 1) only,
// i_max its last row's i.  That is bit-equal to scoring all T keys
// while every masked logit lands at least ~104 below the row max, so
// that expf gives 0.0f (adding 0.0f leaves a partial as it is, the
// image is 0, P.V gains nothing) and no masked logit is the max.  With
// A = |score_scale| * 128 * 128 * hd, every logit of a visible key lies
// in [-A', A'], A' = A (1 + 2^-24) (one rounding of the product); a
// masked one is fl(x - 1e9) <= A' - 1e9 + 32 (half an ulp below 2^30);
// key 0 is visible to every row (pos >= 0), so the max is >= -A'; the
// difference rounds to at most 2 A' - 1e9 + 64.  expf of anything
// below -104 is 0.0f, so 2 A' + 168 < 1e9, i.e. A < ~4.9999988e8, is
// enough; the kernel stops only while A <= kStopGuard = 4.9e8, read
// on the device from *score_scale (the engine's scale is a device
// tensor; the wrapper adds no host sync), and only for pos[b] >= 0.
// Rows parked at INACTIVE_POS see all T.  Unpacked images lie in
// [-128, 127] too, so the guard holds for both pool modes.
//
// What bounds it on the H100: not bytes (chip_smoke.py's bytes bound,
// one read of a slot's K and V up to its horizon, is 15-30x below its
// time) and not the tensor cores, but how many of its dependent steps
// an SM overlaps: each block runs a chain of ring waits, barriers and
// the exact island (accurate expf, IEEE division; about 50
// lane-instructions a visible score with the logits kept and 90
// recomputed, an estimate from the source), with 16 warps an SM.  Blocks
// of 32 rows halve the chunked-prefill grid to one wave and share each
// staged tile; decode has 64 blocks for 132 SMs, 8 warps each
// (`tools/attn_ab.py --sweep [--packed]` times each plan).  The packed
// mode adds its lookups, 6 steps for 4 elements of K or V.  Registers:
// Q hd/8, P.V hd/2 a thread (packed: 4 more for the K table); shared
// memory: the ring, the packed mode's two tables, V^T hd (32 WC + 16),
// the f32 rows, the page table (`paged_plan`).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the horizon stop is exact while |score_scale| * 128 * 128 * hd stays
// at or below this (header)
constexpr float kStopGuard = 4.9e8f;

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

// wait until at most `pending` (0, 1 or 2) committed groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
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
// F2I.  The float 1.5 * 2^23 has bits 0x4B400000 and a unit last place,
// so for |s| < 2^22 its bits plus s are the float 1.5 * 2^23 + s, and
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

// arithmetic shift right; shifts of 31 and more (and negative ones) give
// the sign, as in the requant kernel
__device__ __forceinline__ int sra(int x, int s) {
  return (unsigned)s >= 31u ? (x >> 31) : (x >> s);
}

// one kv head's unpack requant column (rows of the (6, K) operand)
struct Unpack {
  int m, s0, lo, hi, d, zp;
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
};

// PTX prmt in its default mode: byte j of the result is byte c[4j+2:4j]
// of {b, a} (a's bytes 0-3, b's 4-7), or where c[4j+3] is set that
// byte's sign bit replicated; c[31:16] is not read
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t c) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Four nibbles (c[15:0], element j in bits 4j..4j+3) -> the word of
// their four int8 images (element j in byte j) through a 16-byte table
// (the image of nibble n in byte n % 4 of tb[n / 4]): entries 0-7 by one
// permute (right where a nibble's bit 3 is clear), 8-15 by another with
// bit 3 flipped (right where it is set), and the mask of the nibbles
// whose bit 3 is set from sign bits: bytes 0 and 1 of c << 4 carry
// nibbles 0 and 2's bit 3 in their sign bits, bytes 0 and 1 of c
// nibbles 1 and 3's
__device__ __forceinline__ uint32_t unpack4(uint32_t c,
                                            const uint32_t (&tb)[4]) {
  const uint32_t lo = prmt(tb[0], tb[1], c);
  const uint32_t hi = prmt(tb[2], tb[3], c ^ 0x8888u);
  const uint32_t m = prmt(c << 4, c, 0xD9C8u);
  return (lo & ~m) | (hi & m);
}

#define PA_PARAMS                                                         \
  const int8_t *__restrict__ q, const int8_t *__restrict__ k_pool,        \
      const int8_t *__restrict__ v_pool, const int32_t *__restrict__ table, \
      const int32_t *__restrict__ pos,                                    \
      const float *__restrict__ score_scale, int32_t *__restrict__ out,   \
      int8_t *__restrict__ qp_out, const int32_t *__restrict__ k_rq,      \
      const int32_t *__restrict__ v_rq, int H, int S, int K, int ps,      \
      int pps, int group, int n_pool, int stages
#define PA_ARGS                                                          \
  q, k_pool, v_pool, table, pos, score_scale, out, qp_out, k_rq, v_rq, H, \
      S, K, ps, pps, group, n_pool, stages

// k_rq / v_rq: the (6, K) unpack operands (PACKED only)
template <int HD, int WC, int RT, bool KEEP, bool PACKED>
__device__ __forceinline__ void paged_attn_mma(PA_PARAMS) {
  constexpr int W = WC * RT;        // warps: WC on each of RT row tiles
  constexpr int NTH = 32 * W;       // threads
  constexpr int BT = 32 * WC;       // keys of a staged tile, a chunk a warp
  constexpr int ROWS = 16 * RT;     // the block's rows
  constexpr int ROW = PACKED ? HD / 2 : HD;  // bytes of a pool row
  constexpr int KS = ROW + 16;      // staged K / V row stride
  constexpr int VTS = BT + 16;      // V^T row stride
  constexpr int RST = HD + 8;       // P.V reduction row stride (ints)
  // one ring slot: a K or a V tile (KEEP), else a K tile and a V tile
  constexpr int BUF = (KEEP ? 1 : 2) * BT * KS;
  constexpr int KC = HD / 32;       // score k-steps (32 hd)
  constexpr int DT = HD / 8;        // P.V n-tiles (8 hd columns)
  constexpr int RPW = 16 / WC;      // rows whose partials a warp owns
  const int T = pps * ps;
  const int M = group * S;          // the group's stacked rows
  // f32 rows: KEEP, the logits (then p) of the block's rows below M
  // over every tile of T; else a staging tile of one stage's p
  const int LR = KEEP ? min(ROWS, M) : ROWS;
  const int LST = (KEEP ? (T + BT - 1) / BT * BT : BT) + 8;
  extern __shared__ __align__(16) unsigned char pa_smem[];
  // shared layout (`paged_plan` sizes it the same way):
  //   ring (stages x BUF) | unpack tables (PACKED: K, V, 16 bytes each)
  //   | V^T (HD x VTS) | f32 rows (LR x LST) | row maxima (W x 16 f32) |
  //   row sums (ROWS f32) | page table (pps ints); the P.V reduction
  //   (W x 16 x RST ints) reuses the space from the start
  int8_t* ring = reinterpret_cast<int8_t*>(pa_smem);
  int8_t* ut = ring + stages * BUF;
  int8_t* vt = ut + (PACKED ? 32 : 0);
  float* lg = reinterpret_cast<float*>(vt + HD * VTS);
  float* mx_s = lg + LR * LST;
  float* sum_s = mx_s + 16 * W;
  int* tab_s = reinterpret_cast<int*>(sum_s + ROWS);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rt = warp / WC, wc = warp % WC;  // the warp's row tile, chunk
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int rB = ROWS * blockIdx.y;  // the block's first row
  const int r0 = rB + 16 * rt;       // the warp's row tile's first row
  // row r of the group is row (row0 + r) of q / out viewed (B*H*S, hd)
  const long long row0 = ((long long)b * H + (long long)kh * group) * S;
  const int ra = r0 + g, rb = ra + 8;  // the thread's two rows
  const int la = 16 * rt + g, lb = la + 8;  // and their rows in lg
  // warp-uniform: whether any row g + 8 of the tile is below M (decode
  // at group 4 fills rows 0-3 only; the upper half's work is skipped)
  const int ne = r0 + 8 < M ? 4 : 2;
  const float scale = *score_scale;
  const int pos_b = pos[b];
  const int pa = pos_b + ra % S, pb = pos_b + rb % S;

  // the horizon stop (header): keys [0, lim) are loaded and scored
  const int r_last = min(rB + ROWS - 1, M - 1);
  const int i_max = r_last / S != rB / S ? S - 1 : r_last % S;
  const bool stop =
      pos_b >= 0 && fabsf(scale) * (16384.0f * HD) <= kStopGuard;
  const int lim =
      stop ? (int)min((long long)T, (long long)pos_b + i_max + 1) : T;
  const int n_tiles = (lim + BT - 1) / BT;
  // stages: pass * n_tiles + tile over the passes that load: 0 and 2
  // (KEEP: K tiles, then V tiles; pass 1 runs from shared memory), or
  // 0, 1 and 2 (each a K tile, pass 2 also a V tile)
  const int total = (KEEP ? 2 : 3) * n_tiles;
  auto pass_of = [&](int s) {
    const int p = s / n_tiles;
    return KEEP ? 2 * p : p;
  };

  for (int i = tid; i < pps; i += NTH) {
    const int p = table[(long long)b * pps + i];
    tab_s[i] = min(max(p, 0), n_pool - 1);  // memory safety only
  }
  if (PACKED && tid < 32) {  // the image of each nibble value, K then V
    const Unpack un(tid < 16 ? k_rq : v_rq, K, kh);
    ut[tid] = (int8_t)un.one(((tid & 15) ^ 8) - 8);
  }

  // Q's A fragments (rows past M are zero); packed, in the hd order of
  // the K fragments (header): hd 8t..8t+3 and 8t+4..8t+7 of each k-step
  const int8_t* qg = q + row0 * HD;
  const bool va = ra < M, vb = rb < M;
  constexpr int QHI = PACKED ? 4 : 16;  // a2/a3's hd past a0/a1's
  uint32_t qa[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    const int col = 32 * c + (PACKED ? 8 : 4) * t;
    qa[c][0] = va ? *(const uint32_t*)(qg + (long long)ra * HD + col) : 0u;
    qa[c][1] = vb ? *(const uint32_t*)(qg + (long long)rb * HD + col) : 0u;
    qa[c][2] =
        va ? *(const uint32_t*)(qg + (long long)ra * HD + col + QHI) : 0u;
    qa[c][3] =
        vb ? *(const uint32_t*)(qg + (long long)rb * HD + col + QHI) : 0u;
  }
  __syncthreads();  // the page table (and the unpack tables) in place
  uint32_t tk[4];   // PACKED: the K table
  if (PACKED) {
    const uint4 w = *reinterpret_cast<const uint4*>(ut);
    tk[0] = w.x;
    tk[1] = w.y;
    tk[2] = w.z;
    tk[3] = w.w;
  }

  const bool pow2 = (ps & (ps - 1)) == 0;  // pages of 2^ps_log keys
  const int ps_log = __ffs(ps) - 1;
  auto load = [&](int s) {
    if (s < total) {
      const int pass = pass_of(s), key0 = (s % n_tiles) * BT;
      int8_t* kd = ring + (s % stages) * BUF;
      int8_t* vd = KEEP ? kd : kd + BT * KS;
      for (int i = tid; i < BT * (ROW / 16); i += NTH) {
        const int r = i / (ROW / 16), c = i % (ROW / 16);
        const int key = key0 + r;
        if (key < lim) {
          const int page = pow2 ? key >> ps_log : key / ps;
          const int in_page = pow2 ? key & (ps - 1) : key % ps;
          const long long off =
              (((long long)tab_s[page] * K + kh) * ps + in_page) * ROW +
              16 * c;
          if (!KEEP || pass == 0)
            cp_async16(kd + r * KS + 16 * c, k_pool + off);
          if (pass == 2) cp_async16(vd + r * KS + 16 * c, v_pool + off);
        }
      }
    }
    cp_async_commit();  // empty past the last stage, so the waits count right
  };

  // logit of score sv at key for a row at position prow, the plain
  // version's order: float(s) * scale, then + 0 or + -1e9
  auto logit = [&](int sv, int key, int prow) {
    return __fadd_rn(__fmul_rn(int_to_float(sv), scale),
                     key <= prow ? 0.0f : -1e9f);
  };

  float m0 = -INFINITY, m1 = -INFINITY;  // rows ra, rb: max, then all WC's
  float sum0 = 1.0f, sum1 = 1.0f;
  float part[RPW];
#pragma unroll
  for (int x = 0; x < RPW; ++x) part[x] = 0.0f;
  int pv[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) pv[d][e] = 0;

  // the butterfly over the 32 partials of row lr, its sum into shared
  // memory
  auto row_sum = [&](float v, int lr) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) sum_s[lr] = v;
  };

  for (int s = 0; s < stages - 1; ++s) load(s);
  for (int s = 0; s < total; ++s) {
    cp_async_wait(stages - 2);
    __syncthreads();  // stage s landed; every warp is done with s - 1
    load(s + stages - 1);
    const int pass = pass_of(s), j = s % n_tiles;
    const int8_t* kt = ring + (s % stages) * BUF;
    if (!KEEP && j == 0 && pass == 1) {  // pass 0's maxima, the row tile's
#pragma unroll
      for (int w = 0; w < WC; ++w) {
        m0 = fmaxf(m0, mx_s[16 * (WC * rt + w) + g]);
        m1 = fmaxf(m1, mx_s[16 * (WC * rt + w) + g + 8]);
      }
    }
    if (KEEP && j == 0 && pass == 2) {
      // ---- pass 1 from shared memory, by the warp that owns a row:
      // p = expf(x - max) in place over the 32-key chunks below lim,
      // lane l adding column l of each chunk to the row's partial l,
      // chunk after chunk (0 past lim and in rows past M: adding it is
      // exact, and those rows' sums and images are never stored)
      const int L = (lim + 31) / 32 * 32;
#pragma unroll
      for (int x = 0; x < RPW; ++x) {
        const int lr = 16 * rt + RPW * wc + x;
        if (lr < LR) {
          const bool valid = lr < M - rB;
          float m = -INFINITY;
#pragma unroll
          for (int w = 0; w < WC; ++w)
            m = fmaxf(m, mx_s[16 * (WC * rt + w) + lr % 16]);
          float* row = lg + lr * LST + lane;
          float part = 0.0f;
#pragma unroll 4
          for (int key = 0; key < L; key += 32) {
            const float p = valid && key + lane < lim
                                ? expf(__fsub_rn(row[key], m))
                                : 0.0f;
            row[key] = p;
            part = __fadd_rn(part, p);
          }
          row_sum(part, lr);
        }
      }
      __syncthreads();
    }
    if (j == 0 && pass == 2) {  // pass 1's row sums
      sum0 = sum_s[la];
      sum1 = sum_s[lb];
    }
    if (pass == 2) {
      // ---- V^T with keys permuted: vt[d][32c + 4u + i] = v[32c + key_i][d]
      // for keys {base, base+1, base+8, base+9}, base = 16 (u / 4) +
      // 2 (u % 4); one 4 x 4 byte transpose per (c, u, 4 hd columns),
      // packed rows expanded through the V table first
      const int8_t* vsrc = KEEP ? kt : kt + BT * KS;
      uint32_t tv[4];
      if (PACKED) {
        const uint4 w = *reinterpret_cast<const uint4*>(ut + 16);
        tv[0] = w.x;
        tv[1] = w.y;
        tv[2] = w.z;
        tv[3] = w.w;
      }
      for (int i = tid; i < BT * HD / 16; i += NTH) {
        const int u = i & 7, rest = i >> 5;
        const int c = rest % WC;
        const int d4 = (rest / WC) * 4 + ((i >> 3) & 3);
        const int key = 32 * c + 16 * (u >> 2) + 2 * (u & 3);
        uint32_t w0, w1, w2, w3;
        if (PACKED) {  // hd 4 d4..+3: the u16 at packed byte 2 d4
          const int8_t* src = vsrc + key * KS + 2 * d4;
          w0 = unpack4(*(const uint16_t*)src, tv);
          w1 = unpack4(*(const uint16_t*)(src + KS), tv);
          w2 = unpack4(*(const uint16_t*)(src + 8 * KS), tv);
          w3 = unpack4(*(const uint16_t*)(src + 9 * KS), tv);
        } else {
          const int8_t* src = vsrc + key * KS + 4 * d4;
          w0 = *(const uint32_t*)src;
          w1 = *(const uint32_t*)(src + KS);
          w2 = *(const uint32_t*)(src + 8 * KS);
          w3 = *(const uint32_t*)(src + 9 * KS);
        }
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
      __syncthreads();  // V^T is in place
    }

    // ---- this warp's chunk: keys key0 + 8n + 2t + {0, 1}, rows ra, rb
    const int key0 = j * BT + 32 * wc;
    const bool live = key0 < lim;  // warp-uniform
    // the lg column of the chunk: KEEP, its key; else the staging tile's
    const int col0 = (KEEP ? j * BT : 0) + 32 * wc + 2 * t;
    int sc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0;
    if (live && (pass == 0 || !KEEP)) {
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (PACKED) {
          // key 8n + g of the chunk: the 4 packed bytes at 16c + 4t of
          // its row hold hd 32c + 8t..8t+7, b0 and b1 (header)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const uint32_t w = *(const uint32_t*)(
                kt + (32 * wc + 8 * n + g) * KS + 16 * c + 4 * t);
            mma_s8(sc[n], qa[c], unpack4(w, tk), unpack4(w >> 16, tk));
          }
        } else {
#pragma unroll
          for (int n = 0; n < 4; n += 2) {
            uint32_t bf[4];
            // matrices: keys 8n+0..7 at hd 32c and 32c+16, keys 8n+8..15
            ldsm_x4(bf, kt + (32 * wc + 8 * n + (lane >> 4) * 8 +
                              (lane & 7)) * KS +
                            32 * c + ((lane >> 3) & 1) * 16);
            mma_s8(sc[n], qa[c], bf[0], bf[1]);
            mma_s8(sc[n + 1], qa[c], bf[2], bf[3]);
          }
        }
      }
    }

    if (pass == 0) {
      if (live) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          float x[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (e >= ne) break;
            const int key = key0 + 8 * n + 2 * t + (e & 1);
            x[e] = logit(sc[n][e], key, e < 2 ? pa : pb);
            if (key < lim) {
              if (e < 2)
                m0 = fmaxf(m0, x[e]);
              else
                m1 = fmaxf(m1, x[e]);
            }
          }
          if (KEEP) {  // the logits stay for pass 1
            if (la < LR)
              *(float2*)(lg + la * LST + col0 + 8 * n) =
                  make_float2(x[0], x[1]);
            if (lb < LR)
              *(float2*)(lg + lb * LST + col0 + 8 * n) =
                  make_float2(x[2], x[3]);
          }
        }
      }
      if (j == n_tiles - 1) {  // this warp's maxima over its chunks
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
        if (t == 0) {
          mx_s[16 * warp + g] = m0;
          mx_s[16 * warp + g + 8] = m1;
        }
      }
    } else if (pass == 1) {  // (not KEEP)
      // ---- p into the staging tile (0 past lim: adding it is exact)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * n + 2 * t + (e & 1);
          p[e] = 0.0f;
          if (live && e < ne && key < lim)
            p[e] = expf(__fsub_rn(logit(sc[n][e], key, e < 2 ? pa : pb),
                                  e < 2 ? m0 : m1));
        }
        *(float2*)(lg + la * LST + col0 + 8 * n) = make_float2(p[0], p[1]);
        *(float2*)(lg + lb * LST + col0 + 8 * n) = make_float2(p[2], p[3]);
      }
      __syncthreads();  // the tile's p are staged
      // ---- lane l adds column l of each 32-key chunk to the partial l
      // of the rows this warp owns, chunk after chunk
#pragma unroll
      for (int x = 0; x < RPW; ++x) {
        const int lr = 16 * rt + RPW * wc + x;
        const float* pr = lg + lr * LST + lane;
#pragma unroll
        for (int c = 0; c < WC; ++c) part[x] = __fadd_rn(part[x], pr[32 * c]);
        if (j == n_tiles - 1) row_sum(part[x], lr);
      }
    } else {
      // ---- the image (0 past lim), its A fragment (keys in the order
      // sigma), P.V
      uint32_t img[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (KEEP) {  // p from pass 1 (0 past lim)
          if (live && la < LR) {
            const float2 pa2 = *(const float2*)(lg + la * LST + col0 + 8 * n);
            p[0] = pa2.x;
            p[1] = pa2.y;
          }
          if (live && ne == 4 && lb < LR) {
            const float2 pb2 = *(const float2*)(lg + lb * LST + col0 + 8 * n);
            p[2] = pb2.x;
            p[3] = pb2.y;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * n + 2 * t + (e & 1);
            if (e < ne && key < lim)
              p[e] = expf(__fsub_rn(logit(sc[n][e], key, e < 2 ? pa : pb),
                                    e < 2 ? m0 : m1));
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          img[n][e] = e < ne ? rint_bits(__fmul_rn(
                                   __fdiv_rn(p[e], e < 2 ? sum0 : sum1),
                                   127.0f))
                             : 0u;
      }
      if (live) {
        uint32_t pf[4];
        pf[0] = pack4(img[0][0], img[0][1], img[1][0], img[1][1]);
        pf[1] = pack4(img[0][2], img[0][3], img[1][2], img[1][3]);
        pf[2] = pack4(img[2][0], img[2][1], img[3][0], img[3][1]);
        pf[3] = pack4(img[2][2], img[2][3], img[3][2], img[3][3]);
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t bf[4];
          // matrices: hd rows 8d+0..7 at keys +0 and +16, rows 8d+8..15
          ldsm_x4(bf, vt + (8 * d + (lane >> 4) * 8 + (lane & 7)) * VTS +
                          32 * wc + ((lane >> 3) & 1) * 16);
          mma_s8(pv[d], pf, bf[0], bf[1]);
          mma_s8(pv[d + 1], pf, bf[2], bf[3]);
        }
      }
      if (qp_out != nullptr) {
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * n + 2 * t + (e & 1);
            const int r = e < 2 ? ra : rb;
            if (r < M && key < T)
              qp_out[(row0 + r) * T + key] = (int8_t)(img[n][e] & 0xffu);
          }
      }
    }
  }

  // the image of the keys past the last tile is 0
  if (qp_out != nullptr) {
    const int z0 = min(T, n_tiles * BT), nz = T - z0;
    for (int i = tid; i < ROWS * nz; i += NTH) {
      const int r = rB + i / nz;
      if (r < M) qp_out[(row0 + r) * T + z0 + i % nz] = 0;
    }
  }

  // ---- the WC warps' partial P.V of each row tile, added in shared
  // memory (over the ring and what follows it, all consumed)
  cp_async_wait(0);
  __syncthreads();
  int* red = reinterpret_cast<int*>(pa_smem);  // [W][16][RST]
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = 8 * d + 2 * t;
    *(int2*)(red + (16 * warp + g) * RST + col) = make_int2(pv[d][0], pv[d][1]);
    *(int2*)(red + (16 * warp + g + 8) * RST + col) =
        make_int2(pv[d][2], pv[d][3]);
  }
  __syncthreads();
  for (int i = tid; i < ROWS * HD / 4; i += NTH) {
    const int lr = i / (HD / 4), c4 = i % (HD / 4);
    if (rB + lr < M) {
      const int* src = red + (16 * WC * (lr / 16) + lr % 16) * RST + 4 * c4;
      int4 acc = make_int4(0, 0, 0, 0);
#pragma unroll
      for (int w = 0; w < WC; ++w) {
        const int4 v = *(const int4*)(src + 16 * w * RST);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *(int4*)(out + (row0 + rB + lr) * HD + 4 * c4) = acc;
    }
  }
}

// int8 pools
template <int HD, int WC, int RT, bool KEEP>
__global__ void __launch_bounds__(32 * WC * RT)
paged_attn_mma_kernel(PA_PARAMS) {
  paged_attn_mma<HD, WC, RT, KEEP, false>(PA_ARGS);
}

// int4-packed pools
template <int HD, int WC, int RT, bool KEEP>
__global__ void __launch_bounds__(32 * WC * RT)
paged_attn_mma_packed_kernel(PA_PARAMS) {
  paged_attn_mma<HD, WC, RT, KEEP, true>(PA_ARGS);
}

template <int HD, int WC, int RT, bool KEEP, bool PACKED>
int launch_mma(PA_PARAMS, int B, size_t smem, cudaStream_t stream) {
  auto* kernel = &paged_attn_mma_kernel<HD, WC, RT, KEEP>;
  if (PACKED) kernel = &paged_attn_mma_packed_kernel<HD, WC, RT, KEEP>;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(B * K, (group * S + 16 * RT - 1) / (16 * RT));
  kernel<<<grid, 32 * WC * RT, smem, stream>>>(PA_ARGS);
  return (int)cudaGetLastError();
}

// the compiled launch plans, 8 warps each: rows 16 (one row tile, 8
// warps over its keys) or 32 (two row tiles, 4 warps over each), each
// with the logits kept or recomputed, over either pool mode
template <int HD>
int launch_mma_plan(PA_PARAMS, int B, int rows, int keep, size_t smem,
                    cudaStream_t stream) {
  const bool packed = k_rq != nullptr;
#define PA_MMA_LAUNCH(WC, RT, KEEP)                                       \
  return packed ? launch_mma<HD, WC, RT, KEEP, true>(PA_ARGS, B, smem,    \
                                                     stream)              \
                : launch_mma<HD, WC, RT, KEEP, false>(PA_ARGS, B, smem,   \
                                                      stream);
  if (rows == 16 && keep) PA_MMA_LAUNCH(8, 1, true)
  if (rows == 16) PA_MMA_LAUNCH(8, 1, false)
  if (rows == 32 && keep) PA_MMA_LAUNCH(4, 2, true)
  if (rows == 32) PA_MMA_LAUNCH(4, 2, false)
#undef PA_MMA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// smem: the dynamic shared bytes of `paged_plan`'s layout; `rows` 16 or
// 32 a block, `stages` 2 to 4 ring slots, `keep` the logits in shared
// memory instead of recomputing the scores.  k_rq / v_rq: the (6, K)
// unpack operands of int4-packed pools (hd/2-byte rows), or null for
// int8 pools.  Returns a cudaError_t.
extern "C" int paged_attention_launch(
    const int8_t* q, const int8_t* k_pool, const int8_t* v_pool,
    const int32_t* table, const int32_t* pos, const float* score_scale,
    int32_t* out, int8_t* qp_out, const int32_t* k_rq, const int32_t* v_rq,
    int B, int H, int S, int hd, int K, int ps, int pps, int group,
    int n_pool, long long smem, int rows, int stages, int keep,
    cudaStream_t stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if ((k_rq == nullptr) != (v_rq == nullptr))
    return (int)cudaErrorInvalidValue;
  if (stages < 2 || stages > 4) return (int)cudaErrorInvalidValue;
#define PA_MMA_CASE(D)                                                     \
  case D:                                                                  \
    return launch_mma_plan<D>(PA_ARGS, B, rows, keep, (size_t)smem, stream);
  switch (hd) {
    PA_MMA_CASE(32)
    PA_MMA_CASE(64)
    PA_MMA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_MMA_CASE
}
