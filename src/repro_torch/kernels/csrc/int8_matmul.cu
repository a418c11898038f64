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
// once when the tables are loaded), so both operands are K-major.  Any
// M and N; K a multiple of 16 and the rows of both operands 16-byte
// aligned (the wrapper checks).  Every int32 add and multiply that can
// wrap is done in unsigned arithmetic or by the hardware's wrapping
// integer units, so it wraps like XLA's int32.
//
// What bounds it on the H100: at every shape of the serving path the
// bytes, not the operations.  Decode (M = n_slots = 8) reads K*N weight
// bytes for 16 operations each; chunked prefill (M = 256) does 2*M*N*K
// int8 operations, which the tensor cores finish faster than HBM
// delivers the weights.  Two paths; the launch plan (tile, split of K)
// comes from the wrapper's `gemm_plan`, so that every serving shape puts
// at least one full wave of blocks on the 132 SMs:
//
//   M <= 16  `gemm_gemv_kernel`: each warp owns 4 columns, its lanes
//            stream 16-byte weight vectors along K (8 loads in flight
//            per lane, no L1 allocation, 256-byte L2 fetches), and the
//            warps of a block that share K read x through L1; every
//            weight byte is read once.  One reduce-scatter across the
//            lanes, one sum across the warps in shared memory.
//   M > 16   `gemm_wgmma_kernel`: one producer warp keeps a ring of 4
//            stages of 128-byte-deep tiles in flight by TMA (128-byte
//            swizzle, zero fill past the ragged M, N and K edges); one
//            or two consumer warpgroups (64 x 32 or 128 x 64 tiles) run
//            wgmma m64nBNk32 s8 x s8 -> s32 with both operands K-major
//            from shared memory.  Row
//            tiles are the fastest grid index, so the blocks that read
//            one weight tile run together and it comes from HBM once.
//
// Split K (both paths): int32 addition wraps, so it is associative and
// partials summed in any order give the same bits.  Each split stores
// its partial tile in a slot of its own in a workspace, then counts
// itself in the tile's arrival counter; the tile's last block adds the
// other slots to its own partial, resets the counter and runs the bias
// and requant epilogue once.  The wrapper allocates workspace and
// counters once; the kernel leaves the counters zeroed.
#include <cuda.h>
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

// The epilogue's operands: bias, the site's requant tables (mul ==
// nullptr in int32-out mode) and the output.
struct Epi {
  const int32_t* bias;
  const int32_t* mul;
  const int32_t* s0;
  const int32_t* lo;
  const int32_t* hi;
  const int32_t* d;
  const int32_t* zp;
  int rq_stride, qmin, qmax;
  void* out;
  int out_int8, M, N;
};

// one output column's bias and requant table entries
struct Col {
  int bias, mul, s0, lo, hi;
};

__device__ __forceinline__ Col load_col(const Epi& e, int c) {
  Col k{e.bias[c], 0, 0, 0, 0};
  if (e.mul != nullptr) {
    const int cc = c * e.rq_stride;
    k.mul = e.mul[cc];
    k.s0 = e.s0[cc];
    k.lo = e.lo[cc];
    k.hi = e.hi[cc];
  }
  return k;
}

// bias add, then (requant mode) the site's full apply_rqt
__device__ __forceinline__ int finish(const Epi& e, const Col& k, int acc,
                                      int d, int zp) {
  int v = wrap_add(acc, k.bias);
  if (e.mul == nullptr) return v;
  v = min(max(v, k.lo), k.hi);
  const int staged = wrap_mul(sra(v, k.s0), k.mul);
  const int y = wrap_add(sra(staged, d - k.s0), zp);
  return min(max(y, e.qmin), e.qmax);
}

__device__ __forceinline__ void store1(const Epi& e, int v, int r, int c) {
  const long long o = (long long)r * e.N + c;
  if (e.out_int8)
    static_cast<int8_t*>(e.out)[o] = (int8_t)v;
  else
    static_cast<int32_t*>(e.out)[o] = v;
}

// columns c and c + 1 of row r (c + 1 may lie past N); one 2- or 8-byte
// store where both are in range and the pair is aligned
__device__ __forceinline__ void store2(const Epi& e, int v0, int v1, int r,
                                       int c) {
  const long long o = (long long)r * e.N + c;
  if (c + 1 < e.N && (o & 1) == 0) {
    if (e.out_int8) {
      const unsigned short p = (unsigned short)(uint8_t)v0 |
                               ((unsigned short)(uint8_t)v1 << 8);
      *reinterpret_cast<unsigned short*>(static_cast<int8_t*>(e.out) + o) =
          p;
    } else {
      *reinterpret_cast<int2*>(static_cast<int32_t*>(e.out) + o) =
          make_int2(v0, v1);
    }
    return;
  }
  store1(e, v0, r, c);
  if (c + 1 < e.N) store1(e, v1, r, c + 1);
}

// Split K: after this block stored its partial tile in its own slot of
// the workspace, count the block in its tile's counter.  True in the
// tile's last block, which then adds the other slots to its own partial
// and resets the counter.  Called by `n` threads (named barrier 1),
// `leader` among them.
__device__ __forceinline__ bool last_arrival(unsigned* counter, int splits,
                                             bool leader, int n,
                                             int* flag) {
  __threadfence();
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
  if (leader) {
    const unsigned prev = atomicAdd(counter, 1u);
    const bool last = prev == (unsigned)(splits - 1);
    if (last) *counter = 0u;
    *flag = last;
    __threadfence();
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------------
// M <= 16: the GEMV.
// ---------------------------------------------------------------------
constexpr int kGemvCols = 4;           // columns per warp
constexpr int kGemvBK = 32 * 16;       // one 16-byte vector per lane
constexpr int kGemvWarps = 8;

// Sum each of V values over the 32 lanes: halve the values at every
// step, keeping the half this lane's bit of O selects; past V = 1 the
// steps are a plain butterfly.  After it, lane l holds max(1, V / 32)
// sums, of the values from `scatter_base(l)` on.
template <int V, int O>
__device__ __forceinline__ void reduce_scatter(int* v, int lane) {
  if constexpr (V > 1) {
    constexpr int H = V / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const int send = up ? v[i] : v[H + i];
      const int keep = up ? v[H + i] : v[i];
      v[i] = wrap_add(keep, __shfl_xor_sync(0xffffffffu, send, O));
    }
    if constexpr (O > 1) reduce_scatter<H, O / 2>(v, lane);
  } else {
    v[0] = wrap_add(v[0], __shfl_xor_sync(0xffffffffu, v[0], O));
    if constexpr (O > 1) reduce_scatter<1, O / 2>(v, lane);
  }
}

// -> the index of lane's first sum; `writer` false on the lanes whose
// sums duplicate another lane's (V < 32)
template <int V>
__device__ __forceinline__ int scatter_base(int lane, bool& writer) {
  int base = 0, n = V;
  writer = true;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    if (n > 1) {
      n /= 2;
      if (lane & o) base += n;
    } else if (lane & o) {
      writer = false;
    }
  }
  return base;
}

// a weight vector, read once: no L1 allocation, 256-byte L2 fetches
__device__ __forceinline__ int4 ld_weight(const int4* p) {
  int4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.s32 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// byte offset of each of the MT rows of x that the GEMV reads: row m,
// or row M - 1 past M (those rows' sums are never stored), so that the
// loads need no condition and issue together; kernel parameters, so
// they cost no registers
struct XRows {
  long long off[16];
};

// acc[m][j] += x[m, 16 ch .. 16 ch + 16) . w[j] for the MT rows; x
// through L1, which the warps of a block that share K hit
template <int MT>
__device__ __forceinline__ void gemv_dot(int (&acc)[MT * kGemvCols],
                                         const int8_t* x, const XRows& rows,
                                         int ch,
                                         const int4 (&w)[kGemvCols]) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int4 xv =
        __ldg(reinterpret_cast<const int4*>(x + rows.off[m]) + ch);
#pragma unroll
    for (int j = 0; j < kGemvCols; ++j) {
      int a = acc[m * kGemvCols + j];
      a = __dp4a(xv.x, w[j].x, a);
      a = __dp4a(xv.y, w[j].y, a);
      a = __dp4a(xv.z, w[j].z, a);
      a = __dp4a(xv.w, w[j].w, a);
      acc[m * kGemvCols + j] = a;
    }
  }
}

// One block of kGemvWarps warps: bn columns (4 per warp along N, so
// bn / 4 warp columns) over one split of K (blockIdx.y); the 8 * 4 / bn
// warps of a column share its K, each taking every kw-th 512-byte step.
template <int MT>
__global__ void __launch_bounds__(32 * kGemvWarps)
gemm_gemv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 Epi e, const __grid_constant__ XRows rows, int K,
                 int k_split, int bn, int32_t* __restrict__ ws,
                 unsigned* __restrict__ counters) {
  constexpr int V = MT * kGemvCols;
  __shared__ int part[kGemvWarps * V];
  __shared__ int last_flag;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int cw = bn / kGemvCols, kw = kGemvWarps / cw;
  const int wc = warp % cw, wk = warp / cw;
  const int k0 = blockIdx.y * k_split;
  const int nchunk = min(k_split, K - k0) / 16;
  const int c0 = blockIdx.x * bn + kGemvCols * wc;
  const int8_t* xk = x + k0;

  // the epilogue's operands for this thread's first output (below), so
  // that their loads overlap the weights'
  Col col{};
  {
    const int i = threadIdx.x, c = blockIdx.x * bn + i % V % kGemvCols +
                                   kGemvCols * (i / V);
    if (i < (bn / kGemvCols) * V && c < e.N) col = load_col(e, c);
  }
  const int d = e.mul ? *e.d : 0, zp = e.mul ? *e.zp : 0;

  const int4* wp[kGemvCols];
#pragma unroll
  for (int j = 0; j < kGemvCols; ++j)  // columns past N read column N - 1
    wp[j] = reinterpret_cast<const int4*>(
        wt + (long long)min(c0 + j, e.N - 1) * K + k0);
  const int4 zero = make_int4(0, 0, 0, 0);
  // this lane's chunks: 32 (wk + kw i) + lane, two per round
  const int step = 32 * kw;
  int ch = 32 * wk + lane;
  int4 wa[kGemvCols], wb[kGemvCols];
#pragma unroll
  for (int j = 0; j < kGemvCols; ++j) {
    wa[j] = ch < nchunk ? ld_weight(wp[j] + ch) : zero;
    wb[j] = ch + step < nchunk ? ld_weight(wp[j] + ch + step) : zero;
  }
  int acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0;
  while (ch < nchunk) {
    gemv_dot<MT>(acc, xk, rows, ch, wa);
    if (ch + step < nchunk) gemv_dot<MT>(acc, xk, rows, ch + step, wb);
    ch += 2 * step;
    if (ch < nchunk) {
#pragma unroll
      for (int j = 0; j < kGemvCols; ++j) {
        wa[j] = ld_weight(wp[j] + ch);
        wb[j] = ch + step < nchunk ? ld_weight(wp[j] + ch + step) : zero;
      }
    }
  }
  reduce_scatter<V, 16>(acc, lane);
  bool writer;
  const int base = scatter_base<V>(lane, writer);
  constexpr int R = V >= 32 ? V / 32 : 1;
  if (writer) {
#pragma unroll
    for (int i = 0; i < R; ++i) part[warp * V + base + i] = acc[i];
  }
  __syncthreads();
  // thread i of the block's bn * MT outputs sums value i over the kw
  // warps; split K stores the sum in the block's workspace slot, and the
  // tile's last block adds the other slots
  const int splits = gridDim.y, n_out = cw * V;
  int32_t* slot = ws + (long long)blockIdx.x * splits * n_out;
  constexpr int kThreads = 32 * kGemvWarps;  // n_out <= 2 kThreads
  int sum[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i < n_out) {
      const int pc = i / V, idx = i % V;
      int v = 0;
      for (int k = 0; k < kw; ++k)
        v = wrap_add(v, part[(k * cw + pc) * V + idx]);
      sum[r] = v;
      if (splits > 1) __stcg(slot + blockIdx.y * n_out + i, v);
    }
  }
  if (splits > 1 &&
      !last_arrival(counters + blockIdx.x, splits, threadIdx.x == 0,
                    kThreads, &last_flag))
    return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i < n_out) {
      int v = sum[r];
      for (int k = 0; k < splits; ++k)
        if (k != (int)blockIdx.y)
          v = wrap_add(v, __ldcg(slot + k * n_out + i));
      const int pc = i / V, idx = i % V;
      const int m = idx / kGemvCols;
      const int c = blockIdx.x * bn + kGemvCols * pc + idx % kGemvCols;
      if (m < e.M && c < e.N)
        store1(e, finish(e, r == 0 ? col : load_col(e, c), v, d, zp), m, c);
    }
  }
}

// ---------------------------------------------------------------------
// M > 16: TMA ring + wgmma.
// ---------------------------------------------------------------------
constexpr int kBK = 128;     // bytes of K per stage: one 128-byte swizzle atom
constexpr int kStages = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// box (kBK bytes of K, rows) at (k, row) -> shared dst, completion on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(row), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are 128
// bytes, 128-byte swizzled (as TMA wrote it), 8-row groups 1024 bytes
// apart.  The tile is 1024-byte aligned, so stepping K inside the atom
// is adding bytes / 16 to the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 32)
    wgmma_n32(d, da, db);
  else
    wgmma_n64(d, da, db);
}

// One block: a (64 * WG) x BN output tile over one split of K
// (blockIdx.z).  Warps 0 .. 4 WG - 1 are the consumer warpgroups (rows
// 64 wg ..), warp 4 WG the producer.
template <int WG, int BN>
__global__ void __launch_bounds__(128 * WG + 32)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw, Epi e, int K,
                  int k_split, int32_t* __restrict__ ws,
                  unsigned* __restrict__ counters) {
  constexpr int BM = 64 * WG;
  constexpr int A_BYTES = BM * kBK, STAGE = (BM + BN) * kBK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  __shared__ Col cols[BN];
  __shared__ int last_flag;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1 KB
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kb0 = blockIdx.z * (k_split / kBK);
  const int steps = (min(k_split, K - blockIdx.z * k_split) + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 4 * WG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WG) {  // producer: one lane keeps the ring full
    if (lane == 0) {
      for (int i = 0; i < steps; ++i) {
        const int s = i % kStages;
        mbar_wait(smem_u32(&empty[s]), ((i / kStages) & 1) ^ 1);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, STAGE);
        const uint32_t a = base + s * STAGE;
        tma_load(a, &tx, (kb0 + i) * kBK, m0, bar);
        tma_load(a + A_BYTES, &tw, (kb0 + i) * kBK, n0, bar);
      }
    }
    return;
  }

  // the consumers stage the tile's bias and requant columns while the
  // first stages load
  if (tid < BN && n0 + tid < e.N) cols[tid] = load_col(e, n0 + tid);
  const int d = e.mul ? *e.d : 0, zp = e.mul ? *e.zp : 0;
  asm volatile("bar.sync 1, %0;\n" ::"r"(128 * WG) : "memory");

  const int wg = warp / 4;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int i = 0; i < steps; ++i) {
    const int s = i % kStages;
    mbar_wait(smem_u32(&full[s]), (i / kStages) & 1);
    const uint32_t a = base + s * STAGE + wg * 64 * kBK;
    const uint32_t b = base + s * STAGE + A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32)
      wgmma_tile<BN>(acc, sw128_desc(a + kk), sw128_desc(b + kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // one group stays in flight: the previous step's stage is free
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (i > 0 && lane == 0)
      mbar_arrive(smem_u32(&empty[(i + kStages - 1) % kStages]));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");

  // accumulator i of lane (g, t) in warp w of the warpgroup: row
  // 16 w + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2
  const int g = lane / 4, t = lane % 4;
  const int lr0 = 64 * wg + 16 * (warp % 4) + g;
  const int splits = gridDim.z;
  if (splits > 1) {
    // split K: this block's partial goes to its slot of the tile; the
    // tile's last block adds the others
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    int32_t* slots = ws + (long long)tile * splits * BM * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int lr = lr0 + 8 * ((i / 2) % 2), lc = 8 * (i / 4) + 2 * t;
      __stcg(reinterpret_cast<int2*>(slots + blockIdx.z * BM * BN +
                                     lr * BN + lc),
             make_int2(acc[i], acc[i + 1]));
    }
    if (!last_arrival(counters + tile, splits, tid == 0, 128 * WG,
                      &last_flag))
      return;
    for (int k = 0; k < splits; ++k) {
      if (k == (int)blockIdx.z) continue;
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int lr = lr0 + 8 * ((i / 2) % 2), lc = 8 * (i / 4) + 2 * t;
        const int2 v = __ldcg(reinterpret_cast<const int2*>(
            slots + k * BM * BN + lr * BN + lc));
        acc[i] = wrap_add(acc[i], v.x);
        acc[i + 1] = wrap_add(acc[i + 1], v.y);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int lr = lr0 + 8 * ((i / 2) % 2), lc = 8 * (i / 4) + 2 * t;
    const int r = m0 + lr, c = n0 + lc;
    if (r < e.M && c < e.N)
      store2(e, finish(e, cols[lc], acc[i], d, zp),
             c + 1 < e.N ? finish(e, cols[lc + 1], acc[i + 1], d, zp) : 0,
             r, c);
  }
}

// ---------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

// (rows, K) int8, row pitch `ld` bytes, boxes of kBK x box_rows,
// 128-byte swizzle, zero fill out of bounds
bool encode_kmajor(CUtensorMap* map, const void* ptr, long long rows,
                   long long K, long long ld, int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dynamic shared memory: raise the kernel's limit on this device to
// `bytes` when it is below (`limit` is the kernel's own; static shared
// memory counts against the default 48 KB too)
cudaError_t allow_smem(const void* kernel, int bytes, int (&limit)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes > limit[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    limit[dev] = bytes;
  }
  return cudaSuccess;
}

template <int MT>
cudaError_t launch_gemv(const int8_t* x, const int8_t* wt, const Epi& e,
                        int K, long long ldx, int bn, int splits,
                        int k_split, int32_t* ws, unsigned* counters,
                        cudaStream_t stream) {
  XRows rows;
  for (int m = 0; m < 16; ++m)
    rows.off[m] = (long long)(m < e.M ? m : e.M - 1) * ldx;
  const dim3 grid((e.N + bn - 1) / bn, splits);
  gemm_gemv_kernel<MT><<<grid, 32 * kGemvWarps, 0, stream>>>(
      x, wt, e, rows, K, k_split, bn, ws, counters);
  return cudaGetLastError();
}

template <int WG, int BN>
cudaError_t launch_wgmma(const int8_t* x, const int8_t* wt, const Epi& e,
                         int K, long long ldx, int splits, int k_split,
                         int32_t* ws, unsigned* counters,
                         cudaStream_t stream) {
  constexpr int BM = 64 * WG;
  CUtensorMap tx, tw;
  if (!encode_kmajor(&tx, x, e.M, K, ldx, BM) ||
      !encode_kmajor(&tw, wt, e.N, K, K, BN))
    return cudaErrorInvalidValue;
  static int limit[64] = {};
  auto* kernel = gemm_wgmma_kernel<WG, BN>;
  const int smem = kStages * (BM + BN) * kBK + 1024;
  cudaError_t err = allow_smem((const void*)kernel, smem, limit);
  if (err != cudaSuccess) return err;
  // row tiles innermost: the blocks that read one weight tile run
  // together, so it comes from HBM once
  const dim3 grid((e.M + BM - 1) / BM, (e.N + BN - 1) / BN, splits);
  kernel<<<grid, 128 * WG + 32, smem, stream>>>(tx, tw, e, K, k_split, ws,
                                                counters);
  return cudaGetLastError();
}

}  // namespace

// path 0: GEMV, bm = rows staged (1, 2, 4, 8 or 16 >= M), bn = columns
//         per block (4 per warp);
// path 1: wgmma, tiles of bm x bn = 64 x 32 or 128 x 64.
// splits blocks share K, k_split bytes each (a whole number of the
// path's K step); with splits > 1, ws holds a slot of bm x bn int32 per
// tile and split, and counters one zero per tile.
extern "C" int int8_matmul_launch(
    const int8_t* x, const int8_t* wt, const int32_t* bias,
    const int32_t* mul, const int32_t* s0, const int32_t* lo,
    const int32_t* hi, const int32_t* d, const int32_t* zp, int rq_stride,
    int qmin, int qmax, void* out, int out_int8, int M, int N, int K,
    long long ldx, int path, int bm, int bn, int splits, int k_split,
    int32_t* ws, unsigned* counters, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  const int bk = path == 0 ? kGemvBK : kBK;
  if (K % 16 != 0 || ldx % 16 != 0 || splits < 1 || k_split % bk != 0 ||
      (long long)splits * k_split < K ||
      (long long)(splits - 1) * k_split >= K)
    return (int)cudaErrorInvalidValue;
  const Epi e{bias, mul, s0, lo, hi, d, zp, rq_stride, qmin, qmax,
              out, out_int8, M, N};
  if (path == 0) {
    if (M > bm || (bn != 4 && bn != 8 && bn != 16 && bn != 32))
      return (int)cudaErrorInvalidValue;
    switch (bm) {
      case 1: return launch_gemv<1>(x, wt, e, K, ldx, bn, splits, k_split,
                                    ws, counters, stream);
      case 2: return launch_gemv<2>(x, wt, e, K, ldx, bn, splits, k_split,
                                    ws, counters, stream);
      case 4: return launch_gemv<4>(x, wt, e, K, ldx, bn, splits, k_split,
                                    ws, counters, stream);
      case 8: return launch_gemv<8>(x, wt, e, K, ldx, bn, splits, k_split,
                                    ws, counters, stream);
      case 16: return launch_gemv<16>(x, wt, e, K, ldx, bn, splits,
                                      k_split, ws, counters, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (bm == 64 && bn == 32)
    return launch_wgmma<1, 32>(x, wt, e, K, ldx, splits, k_split, ws,
                               counters, stream);
  if (bm == 128 && bn == 64)
    return launch_wgmma<2, 64>(x, wt, e, K, ldx, splits, k_split, ws,
                               counters, stream);
  return (int)cudaErrorInvalidValue;
}
