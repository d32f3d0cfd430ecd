// Fused WaveRNN autoregressive sampler for Hopper (sm_90a): a persistent,
// weight-stationary kernel whose bf16 products run on the tensor cores'
// asynchronous pipeline.
//
// Replaces the TPU kernels `_kernel_v2` (time-major conditioning) and `_kernel`
// (fold-major conditioning) of mockingbird_tpu/ops/wavernn_sample.py, both
// reached from `wavernn_sample_pallas`. With f32 weights one kernel reads
// either layout through its row strides, the fold-major (F, T, D) one in
// place; with bf16 weights the wrapper lays both out as the ring's tiles
// (below). Per step, for F independent folds: I-dense of [x_prev, mel_t, a1]
// -> GRU1 (+residual) -> GRU2 on [u, a2] (+residual) -> relu fc1 [u, a3] ->
// relu fc2 [u, a4] -> fc3 logits -> Gumbel-max sample (argmax when greedy)
// -> x = 2*label/(C-1) - 1 fed back.
//
// What bounds it on this card: the work is about 2 x 4.07 M multiply-adds per
// fold per step at full width, on 8.1 MB of bf16 weights, and the T steps are
// strictly sequential. Counted once per call the function is bound by its
// operations, but a step is a chain of six phases, each of which needs every
// column of the layer before it, so a step is bound by latency: by how fast
// each layer's input reaches every SM and passes through its tensor cores,
// and by the grid barriers between phases. Split by phase on the card (block
// 0's clock) at F = 186, bf16, the design before this one (mma.sync on
// fragments loaded by scalar shared-memory loads, each layer's input staged
// whole and then multiplied) spent 33 us a step staging, 43 us in products,
// 8 us in the six barriers and 20 us in the rest (gates, sampling);
// staging and products grew with F, and past 144 folds every layer took two
// serial passes.
//
// What the design does about it:
//   * one cooperative launch (cudaLaunchKernelEx, cooperative) of G blocks
//     in clusters of 4, one per SM, all resident, looping over all T steps;
//     G is a multiple of 4 no larger than what the card keeps resident in
//     clusters of 4 (`wavernn_sample_resident_blocks`), 128 at full width,
//     and the launcher refuses any other;
//   * each block owns a slice of output columns of every layer and loads
//     that slice of every weight matrix into shared memory once, before the
//     step loop: nu whole GRU units (the r, z and n rows of g*_wi and g*_wh,
//     and the same nu columns of I, so the residual u never leaves the
//     block), nv columns of fc1 and of fc2, nq classes of fc3;
//   * after a layer, each block writes its columns of the layer's output for
//     all F folds, rounded to the weight type as the reference rounds before
//     each product, into a global exchange buffer (double-buffered by step
//     parity); a grid barrier follows;
//   * bf16 weights (the TTS path): the products are `wgmma.mma_async`
//     m64nNk16, the folds on the 64-row side (ceil(F / 64) tiles, the last
//     ragged) and the block's output columns on N (a GRU slice's 3nu rows,
//     the 4-row I, fc and class slices, padded to a multiple of 8). The
//     weight slices sit in shared memory as wgmma's B operand, K-major under
//     the 128-byte swizzle (95 KB at full width). The exchange buffers hold
//     their rows as the same swizzled tiles of 64 folds x 64 columns (8 KB),
//     and the wrapper lays the conditioning out as such tiles too (per step
//     and fold tile: [mel, a1], a2, a3, a4), so a plain bulk copy lands a
//     tile as wgmma reads it; the rest of shared memory is a ring of such
//     tiles (16 at full width), split between the consumer warpgroups. A
//     producer warp streams each layer's tiles through the ring, each lane
//     owning one slot and issuing its uses in order, so that the waits and
//     copies of different slots overlap, and each block of a cluster
//     fetching a quarter of every tile multicast into all four (L2 serves
//     each tile once per cluster); an mbarrier per slot counts the bytes
//     in, another counts the four blocks' consumers out. Three consumer
//     warpgroups each take one fold tile at a time through their own slots,
//     multiply as the K blocks arrive and keep the sums in registers into
//     the epilogue; only x, one column of I's operand, comes from registers.
//     Only the rows of folds < F are copied: a tile's other rows feed
//     outputs no epilogue writes;
//   * f32 weights, the parity mode (wgmma has no f32): the staged design
//     before: every block stages the full input rows into shared memory, F
//     folds in chunks that fit (bulk copies multicast in the cluster), then
//     f32 FMA tiles of 16 weight rows x 8 folds;
//   * the hidden products g1_wh.h1[t-1] and g2_wh.h2[t-1] depend only on the
//     previous step and run in the same phase as the I-dense;
//   * sampling: each block adds Gumbel noise to its own classes only and
//     folds its best (score, class) per fold into one 64-bit atomicMax key
//     (score ordered, then the lowest class); after the barrier every block
//     reads the winner of each fold, so x_t needs no further barrier;
//   * the grid barrier is hand-written: __syncthreads, then thread 0 fences
//     (__threadfence), adds one to a global counter and spins with
//     ld.acquire.gpu until the counter reaches G times the barrier's number.
//     Six per step: after I (with the hidden products), GRU1, GRU2, fc1,
//     fc2 and fc3's partial argmax.
// Measured the same way, this design's step at F = 186 is 57 us: 9 us
// waiting for tiles, 23 us in products, 13 us in barriers, 8 us in the
// gates and 5 us in the rest. What is left is latency: each wgmma waits on
// the one before it in its fold tile's chain, and the barriers, the gates
// and the block-private state in global memory stay. PERF.md records the
// split by phase over F.
//
// Numerics follow the Pallas kernel: activations are rounded to the weight
// type before each product and accumulated in f32; sampling draws 32 random
// bits per class from a Philox4x32-10 counter generator seeded by the caller
// (the TPU's hardware PRNG cannot be reproduced), keeps 23 of them as a
// uniform + 1e-7 and adds Gumbel noise -log(-log u); ties in the argmax go to
// the lowest index, as jnp.argmax does. The plain version (`gumbel_noise` in
// wavernn_sample.py) draws the same bits, so sampled labels compare exactly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;  // blocks per cluster: they share the staging of exchanged rows
constexpr int kSmemLimit = 232448;
// the bf16 ring: tiles of 64 folds (wgmma's M) x 64 columns (one 128-byte
// swizzle row), three consumer warpgroups, the producer the first warp of
// the fourth
constexpr int kTile = 64;
constexpr int kTileElems = kTile * kTile;
constexpr int kTileBytes = kTileElems * 2;
constexpr int kConsumers = 3;
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kMinSlots = 8;

__host__ __device__ constexpr int ceil_to(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ constexpr int cdiv(int v, int m) { return (v + m - 1) / m; }

// ---------------------------------------------------------------------------
// the launch plan's shared-memory layouts (mirrored by `plan` in
// wavernn_sample.py, which the launcher checks against)
// ---------------------------------------------------------------------------

struct Dims {
  int F, T, M, A, R, FC, C;  // folds, steps, mel, aux part, rnn, fc, classes
  int G, nu, nv, nq;         // blocks; units, fc columns, classes per block
  int fchunk, slots;         // f32: folds per stage; bf16: tiles in the ring
  int wbytes;                // 2 (bf16) or 4 (f32)
};

// row stride (elements) of a K-wide operand in shared memory: K padded to the
// mma depth (16), plus 16 bytes so that the 8 row groups of a fragment load
// fall on distinct banks
__host__ __device__ inline int kstride(int K, int wbytes) {
  return ceil_to(K, 16) + 16 / wbytes;
}

// f32: the staged layout
struct Layout {
  // weight slices: I (nu x K0), g1_wi (3nu x R), g1_wh (3nu x R),
  // g2_wi (3nu x R+A), g2_wh (3nu x R), fc1 (nv x R+A), fc2 (nv x FC+A),
  // fc3 (nq x FC); element offsets into the weight area and row strides
  int off[8], rows[8], K[8], ks[8];
  int xstage;     // element offset of the activation stage [fchunk][ksmax]
  int ksmax;
  int bias_off;   // byte offset of the f32 biases
  int nbias;      // 9nu + 2nv + nq
  int mbar_off;   // byte offset of the staging mbarrier (8 bytes)
  int bytes;      // total dynamic shared memory
};

__host__ __device__ inline Layout layout(const Dims& d) {
  Layout L;
  const int K0 = 1 + d.M + d.A;
  const int rows[8] = {d.nu, 3 * d.nu, 3 * d.nu, 3 * d.nu, 3 * d.nu, d.nv, d.nv, d.nq};
  const int Ks[8] = {K0, d.R, d.R, d.R + d.A, d.R, d.R + d.A, d.FC + d.A, d.FC};
  int at = 0;
  L.ksmax = 0;
  for (int i = 0; i < 8; ++i) {
    L.rows[i] = rows[i];
    L.K[i] = Ks[i];
    L.ks[i] = kstride(Ks[i], d.wbytes);
    L.off[i] = at;
    at += rows[i] * L.ks[i];
    L.ksmax = L.ks[i] > L.ksmax ? L.ks[i] : L.ksmax;
  }
  L.xstage = at;
  at += d.fchunk * L.ksmax;
  L.bias_off = ceil_to(at * d.wbytes, 16);
  L.nbias = 9 * d.nu + 2 * d.nv + d.nq;
  L.mbar_off = ceil_to(L.bias_off + 4 * L.nbias, 16);
  L.bytes = L.mbar_off + 16;
  return L;
}

// bf16: the ring layout, from a base aligned to 1024 bytes (the swizzle's
// period). Each weight slice is [blocks][n][64]: its rows padded to n, a
// multiple of 8 (wgmma's N), and its K in 64-wide blocks in the order the
// ring brings its operand, the exchanged columns, then the conditioning
// columns (I's operand is all conditioning, [mel, a1]); I's last block holds
// the weights of x, whose column comes from registers. Each [n][64] block
// under the 128-byte swizzle.
struct Ring {
  int rows[8], n[8];  // rows of each slice, and wgmma's N
  int kx[8];          // 64-wide K blocks of the exchanged columns
  int kc[8];          // 64-wide K blocks of the conditioning columns
  int coff[8];        // the first of those among a step's conditioning tiles
  int off[8];         // byte offset of each slice
  int KC;             // conditioning tiles a step and fold tile: [mel, a1], a2, a3, a4
  int ring;           // byte offset of the ring: slots x [64][64]
  int bias_off;       // byte offset of the f32 biases
  int nbias;          // 9nu + 2nv + nq
  int bar_off;        // byte offset of full[slots], then empty[slots] (8 bytes each)
  int bytes;          // total dynamic shared memory, with room to align the base
};

__host__ __device__ inline Ring ring_layout(const Dims& d) {
  Ring L;
  const int kr = cdiv(d.R, kTile), kf = cdiv(d.FC, kTile);
  const int ki = cdiv(d.M + d.A, kTile), ka = cdiv(d.A, kTile);
  const int rows[8] = {d.nu, 3 * d.nu, 3 * d.nu, 3 * d.nu, 3 * d.nu, d.nv, d.nv, d.nq};
  const int kx[8] = {0, kr, kr, kr, kr, kr, kf, kf};
  const int kc[8] = {ki, 0, 0, ka, 0, ka, ka, 0};
  const int coff[8] = {0, 0, 0, ki, 0, ki + ka, ki + 2 * ka, 0};
  int at = 0;
  for (int i = 0; i < 8; ++i) {
    L.rows[i] = rows[i];
    L.n[i] = ceil_to(rows[i], 8);
    L.kx[i] = kx[i];
    L.kc[i] = kc[i];
    L.coff[i] = coff[i];
    L.off[i] = at;
    at += (kx[i] + kc[i] + (i == 0)) * L.n[i] * kTile * 2;
  }
  L.KC = ki + 3 * ka;
  L.ring = at;
  at += d.slots * kTileBytes;
  L.bias_off = at;
  L.nbias = 9 * d.nu + 2 * d.nv + d.nq;
  L.bar_off = ceil_to(at + 4 * L.nbias, 16);
  L.bytes = L.bar_off + 16 * d.slots + 1024;
  return L;
}

// ---------------------------------------------------------------------------
// device helpers
// ---------------------------------------------------------------------------

template <typename W> __device__ __forceinline__ float to_f(W v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename W> __device__ __forceinline__ W from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float sigm(float v) { return 1.0f / (1.0f + expf(-v)); }

// Philox4x32-10 (Salmon et al., SC'11); returns the first output word.
__device__ __forceinline__ uint32_t philox(uint32_t c0, uint32_t c1, uint32_t c2,
                                           uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = c0 * 0xD2511F53u, hi0 = __umulhi(c0, 0xD2511F53u);
    const uint32_t lo1 = c2 * 0xCD9E8D57u, hi1 = __umulhi(c2, 0xCD9E8D57u);
    c0 = hi1 ^ c1 ^ k0; c1 = lo1; c2 = hi0 ^ c3 ^ k1; c3 = lo0;
    k0 += 0x9E3779B9u; k1 += 0xBB67AE85u;
  }
  return c0;
}

// (score, class) -> a key whose unsigned order is score order, then the
// lowest class; -0 is taken as +0, as a float comparison takes it
__device__ __forceinline__ unsigned long long arg_key(float s, int c) {
  const uint32_t u = __float_as_uint(s + 0.0f);
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)o << 32) | (0xFFFFFFFFu - (uint32_t)c);
}
__device__ __forceinline__ int key_class(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// one arrival, by the threads where `pred` holds, on the mbarrier at
// `bar`'s offset in the shared memory of the cluster's block `cta`
// (predicated: no branch may split a warpgroup between its wgmma, or ptxas
// serialises them)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta, bool pred) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .b32 ra;\n setp.ne.b32 p, %2, 0;\n"
      " mapa.shared::cluster.u32 ra, %0, %1;\n"
      " @p mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(smem_addr(bar)),
      "r"(cta), "r"((uint32_t)pred)
      : "memory");
}
// Wait for the phase of parity `parity` to complete; traps after ~2^33
// cycles (seconds). The loop is in PTX, so that the compiler sees no
// divergent branch before a warpgroup's wgmma.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n .reg .u64 t0, t1;\n mov.u64 t0, %%clock64;\n"
      "WAIT:\n mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n @p bra DONE;\n"
      " mov.u64 t1, %%clock64;\n sub.u64 t1, t1, t0;\n setp.gt.u64 p, t1, 8589934592;\n"
      " @p trap;\n bra WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` from global `src` to `dst` in the shared memory of every CTA of
// the cluster in `mask`, each CTA's mbarrier at `bar` counting them
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src, uint32_t bytes,
                                               uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// All G blocks meet here: thread 0 of each block fences, adds one to the
// counter and spins until it reaches G times the barrier's number
// (`target`). Every block is resident (cooperative launch), so spinning
// cannot deadlock; a wait of more than ~2^33 cycles (seconds) means a fault,
// and the kernel traps rather than hang the card. (A two-level version, a
// counter per 16 blocks, measured slower on the card.)
__device__ __forceinline__ void grid_sync(uint32_t* bar, uint32_t& target, uint32_t G) {
  __syncthreads();
  target += G;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(bar, 1u);
    const long long start = clock64();
    while (ld_acquire(bar) < target) {
      if (clock64() - start > (1ll << 33)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// bf16 products: wgmma, D (64 folds x N columns, f32 in registers) += A (64
// folds x 16) . B (16 x N), B from shared memory, A from shared memory (a
// ring tile) or from registers (the conditioning columns)
// ---------------------------------------------------------------------------

// the descriptor of a K-major operand under the 128-byte swizzle at shared
// address `a`: rows of 128 bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128(uint32_t a) {
  return (uint64_t)((a & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int n> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(n) : "memory");
}
// registers an asynchronous wgmma reads or writes stay where they are until
// here (the compiler sees a use)
template <int K> __device__ __forceinline__ void keep(float (&v)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(v[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&v)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(v[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void wgmma_ss<8>(float (&d)[4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5,"
      " p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<8>(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, {%4, "
      "%5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %10, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5,"
      " %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5,"
      " %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<24>(float (&d)[12], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %14, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5,"
      " %6, %7, %8, %9, %10, %11}, %12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<24>(float (&d)[12], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %17, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5,"
      " %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, %16, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5,"
      " %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5,"
      " %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, "
      "1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// fn(std::integral_constant<int, N>) for wgmma's N of a slice of n rows
// (a multiple of 8, at most 32)
template <typename Fn> __device__ __forceinline__ void with_n(int n, Fn&& fn) {
  if (n <= 8) fn(std::integral_constant<int, 8>());
  else if (n <= 16) fn(std::integral_constant<int, 16>());
  else if (n <= 24) fn(std::integral_constant<int, 24>());
  else fn(std::integral_constant<int, 32>());
}

// ---------------------------------------------------------------------------
// f32 products: out[row][fold] = sum_k Ws[row][k] * X[fold][k] over 16 x 8
// tiles by FMA. The tile (rows m0.., folds n0..) of one warp over depth
// [k0, k1), both multiples of 16 (the operands are zero-padded). acc follows
// the mma accumulator layout: acc[0], acc[1] at row m0 + g, folds n0 + 2t,
// +1; acc[2], acc[3] at row m0 + g + 8, the same folds (g = lane / 4, t =
// lane % 4). Rows at or past `nrows` read as zero weights.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tile(const float* Ws, int nrows, int wks, const float* X,
                                     int xks, int k0, int k1, int m0, int n0,
                                     float (&acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool r0 = m0 + g < nrows, r1 = m0 + g + 8 < nrows;
  const float2* w0 = reinterpret_cast<const float2*>(Ws + (size_t)(r0 ? m0 + g : 0) * wks);
  const float2* w1 = reinterpret_cast<const float2*>(Ws + (size_t)(r1 ? m0 + g + 8 : 0) * wks);
  const float2* x0 = reinterpret_cast<const float2*>(X + (size_t)(n0 + 2 * t) * xks);
  const float2* x1 = reinterpret_cast<const float2*>(X + (size_t)(n0 + 2 * t + 1) * xks);
  float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;
#pragma unroll 4
  for (int k = k0 / 2; k < k1 / 2; ++k) {
    const float2 a = w0[k], b = w1[k], u = x0[k], v = x1[k];
    c0 = fmaf(a.x, u.x, c0); c1 = fmaf(a.x, v.x, c1); c2 = fmaf(b.x, u.x, c2); c3 = fmaf(b.x, v.x, c3);
    c0 = fmaf(a.y, u.y, c0); c1 = fmaf(a.y, v.y, c1); c2 = fmaf(b.y, u.y, c2); c3 = fmaf(b.y, v.y, c3);
  }
  acc[0] = r0 ? c0 : 0.f; acc[1] = r0 ? c1 : 0.f;
  acc[2] = r1 ? c2 : 0.f; acc[3] = r1 ? c3 : 0.f;
}

// The bf16 instance never stages, but the staged path's lambdas are
// instantiated for it all the same: a tile of zeros there.
__device__ __forceinline__ void tile(const __nv_bfloat16*, int, int, const __nv_bfloat16*, int,
                                     int, int, int, int, float (&acc)[4]) {
  acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
}

template <typename W, typename Cd>
struct Params {
  const Cd* mels;     // f32: (T, F, M) when time_major, else (F, T, M)
  const Cd* aux;      // f32: (T, F, 4A) or (F, T, 4A)
  const W* cond;      // bf16: the conditioning tiles [T][MT][KC][64][64]
  const W* w[16];     // the packed weights, in W_NAMES order
  int32_t* labels;    // (F, T)
  W* xch;             // exchange buffers: 5 R wide, then 2 FC wide, each [2] parities
  unsigned long long* arg;  // [2][F] argmax keys, zeroed by the caller
  float* state;       // [G][F * (12 nu + nq)] f32, block-private
  uint32_t* bar;      // grid-barrier counter, zeroed by the caller
  Dims d;
  int greedy, time_major;
  uint32_t seed_lo, seed_hi;
};

template <typename W, typename Cd>
__global__ void __launch_bounds__(kThreads, 1) wavernn_sample_kernel(Params<W, Cd> p) {
  // bf16 weights take the tensor-core ring; f32 weights the staged FMA tiles
  constexpr bool kRing = std::is_same<W, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Dims d = p.d;
  // the warp's index through a shuffle, so that the compiler knows it is
  // uniform in the warp (a warpgroup's role must not look divergent)
  const int tid = threadIdx.x, warp = __shfl_sync(0xFFFFFFFFu, tid >> 5, 0), lane = tid & 31;
  const int F = d.F, T = d.T, M = d.M, A = d.A, R = d.R, FC = d.FC, C = d.C;
  const int nu = d.nu, nv = d.nv, nq = d.nq, G = d.G;
  const int blk = blockIdx.x;
  const int j0 = blk * nu, v0 = blk * nv, q0 = blk * nq;
  // what this block owns: units, fc columns, classes
  const int mu = max(0, min(nu, R - j0)), mv = max(0, min(nv, FC - v0));
  const int mq = max(0, min(nq, C - q0));
  const int K0 = 1 + M + A;
  // A cluster stages its operands together (below), so its blocks run the
  // same layers: a layer runs in a block when any block of its cluster owns
  // some of it (a block that owns none computes rows it never writes).
  const int rank = blk % kCluster, first = blk - rank;
  const bool use_u = first * nu < R, use_v = first * nv < FC, use_q = first * nq < C;
  // the ring's layout starts at a multiple of 1024 bytes
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* const smem = smem_raw + (kRing ? ((raw + 1023u) & ~1023u) - raw : 0u);
  const uint32_t sbase = smem_addr(smem);
  const Layout L = layout(d);
  const Ring RL = ring_layout(d);
  W* wsm = reinterpret_cast<W*>(smem);
  W* X = wsm + L.xstage;
  float* bias = reinterpret_cast<float*>(smem + (kRing ? RL.bias_off : L.bias_off));
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + L.mbar_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + RL.bar_off);
  uint64_t* empty = full + d.slots;
  uint32_t mphase = 0;
  if (tid == 0) {
    if constexpr (kRing) {
      for (int s = 0; s < d.slots; ++s) {
        mbar_init(full + s, 1);          // the block's producer, with the tile's bytes
        mbar_init(empty + s, kCluster);  // one consumer warpgroup in each block of the cluster
      }
    } else {
      mbar_init(mbar, 1);
    }
    mbar_init_fence();
  }

  // ---- the block's weight slices into shared memory, once ----
  const W* wmat[8] = {p.w[0], p.w[2], p.w[4], p.w[6], p.w[8], p.w[10], p.w[12], p.w[14]};
  const int ncols[8] = {R, 3 * R, 3 * R, 3 * R, 3 * R, FC, FC, C};
  // the global column that local row r of slice i holds, -1 for none
  auto owner = [&](int i, int r) {
    if (r >= L.rows[i]) return -1;
    if (i == 0) return r < mu ? j0 + r : -1;
    if (i <= 4) return r % nu < mu ? (r / nu) * R + j0 + r % nu : -1;
    if (i <= 6) return r < mv ? v0 + r : -1;
    return r < mq ? q0 + r : -1;
  };
  if constexpr (kRing) {
    for (int i = 0; i < 8; ++i) {
      const int n = RL.n[i], kx = RL.kx[i], width = i <= 5 ? R : FC;
      const int total = (kx + RL.kc[i] + (i == 0)) * n * kTile;
      W* dst = reinterpret_cast<W*>(smem + RL.off[i]);
      for (int e = tid; e < total; e += kThreads) {
        const int b = e / (n * kTile), r = (e / kTile) % n, k = e % kTile;
        const int col = b * kTile + k, c = col - kx * kTile;  // the slice's K column
        // the weights' K row: the exchanged columns, then the conditioning
        // columns (I: [mel, a1], the weights' rows 1.. of [x, mel, a1];
        // the others a part of aux); I's last block x, the weights' row 0
        int gk = -1;
        if (b < kx) gk = col < width ? col : -1;
        else if (b < kx + RL.kc[i])
          gk = i == 0 ? (c < M + A ? c + 1 : -1) : (c < A ? width + c : -1);
        else gk = k == 0 ? 0 : -1;
        const int oc = owner(i, r);
        dst[(size_t)(b * n + r) * kTile + ((((k >> 3) ^ (r & 7)) << 3) | (k & 7))] =
            (oc >= 0 && gk >= 0) ? wmat[i][(size_t)gk * ncols[i] + oc] : from_f<W>(0.f);
      }
    }
    // the weights are read by wgmma, through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  } else {
    for (int i = 0; i < 8; ++i) {
      const int n = L.rows[i] * L.ks[i];
      for (int e = tid; e < n; e += kThreads) {
        const int r = e / L.ks[i], k = e % L.ks[i];
        // I's operand is [mel, a1, x] (x last, so that mel and a1 start on
        // 16-byte boundaries); the weights' rows are [x, mel, a1]
        const int gk = i == 0 ? (k < M + A ? k + 1 : 0) : k;
        const int c = owner(i, r);
        wsm[L.off[i] + e] =
            (c >= 0 && k < L.K[i]) ? wmat[i][(size_t)gk * ncols[i] + c] : from_f<W>(0.f);
      }
    }
  }
  // biases: bI[nu] b1i[3nu] b1n[nu] b2i[3nu] b2n[nu] bf1[nv] bf2[nv] bf3[nq]
  float* bI = bias;
  float* b1i = bI + nu;
  float* b1n = b1i + 3 * nu;
  float* b2i = b1n + nu;
  float* b2n = b2i + 3 * nu;
  float* bf1 = b2n + nu;
  float* bf2 = bf1 + nv;
  float* bf3 = bf2 + nv;
  for (int e = tid; e < nu; e += kThreads) {
    const bool own = e < mu;
    bI[e] = own ? to_f(p.w[1][j0 + e]) : 0.f;
    b1n[e] = own ? to_f(p.w[5][j0 + e]) : 0.f;
    b2n[e] = own ? to_f(p.w[9][j0 + e]) : 0.f;
    for (int gate = 0; gate < 3; ++gate) {
      b1i[gate * nu + e] = own ? to_f(p.w[3][gate * R + j0 + e]) : 0.f;
      b2i[gate * nu + e] = own ? to_f(p.w[7][gate * R + j0 + e]) : 0.f;
    }
  }
  for (int e = tid; e < nv; e += kThreads) {
    bf1[e] = e < mv ? to_f(p.w[11][v0 + e]) : 0.f;
    bf2[e] = e < mv ? to_f(p.w[13][v0 + e]) : 0.f;
  }
  for (int e = tid; e < nq; e += kThreads) bf3[e] = e < mq ? to_f(p.w[15][q0 + e]) : 0.f;

  // ---- block-private state (f32, global, [row][fold]): h1, h2, u [nu];
  // gh1, gh2, gx [3nu]; scores [nq] ----
  float* h1 = p.state + (size_t)blk * F * (12 * nu + nq);
  float* h2 = h1 + (size_t)nu * F;
  float* us = h2 + (size_t)nu * F;
  float* gh1 = us + (size_t)nu * F;
  float* gh2 = gh1 + (size_t)3 * nu * F;
  float* gx = gh2 + (size_t)3 * nu * F;
  float* scores = gx + (size_t)3 * nu * F;
  for (size_t e = tid; e < (size_t)2 * nu * F; e += kThreads) h1[e] = 0.f;  // h1, h2

  // ---- exchange buffers, [2] parities each. bf16: swizzled tiles
  // [MT][width blocks][64][64], as the ring takes them; f32: rows [F][stride] ----
  const int RS = ceil_to(R, 8), FS = ceil_to(FC, 8);
  const int MT = cdiv(F, kTile), RT = cdiv(R, kTile), FT = cdiv(FC, kTile);
  const size_t rpar = kRing ? (size_t)MT * RT * kTileElems : (size_t)F * RS;
  const size_t fpar = kRing ? (size_t)MT * FT * kTileElems : (size_t)F * FS;
  W* const xu1 = p.xch;
  W* const xu2 = xu1 + 2 * rpar;
  W* const xu3 = xu2 + 2 * rpar;
  W* const xh1 = xu3 + 2 * rpar;
  W* const xh2 = xh1 + 2 * rpar;
  W* const xf1 = xh2 + 2 * rpar;
  W* const xf2 = xf1 + 2 * fpar;
  // the element (fold f, column col) of one parity of an R-wide (xr) or
  // FC-wide (xf) buffer
  auto xel = [&](W* base, int kb, int stride, int f, int col) -> W& {
    if constexpr (kRing)
      return base[((size_t)(f >> 6) * kb + (col >> 6)) * kTileElems + (f & 63) * kTile +
                  ((((col >> 3) & 7) ^ (f & 7)) << 3) + (col & 7)];
    else
      return base[(size_t)f * stride + col];
  };
  auto xr = [&](W* base, int f, int col) -> W& { return xel(base, RT, RS, f, col); };
  auto xf = [&](W* base, int f, int col) -> W& { return xel(base, FT, FS, f, col); };

  const size_t step_rows = p.time_major ? (size_t)F : 1;
  const size_t fold_rows = p.time_major ? 1 : (size_t)T;
  const float cls = (float)(C - 1);
  const int ksm = L.ksmax, fchunk = d.fchunk;
  constexpr int kVec = 16 / sizeof(W);  // elements per 16-byte copy
  uint32_t target = 0;
  // x_{t-1} of fold f from the winning key (0 at t = 0)
  auto x_at = [&](int t, int f) {
    if (t == 0) return 0.0f;
    const unsigned long long key = __ldcg(p.arg + (size_t)((t - 1) & 1) * F + f);
    return 2.0f * (float)key_class(key) / cls - 1.0f;
  };
  // the conditioning row of step t, fold f: mel (part < 0) or aux part `part`
  auto cond_row = [&](int part, int t, int f) {
    const Cd* base = part < 0 ? p.mels : p.aux;
    const int rowlen = part < 0 ? M : 4 * A;
    return base + ((size_t)t * step_rows + (size_t)f * fold_rows) * rowlen +
           (part < 0 ? 0 : part * A);
  };

  // ---- f32: the staged design ----
  // put(e, load(e)) for e < n, with kBatch loads of a thread in flight at
  // once: the global loads are independent, so their latency is paid once
  // per batch rather than once per element
  constexpr int kBatch = 8;
  auto gather = [&](int n, auto&& load, auto&& put) {
    for (int base = tid; base < n; base += kBatch * kThreads) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads;
        v[u] = e < n ? load(e) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = base + u * kThreads;
        if (e < n) put(e, v[u]);
      }
    }
  };
  // The conditioning columns (mel, a1..a4) come by cp.async when they are
  // plain 16-byte copies (conditioning in the weight type, every width a
  // multiple of 16 bytes), else they are gathered and converted through
  // registers. They depend on nothing the step computes, so when all folds
  // fit one stage they are staged before the barrier that precedes their
  // layer and their latency hides behind it.
  const bool cond_async = sizeof(Cd) == sizeof(W) && (M * sizeof(W)) % 16 == 0 &&
                          (A * sizeof(W)) % 16 == 0 && (R * sizeof(W)) % 16 == 0 &&
                          (FC * sizeof(W)) % 16 == 0;
  const bool single = F <= fchunk;  // one stage holds every fold
  // X[f][col, col + n) <- the mel row (part < 0) or aux part `part` of
  // step t, fold f0 + f
  auto stage_cond = [&](int col, int part, int t, int f0, int nf) {
    const int n = part < 0 ? M : A;
    if (cond_async) {
      const int vec = n * (int)sizeof(W) / 16;
      for (int e = tid; e < nf * vec; e += kThreads) {
        const int f = e / vec, c = e % vec;
        cp_async16(X + (size_t)f * ksm + col + c * kVec, cond_row(part, t, f0 + f) + c * kVec);
      }
    } else {
      gather(nf * n, [&](int e) { return to_f(cond_row(part, t, f0 + e / n)[e % n]); },
             [&](int e, float v) { X[(size_t)(e / n) * ksm + col + e % n] = from_f<W>(v); });
    }
  };
  // X[f][from, to) <- 0 (the operand's padding to a multiple of 16)
  auto stage_zero = [&](int from, int to, int nf) {
    const int n = to - from;
    for (int e = tid; e < nf * n; e += kThreads)
      X[(size_t)(e / n) * ksm + from + e % n] = from_f<W>(0.f);
  };
  // X[f][0, width) <- exchange rows src[f0 + f][.], read through L2. Each
  // block of the cluster fetches every kCluster-th row once, by a bulk copy
  // multicast into the shared memory of all the cluster's blocks, so L2
  // serves each row once per cluster instead of once per block; the cluster
  // first meets, so that no block's stage is written while it still reads
  // it, and each block's mbarrier counts the bytes in. A row's tail past
  // its last whole 16 bytes is gathered by each block (rows are 16-byte
  // aligned: their strides are multiples of 8 elements).
  auto stage_rows = [&](const W* src, int stride, int width, int f0, int nf) {
    const int head = width / kVec * kVec, rest = width - head;
    const uint32_t row_bytes = head * sizeof(W);
    cluster_sync();
    if (tid == 0) mbar_expect(mbar, nf * row_bytes);
    if (row_bytes) {
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      for (int f = rank + tid * kCluster; f < nf; f += kThreads * kCluster)
        bulk_multicast(X + (size_t)f * ksm, src + (size_t)(f0 + f) * stride, row_bytes, mbar,
                       (uint16_t)((1u << kCluster) - 1));
    }
    if (rest)
      gather(nf * rest,
             [&](int e) { return to_f(__ldcg(src + (size_t)(f0 + e / rest) * stride + head +
                                            e % rest)); },
             [&](int e, float v) {
               X[(size_t)(e / rest) * ksm + head + e % rest] = from_f<W>(v);
             });
    mbar_wait(mbar, mphase);
    mphase ^= 1;
  };
  auto stage_done = [&]() {
    cp_async_wait_all();
    __syncthreads();
  };
  // the conditioning and padding columns of each layer's operand
  const int kI = ceil_to(K0, 16), kR = ceil_to(R, 16);
  const int kF = ceil_to(FC, 16), kRA = ceil_to(R + A, 16), kFA = ceil_to(FC + A, 16);
  auto cond_I = [&](int t, int f0, int nf) {  // [mel, a1, x, 0...]: x comes later
    stage_cond(0, -1, t, f0, nf);
    stage_cond(M, 0, t, f0, nf);
    stage_zero(M + A + 1, kI, nf);
  };
  auto cond_aux = [&](int width, int part, int t, int f0, int nf) {
    stage_cond(width, part, t, f0, nf);
    stage_zero(width + A, width == R ? kRA : kFA, nf);
  };
  // out = Ws (matrix i) . X over folds [f0, f0 + nf); epi(row, fold, value)
  auto product = [&](int i, int f0, int nf, auto&& epi) {
    const int rows = L.rows[i], mt = (rows + 15) / 16, nt = (nf + 7) / 8;
    const int kpad = ceil_to(L.K[i], 16), g = lane >> 2, tq = lane & 3;
    for (int w = warp; w < mt * nt; w += kWarps) {
      const int m0 = (w % mt) * 16, n0 = (w / mt) * 8;
      float acc[4];
      tile(wsm + L.off[i], rows, L.ks[i], X, ksm, 0, kpad, m0, n0, acc);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + g + (q >> 1) * 8, f = n0 + 2 * tq + (q & 1);
        if (r < rows && f < nf) epi(r, f0 + f, acc[q]);
      }
    }
    __syncthreads();
  };
  // a layer over all folds, one stage at a time: the conditioning columns
  // (unless staged before the barrier), the exchange rows, the product
  auto stage_layer = [&](int mat, const W* src, int stride, int width, bool prestaged,
                         auto&& cond, auto&& epi) {
    for (int f0 = 0; f0 < F; f0 += fchunk) {
      const int nf = min(fchunk, F - f0);
      if (!prestaged) cond(f0, nf);
      stage_rows(src, stride, width, f0, nf);
      stage_done();
      product(mat, f0, nf, epi);
    }
  };

  // ---- bf16: the ring ----
  const int S = d.slots;
  const uint32_t ring = sbase + RL.ring;
  W* const ringp = reinterpret_cast<W*>(smem + RL.ring);
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, q = lane & 3;
  // The ring is split between the consumer warpgroups that have fold
  // tiles, Sw slots each, and each takes its own tiles through its own
  // slots in order: every wait on a slot's mbarrier is then for the phase
  // right after the last one its waiter saw (a wait by parity cannot tell
  // a phase from the one two before it). Consumer w takes fold tiles w, w +
  // kConsumers, ... (`rounds(w)` of them), each in every layer, so its k-th
  // tile through the ring is k = blocks rounds(w) + (its round) nb + kb,
  // `blocks` the K blocks of the layers before.
  const int Sw = S / max(1, min(kConsumers, MT));
  auto rounds = [&](int w) { return w < MT ? (MT - w + kConsumers - 1) / kConsumers : 0; };
  uint32_t blocks = 0;  // K blocks through the ring so far, the same in every block
  auto slot_of = [&](int w, uint32_t k) { return (uint32_t)(w * Sw) + k % (uint32_t)Sw; };
  // this warpgroup's rounds, worked out here: a branch on the warpgroup's
  // index between its wgmma reads to ptxas as a divergent path, and ptxas
  // then serialises them
  const uint32_t my_rounds = (uint32_t)rounds(wg);
  // x of the consumer's two folds of tile m (16 wq + g and 8 more) as
  // wgmma's register A fragment of a k16 step whose column 0 is x and the
  // rest zero: registers 0 and 1 hold those folds at columns 2q, 2q + 1, so
  // only q = 0 carries x, in the low half (folds past F take fold F - 1's,
  // rows that no epilogue writes)
  auto x_frag = [&](int m, int t, uint32_t (&a)[4]) {
    const int fb = m * kTile + 16 * wq + g;
    const uint32_t x0 = __bfloat16_as_ushort(__float2bfloat16(x_at(t, min(fb, F - 1))));
    const uint32_t x1 = __bfloat16_as_ushort(__float2bfloat16(x_at(t, min(fb + 8, F - 1))));
    a[0] = q == 0 ? x0 : 0u;
    a[1] = q == 0 ? x1 : 0u;
    a[2] = a[3] = 0u;
  };
  // the slot of a ring tile back to the producers of the cluster: lane c
  // of the warpgroup's first warp signals block c
  auto release = [&](uint32_t slot) {
    mbar_arrive_cluster(empty + slot, (uint32_t)(lane & (kCluster - 1)),
                        wq == 0 && lane < kCluster);
  };
  // the producer warp's side of slice i's layer: every tile of its operand.
  // Lane w Sw + l owns slot l of consumer w's part of the ring and issues
  // every use of it, in order, each once the use before it is released: so
  // the waits and copies of different slots overlap (one lane issuing all
  // tiles in turn set the pace of the whole step), and no lane waits for a
  // slot's use before it has issued the use ahead of it. This block fetches
  // rows [16 rank, 16 rank + 16) of each tile, those of folds < F, into
  // every block of the cluster. `src` the exchange tiles of this parity
  // (none for I), the conditioning tiles those of step t.
  auto produce = [&](int i, const W* src, int t) {
    const int kx = RL.kx[i], nb = kx + RL.kc[i];
    const W* cond = p.cond + ((size_t)t * MT * RL.KC + RL.coff[i]) * kTileElems;
    const int w = lane / Sw, l = lane % Sw;
    if (nb > 0 && w < min(kConsumers, MT)) {
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      const uint32_t k0 = blocks * (uint32_t)rounds(w);  // consumer w's tiles before
      // consumer w's k-th tile of this layer: round k / nb, K block k % nb
      for (int k = (l - (int)(k0 % Sw) + Sw) % Sw; k < rounds(w) * nb; k += Sw) {
        const int m = k / nb * kConsumers + w, kb = k % nb;
        const uint32_t slot = slot_of(w, k0 + k), use = (k0 + k) / Sw;
        const int real = min(kTile, F - m * kTile), r0 = 16 * rank;
        const int nrow = max(0, min(16, real - r0));
        const W* from = kb < kx ? src + ((size_t)m * kx + kb) * kTileElems
                                : cond + ((size_t)m * RL.KC + kb - kx) * kTileElems;
        mbar_wait(empty + slot, (use & 1) ^ 1);
        mbar_expect(full + slot, (uint32_t)real * kTile * 2);
        if (nrow)
          bulk_multicast(ringp + (size_t)slot * kTileElems + r0 * kTile, from + r0 * kTile,
                         (uint32_t)nrow * kTile * 2, full + slot,
                         (uint16_t)((1u << kCluster) - 1));
      }
    }
    __syncwarp();
  };
  // out = Ws (slice i) . [exchanged columns | conditioning columns] over all
  // folds, on kConsumers warpgroups, one fold tile of 64 each at a time;
  // epi(row, fold, value)
  auto ring_layer = [&](int i, const W* src, int t, auto&& epi) {
    const int nb = RL.kx[i] + RL.kc[i];  // K blocks through the ring
    const int n = RL.n[i], rows = RL.rows[i];
    const uint32_t wb = sbase + RL.off[i];
    if (warp == kProducerWarp) produce(i, src, t);
    for (int m0 = 0; m0 < MT; m0 += kConsumers) {
      const int nr = min(kConsumers, MT - m0);
      if (wg < nr) {  // (the fourth warpgroup, the producer's, takes none)
        const int m = m0 + wg;
        uint32_t xa[4] = {0u, 0u, 0u, 0u};
        if (i == 0) x_frag(m, t, xa);
        with_n(n, [&](auto nn) {
          constexpr int N = decltype(nn)::value;
          float acc[N / 2];
#pragma unroll
          for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
          keep(acc);
          keep(xa);
          wg_fence();
          // I's x: one k16 step from registers, its weights in the last block
          if (i == 0) wgmma_rs<N>(acc, xa, sw128(wb + (uint32_t)(nb * n * kTile * 2)));
          uint32_t held = 0;
          for (int kb = 0; kb < nb; ++kb) {
            const uint32_t k = blocks * my_rounds + (uint32_t)(m0 / kConsumers * nb + kb);
            const uint32_t slot = slot_of(wg, k);
            mbar_wait(full + slot, (k / Sw) & 1);
            // a fence of our own before each tile's wgmma: one that ptxas
            // inserts after the wait lands in a divergent path, and ptxas
            // then serialises every wgmma
            wg_fence();
            const uint32_t a = ring + slot * kTileBytes, b = wb + (uint32_t)(kb * n * kTile * 2);
#pragma unroll
            for (int s = 0; s < 4; ++s) wgmma_ss<N>(acc, sw128(a + 32 * s), sw128(b + 32 * s));
            wg_commit();
            if (kb > 0) {
              wg_wait<1>();
              release(held);
            }
            held = slot;
          }
          if (nb == 0) wg_commit();
          wg_wait<0>();
          if (nb > 0) release(held);
          keep(acc);
          keep(xa);
          // acc[4 j + 2 h + c]: fold 16 wq + g + 8 h of the tile, column 8 j + 2 q + c
          const int fb = m * kTile + 16 * wq + g;
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int r = 8 * j + 2 * q + c, f = fb + 8 * h;
                if (r < rows && f < F) epi(r, f, acc[4 * j + 2 * h + c]);
              }
        });
      }
    }
    blocks += (uint32_t)nb;
    __syncthreads();
  };

  // one GRU's gates for the block's units: h' = GRU(gx + bi, gh, bn; h);
  // u += h'; rounded h' -> xh, rounded u -> xu (this step's parity)
  auto gates = [&](const float* bi, const float* bn, const float* gh, float* h, W* xh,
                   W* xu) {
    for (int e = tid; e < mu * F; e += kThreads) {
      const int i = e / F, f = e % F;
      const size_t a = (size_t)i * F + f, b = a + (size_t)nu * F, c = b + (size_t)nu * F;
      const float r = sigm((gx[a] + bi[i]) + gh[a]);
      const float z = sigm((gx[b] + bi[nu + i]) + gh[b]);
      const float n = tanhf((gx[c] + bi[2 * nu + i]) + r * (gh[c] + bn[i]));
      const float hn = (1.0f - z) * n + z * h[a];
      h[a] = hn;
      const float u = us[a] + hn;
      us[a] = u;
      xr(xh, f, j0 + i) = from_f<W>(hn);
      xr(xu, f, j0 + i) = from_f<W>(u);
    }
    __syncthreads();
  };
  auto no_cond = [&](int width, int kpad) {
    return [&, width, kpad](int, int nf) { stage_zero(width, kpad, nf); };
  };

  cluster_sync();  // every mbarrier of the cluster is initialised
  if (!kRing && use_u && single) cond_I(0, 0, F);
  for (int t = 0; t <= T; ++t) {
    const int par = t & 1, prv = par ^ 1;
    // block 0 writes the labels of step t-1 and clears the keys of step t
    if (blk == 0)
      for (int f = tid; f < F; f += kThreads) {
        if (t > 0)
          p.labels[(size_t)f * T + (t - 1)] = key_class(__ldcg(p.arg + (size_t)prv * F + f));
        if (t < T) p.arg[(size_t)par * F + f] = 0ull;
      }
    if (t == T) break;
    W* const u1 = xu1 + par * rpar;
    W* const u2 = xu2 + par * rpar;
    W* const u3 = xu3 + par * rpar;
    W* const f1 = xf1 + par * fpar;
    W* const f2 = xf2 + par * fpar;
    // a layer through the ring (bf16) or staged (f32); `part` the aux part
    // of its conditioning columns (-1: none)
    auto run_layer = [&](int mat, W* src, bool fc_wide, int part, auto&& epi) {
      if constexpr (kRing) {
        ring_layer(mat, src, t, epi);
      } else {
        const int width = fc_wide ? FC : R;
        if (part < 0)
          stage_layer(mat, src, fc_wide ? FS : RS, width, false, no_cond(width, fc_wide ? kF : kR),
                      epi);
        else
          stage_layer(mat, src, fc_wide ? FS : RS, width, single,
                      [&](int f0, int nf) { cond_aux(width, part, t, f0, nf); }, epi);
      }
    };
    // f32: the conditioning columns of aux part `part` (-1: I's operand)
    // of step t, before the barrier that precedes their layer, when one
    // stage holds every fold (bf16: they come through the ring)
    auto prestage = [&](int part, int t) {
      if (!kRing && single) {
        if (part < 0) cond_I(t, 0, F);
        else cond_aux(part == 3 ? FC : R, part, t, 0, F);
      }
    };
    auto gx_of = [&](int r, int f, float v) { gx[(size_t)r * F + f] = v; };
    // P1: u = I [mel, a1, x] + b
    if (use_u) {
      auto epi_u = [&](int r, int f, float v) {
        if (r < mu) {
          const float u = v + bI[r];
          us[(size_t)r * F + f] = u;
          xr(u1, f, j0 + r) = from_f<W>(u);
        }
      };
      if constexpr (kRing) {
        ring_layer(0, nullptr, t, epi_u);
      } else {
        for (int f0 = 0; f0 < F; f0 += fchunk) {
          const int nf = min(fchunk, F - f0);
          if (!single) cond_I(t, f0, nf);
          for (int f = tid; f < nf; f += kThreads)
            X[(size_t)f * ksm + M + A] = from_f<W>(x_at(t, f0 + f));
          stage_done();
          product(0, f0, nf, epi_u);
        }
      }
      // P1 (cont.): the hidden products of step t-1's states
      run_layer(2, xh1 + prv * rpar, false, -1,
                [&](int r, int f, float v) { gh1[(size_t)r * F + f] = v; });
      run_layer(4, xh2 + prv * rpar, false, -1,
                [&](int r, int f, float v) { gh2[(size_t)r * F + f] = v; });
    }
    grid_sync(p.bar, target, G);
    // P2: GRU1 on u; u += h1
    if (use_u) {
      run_layer(1, u1, false, -1, gx_of);
      gates(b1i, b1n, gh1, h1, xh1 + par * rpar, u2);
      prestage(1, t);
    }
    grid_sync(p.bar, target, G);
    // P3: GRU2 on [u, a2]; u += h2
    if (use_u) {
      run_layer(3, u2, false, 1, gx_of);
      gates(b2i, b2n, gh2, h2, xh2 + par * rpar, u3);
    }
    if (use_v) prestage(2, t);
    grid_sync(p.bar, target, G);
    // P4: fc1 = relu(W [u, a3] + b)
    if (use_v) {
      run_layer(5, u3, false, 2, [&](int r, int f, float v) {
        if (r < mv) xf(f1, f, v0 + r) = from_f<W>(fmaxf(v + bf1[r], 0.f));
      });
      prestage(3, t);
    }
    grid_sync(p.bar, target, G);
    // P5: fc2 = relu(W [fc1, a4] + b)
    if (use_v) {
      run_layer(6, f1, true, 3, [&](int r, int f, float v) {
        if (r < mv) xf(f2, f, v0 + r) = from_f<W>(fmaxf(v + bf2[r], 0.f));
      });
    }
    grid_sync(p.bar, target, G);
    // P6: logits of the block's classes (+ Gumbel noise), best per fold
    if (use_q) {
      run_layer(7, f2, true, -1, [&](int r, int f, float v) {
        if (r < mq) {
          float s = v + bf3[r];
          if (!p.greedy) {
            const uint32_t bits = philox((uint32_t)(q0 + r), (uint32_t)f, (uint32_t)t, 0u,
                                         p.seed_lo, p.seed_hi);
            const float u = (float)(bits & 0x7FFFFFu) * (1.0f / 8388608.0f) + 1e-7f;
            s += -logf(-logf(u));
          }
          scores[(size_t)r * F + f] = s;
        }
      });
      for (int f = tid; f < F && mq > 0; f += kThreads) {
        float best = scores[f];
        int idx = 0;
        for (int r = 1; r < mq; ++r) {
          const float s = scores[(size_t)r * F + f];
          if (s > best) { best = s; idx = r; }
        }
        atomicMax(p.arg + (size_t)par * F + f, arg_key(best, q0 + idx));
      }
    }
    if (use_u && t + 1 < T) prestage(-1, t + 1);
    grid_sync(p.bar, target, G);
  }
  // no block leaves while another of its cluster may still signal its
  // mbarriers or copy into its shared memory
  cluster_sync();
}

// The launch configuration: G blocks of kThreads in clusters of kCluster,
// cooperative when `cooperative` (the occupancy query takes the cluster
// only). `attrs` holds the attributes `cfg` points at.
void configure(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attrs)[2], int G, int smem,
               bool cooperative, cudaStream_t stream) {
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = kCluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg = {};
  cfg.gridDim = dim3(G);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = cooperative ? 2 : 1;
}

// The blocks of the kernel that the card keeps resident at once, in
// clusters of kCluster, with `smem` bytes of shared memory each.
template <typename W, typename Cd>
cudaError_t resident_blocks(int smem, int* out) {
  auto kernel = wavernn_sample_kernel<W, Cd>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  configure(cfg, attrs, kCluster, smem, false, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  *out = clusters * kCluster;
  return err;
}

template <typename W, typename Cd>
int launch(const void* mels, const void* aux, const void* const* wp, void* labels, void* xch,
           void* arg, void* state, void* bar, const Dims& d, int smem, int greedy,
           int time_major, unsigned long long seed, cudaStream_t stream) {
  constexpr bool kRing = std::is_same<W, __nv_bfloat16>::value;
  const int bytes = kRing ? ring_layout(d).bytes : layout(d).bytes;
  const bool shape_ok = kRing ? d.slots >= kMinSlots && ceil_to(3 * d.nu, 8) <= 32 &&
                                    ceil_to(d.nv, 8) <= 32 && ceil_to(d.nq, 8) <= 32
                              : d.fchunk >= 8;
  if (bytes != smem || smem > kSmemLimit || d.G % kCluster || !shape_ok)
    return (int)cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err = resident_blocks<W, Cd>(smem, &resident);
  if (err != cudaSuccess) return (int)err;
  if (d.G > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params<W, Cd> p;
  p.mels = kRing ? nullptr : static_cast<const Cd*>(mels);
  p.aux = kRing ? nullptr : static_cast<const Cd*>(aux);
  p.cond = kRing ? static_cast<const W*>(mels) : nullptr;
  for (int i = 0; i < 16; ++i) p.w[i] = static_cast<const W*>(wp[i]);
  p.labels = static_cast<int32_t*>(labels);
  p.xch = static_cast<W*>(xch);
  p.arg = static_cast<unsigned long long*>(arg);
  p.state = static_cast<float*>(state);
  p.bar = static_cast<uint32_t*>(bar);
  p.d = d;
  p.greedy = greedy;
  p.time_major = time_major;
  p.seed_lo = (uint32_t)(seed & 0xFFFFFFFFull);
  p.seed_hi = (uint32_t)(seed >> 32);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  configure(cfg, attrs, d.G, smem, true, stream);
  err = cudaLaunchKernelEx(&cfg, wavernn_sample_kernel<W, Cd>, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The 16 packed weights in one dtype (f32 when bf16 == 0, else bf16). f32:
// mels (T, F, M) and aux (T, F, 4A) when time_major, else mels (F, T, M)
// and aux (F, T, 4A). bf16: mels the conditioning tiles (`cond_tiles` in
// wavernn_sample.py), aux unused, time_major ignored. labels (F, T) int32.
// The plan (G blocks; nu units, nv fc columns and nq classes per block; f32:
// fchunk folds per stage; bf16: slots tiles in the ring; smem bytes) comes
// from `plan` in wavernn_sample.py, and the workspaces at the sizes it
// gives: xch (exchange buffers, weight dtype, zeroed), arg (zeroed uint64),
// state (f32), bar (a zeroed uint32). Launches cooperatively on `stream`
// without synchronising; returns the CUDA error code of the launch
// (cudaErrorInvalidValue when `smem` disagrees with the kernel's own layout,
// G is not a multiple of the cluster size or the plan is not one the kernel
// takes, cudaErrorCooperativeLaunchTooLarge when G blocks cannot all be
// resident).
extern "C" int wavernn_sample_launch(const void* mels, const void* aux,
                                     const void* const* weights, void* labels, void* xch,
                                     void* arg, void* state, void* bar, int F, int T, int M,
                                     int A, int R, int FC, int C, int G, int nu, int nv, int nq,
                                     int fchunk, int slots, int smem, int bf16, int greedy,
                                     int time_major, unsigned long long seed, void* stream) {
  if (F <= 0 || T <= 0) return 0;
  const Dims d{F, T, M, A, R, FC, C, G, nu, nv, nq, fchunk, slots, bf16 ? 2 : 4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(mels, aux, weights, labels, xch, arg, state,
                                                bar, d, smem, greedy, time_major, seed, s);
  return launch<float, float>(mels, aux, weights, labels, xch, arg, state, bar, d, smem,
                              greedy, time_major, seed, s);
}

// The blocks the card keeps resident at once, in clusters of 4, of the
// kernel for these weights (f32 when bf16 == 0, else bf16), at the most
// shared memory a block may use: the grid `plan` may take. Writes it to
// `out`; returns the CUDA error code.
extern "C" int wavernn_sample_resident_blocks(int bf16, int* out) {
  if (!bf16) return (int)resident_blocks<float, float>(kSmemLimit, out);
  return (int)resident_blocks<__nv_bfloat16, __nv_bfloat16>(kSmemLimit, out);
}

extern "C" const char* wavernn_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
