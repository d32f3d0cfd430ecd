// Fused WaveRNN autoregressive sampler for Hopper (sm_90a): a persistent,
// weight-stationary kernel.
//
// Replaces the TPU kernels `_kernel_v2` (time-major conditioning) and `_kernel`
// (fold-major conditioning) of mockingbird_tpu/ops/wavernn_sample.py, both
// reached from `wavernn_sample_pallas`: one kernel reads either layout through
// its row strides, the fold-major (F, T, D) f32 one in place. Per step, for
// F independent folds: I-dense of [x_prev, mel_t, a1] -> GRU1 (+residual) -> GRU2
// on [u, a2] (+residual) -> relu fc1 [u, a3] -> relu fc2 [u, a4] -> fc3 logits
// -> Gumbel-max sample (argmax when greedy) -> x = 2*label/(C-1) - 1 fed back.
//
// What bounds it on this card: the work is about 2 x 4.07 M multiply-adds per
// fold per step at full width, on 8.1 MB of bf16 weights, and the T steps are
// strictly sequential. Counted once per call the function is bound by its
// operations. Step by step, a design in which a block re-reads every weight
// each step is bound by how fast one SM streams 8.1 MB out of L2 (about
// 70 us a step at ~110 GB/s): the weights have to stay put instead.
//
// What the design does about it:
//   * one cooperative launch (cudaLaunchKernelEx, cooperative) of G blocks
//     in clusters of 4, one per SM, all resident, looping over all T steps;
//     G is a multiple of 4 no larger than what the card keeps resident in
//     clusters of 4 (`wavernn_sample_resident_blocks`), 128 at full width,
//     and the launcher refuses any other;
//   * each block owns a slice of output columns of every layer and loads
//     that slice of every weight matrix into shared memory once, before the
//     step loop (64 KB of bf16 at full width on 128 blocks; 128 KB in f32):
//     nu whole GRU units (the r, z and n rows of g*_wi and g*_wh, and the
//     same nu columns of I, so the residual u never leaves the block), nv
//     columns of fc1 and of fc2, nq classes of fc3;
//   * after a layer, each block writes its columns of the layer's output for
//     all F folds, rounded to the weight type as the reference rounds before
//     each product, into a global exchange buffer (double-buffered by step
//     parity); a grid barrier follows; then every block stages the full
//     input rows it needs into shared memory, F folds in chunks that fit:
//     each block of a cluster fetches every 4th row once by a bulk copy
//     (which reads L2, never the SMs' non-coherent L1) multicast into all
//     the cluster's blocks, an mbarrier in each counting the bytes in; the
//     conditioning columns (mel, a1..a4) come from the conditioning input;
//   * the hidden products g1_wh.h1[t-1] and g2_wh.h2[t-1] depend only on the
//     previous step and run in the same phase as the I-dense;
//   * products: bf16 weights on the tensor cores by mma.sync.m16n8k16 (bf16
//     in, f32 sums), the block's weight rows in the 16-row A operand and 8
//     folds in N; f32 weights, the parity mode, by f32 FMA on the same tiles;
//   * sampling: each block adds Gumbel noise to its own classes only and
//     folds its best (score, class) per fold into one 64-bit atomicMax key
//     (score ordered, then the lowest class); after the barrier every block
//     reads the winner of each fold, so x_t needs no further barrier;
//   * the grid barrier is hand-written: __syncthreads, then thread 0 fences
//     (__threadfence), adds one to a global counter and spins with
//     ld.acquire.gpu until the counter reaches G times the barrier's number.
//     Six per step: after I (with the hidden products), GRU1, GRU2, fc1,
//     fc2 and fc3's partial argmax.
// Expected floor per step: the 6 barriers (about 1.5 us each with 128
// blocks) plus the staging of the exchanged rows (about 0.5 MB into each
// block at F = 72, bf16, 63 MiB over all blocks, of which L2 serves a
// quarter with clusters of 4), about 15 us; the products' latency comes on
// top. PERF.md records the measured split by phase.
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

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 4;  // blocks per cluster: they share the staging of exchanged rows
constexpr int kSmemLimit = 232448;

__host__ __device__ constexpr int ceil_to(int v, int m) { return (v + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// the launch plan's shared-memory layout (mirrored by `plan` in
// wavernn_sample.py, which the launcher checks against)
// ---------------------------------------------------------------------------

struct Dims {
  int F, T, M, A, R, FC, C;  // folds, steps, mel, aux part, rnn, fc, classes
  int G, nu, nv, nq, fchunk;  // blocks; units, fc columns, classes per block; folds per stage
  int wbytes;                 // 2 (bf16) or 4 (f32)
};

// row stride (elements) of a K-wide operand in shared memory: K padded to the
// mma depth (16), plus 16 bytes so that the 8 row groups of a fragment load
// fall on distinct banks
__host__ __device__ inline int kstride(int K, int wbytes) {
  return ceil_to(K, 16) + 16 / wbytes;
}

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
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the phase of parity `parity` to complete; traps after seconds.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 33)) __trap();
  }
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
// products: out[row][fold] = sum_k Ws[row][k] * X[fold][k] over 16 x 8 tiles
// ---------------------------------------------------------------------------

// The tile (rows m0.., folds n0..) of one warp over depth [k0, k1), both
// multiples of 16 (the operands are zero-padded). acc follows the mma
// accumulator layout: acc[0], acc[1] at row m0 + g, folds n0 + 2t, +1;
// acc[2], acc[3] at row m0 + g + 8, the same folds (g = lane / 4, t = lane %
// 4). Rows at or past `nrows` read as zero weights.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void tile(const __nv_bfloat16* Ws, int nrows, int wks,
                                     const __nv_bfloat16* X, int xks, int k0, int k1, int m0,
                                     int n0, float (&acc)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool r0 = m0 + g < nrows, r1 = m0 + g + 8 < nrows;
  const uint32_t* a0p =
      reinterpret_cast<const uint32_t*>(Ws + (size_t)(r0 ? m0 + g : 0) * wks) + t;
  const uint32_t* a1p =
      reinterpret_cast<const uint32_t*>(Ws + (size_t)(r1 ? m0 + g + 8 : 0) * wks) + t;
  const uint32_t* bp = reinterpret_cast<const uint32_t*>(X + (size_t)(n0 + g) * xks) + t;
  // two independent accumulators, so that two mma are in flight (four
  // measured slower on the card: more registers, more spills)
  float e[4] = {0.f, 0.f, 0.f, 0.f}, o[4] = {0.f, 0.f, 0.f, 0.f};
  auto step = [&](float (&dd)[4], int s) {
    const int w = s * 8;  // 32-bit words per 16 bf16
    mma_bf16(dd, r0 ? a0p[w] : 0u, r1 ? a1p[w] : 0u, r0 ? a0p[w + 4] : 0u,
             r1 ? a1p[w + 4] : 0u, bp[w], bp[w + 4]);
  };
  int s = k0 / 16;
  const int s1 = k1 / 16;
  for (; s + 1 < s1; s += 2) {
    step(e, s);
    step(o, s + 1);
  }
  if (s < s1) step(e, s);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = e[i] + o[i];
}

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

template <typename W, typename Cd>
struct Params {
  const Cd* mels;     // (T, F, M) when time_major, else (F, T, M)
  const Cd* aux;      // (T, F, 4A) or (F, T, 4A)
  const W* w[16];     // the packed weights, in W_NAMES order
  int32_t* labels;    // (F, T)
  W* xch;             // exchange rows: 5 x [2][F][ceil8(R)], then 2 x [2][F][ceil8(FC)]
  unsigned long long* arg;  // [2][F] argmax keys, zeroed by the caller
  float* state;       // [G][F * (12 nu + nq)] f32, block-private
  uint32_t* bar;      // grid-barrier counter, zeroed by the caller
  Dims d;
  int greedy, time_major;
  uint32_t seed_lo, seed_hi;
};

template <typename W, typename Cd>
__global__ void __launch_bounds__(kThreads, 1) wavernn_sample_kernel(Params<W, Cd> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Dims d = p.d;
  const Layout L = layout(d);
  W* wsm = reinterpret_cast<W*>(smem);
  W* X = wsm + L.xstage;
  float* bias = reinterpret_cast<float*>(smem + L.bias_off);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem + L.mbar_off);
  uint32_t mphase = 0;
  if (tid == 0) mbar_init(mbar);

  // ---- the block's weight slices into shared memory, once ----
  const W* wmat[8] = {p.w[0], p.w[2], p.w[4], p.w[6], p.w[8], p.w[10], p.w[12], p.w[14]};
  const int ncols[8] = {R, 3 * R, 3 * R, 3 * R, 3 * R, FC, FC, C};
  for (int i = 0; i < 8; ++i) {
    const int n = L.rows[i] * L.ks[i];
    for (int e = tid; e < n; e += kThreads) {
      const int r = e / L.ks[i], k = e % L.ks[i];
      int c = -1;  // the global column local row r holds
      if (i == 0) c = r < mu ? j0 + r : -1;
      else if (i <= 4) c = r % nu < mu ? (r / nu) * R + j0 + r % nu : -1;
      else if (i <= 6) c = r < mv ? v0 + r : -1;
      else c = r < mq ? q0 + r : -1;
      // I's operand is [mel, a1, x] (x last, so that mel and a1 start on
      // 16-byte boundaries); the weights' rows are [x, mel, a1]
      const int gk = i == 0 ? (k < M + A ? k + 1 : 0) : k;
      wsm[L.off[i] + e] =
          (c >= 0 && k < L.K[i]) ? wmat[i][(size_t)gk * ncols[i] + c] : from_f<W>(0.f);
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

  // ---- exchange rows, [2][F][stride] each ----
  const int RS = ceil_to(R, 8), FS = ceil_to(FC, 8);
  W* const xu1 = p.xch;
  W* const xu2 = xu1 + (size_t)2 * F * RS;
  W* const xu3 = xu2 + (size_t)2 * F * RS;
  W* const xh1 = xu3 + (size_t)2 * F * RS;
  W* const xh2 = xh1 + (size_t)2 * F * RS;
  W* const xf1 = xh2 + (size_t)2 * F * RS;
  W* const xf2 = xf1 + (size_t)2 * F * FS;

  const size_t step_rows = p.time_major ? (size_t)F : 1;
  const size_t fold_rows = p.time_major ? 1 : (size_t)T;
  const float cls = (float)(C - 1);
  const int ksm = L.ksmax, fchunk = d.fchunk;
  constexpr int kVec = 16 / sizeof(W);  // elements per 16-byte copy
  uint32_t target = 0;

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
    const Cd* base = part < 0 ? p.mels : p.aux;
    const int rowlen = part < 0 ? M : 4 * A, n = part < 0 ? M : A;
    const int off = part < 0 ? 0 : part * A;
    auto src = [&](int f) {
      return base + ((size_t)t * step_rows + (size_t)(f0 + f) * fold_rows) * rowlen + off;
    };
    if (cond_async) {
      const int vec = n * (int)sizeof(W) / 16;
      for (int e = tid; e < nf * vec; e += kThreads) {
        const int f = e / vec, c = e % vec;
        cp_async16(X + (size_t)f * ksm + col + c * kVec, src(f) + c * kVec);
      }
    } else {
      gather(nf * n, [&](int e) { return to_f(src(e / n)[e % n]); },
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
  const int kI = ceil_to(K0, 16), kR = ceil_to(R, 16), kRA = ceil_to(R + A, 16);
  const int kF = ceil_to(FC, 16), kFA = ceil_to(FC + A, 16);
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
  // one GRU's gates for the block's units: h' = GRU(gx + bi, gh, bn; h);
  // u += h'; rounded h' -> xh, rounded u -> xu
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
      xh[(size_t)f * RS + j0 + i] = from_f<W>(hn);
      xu[(size_t)f * RS + j0 + i] = from_f<W>(u);
    }
    __syncthreads();
  };

  // a layer over all folds, one stage at a time: the conditioning columns
  // (unless staged before the barrier), the exchange rows, the product
  auto layer = [&](int mat, const W* src, int stride, int width, bool prestaged,
                   auto&& cond, auto&& epi) {
    for (int f0 = 0; f0 < F; f0 += fchunk) {
      const int nf = min(fchunk, F - f0);
      if (!prestaged) cond(f0, nf);
      stage_rows(src, stride, width, f0, nf);
      stage_done();
      product(mat, f0, nf, epi);
    }
  };
  auto no_cond = [&](int width, int kpad) {
    return [&, width, kpad](int, int nf) { stage_zero(width, kpad, nf); };
  };

  cluster_sync();  // every mbarrier of the cluster is initialised
  if (single && use_u) cond_I(0, 0, F);
  for (int t = 0; t <= T; ++t) {
    const int par = t & 1, prv = par ^ 1;
    // x_{t-1} of every fold from the winning key (0 at t = 0); block 0
    // writes the labels of step t-1 and clears the keys of step t
    auto x_of = [&](int f) {
      if (t == 0) return 0.0f;
      const unsigned long long key = __ldcg(p.arg + (size_t)prv * F + f);
      const int idx = (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
      if (blk == 0) p.labels[(size_t)f * T + (t - 1)] = idx;
      return 2.0f * (float)idx / cls - 1.0f;
    };
    if (t == T) {
      if (blk == 0)
        for (int f = tid; f < F; f += kThreads) x_of(f);
      break;
    }
    // P1: u = I [mel, a1, x] + b
    if (use_u) {
      for (int f0 = 0; f0 < F; f0 += fchunk) {
        const int nf = min(fchunk, F - f0);
        if (!single) cond_I(t, f0, nf);
        for (int f = tid; f < nf; f += kThreads) {
          X[(size_t)f * ksm + M + A] = from_f<W>(x_of(f0 + f));
          if (blk == 0) p.arg[(size_t)par * F + f0 + f] = 0ull;
        }
        stage_done();
        product(0, f0, nf, [&](int r, int f, float v) {
          if (r < mu) {
            const float u = v + bI[r];
            us[(size_t)r * F + f] = u;
            xu1[((size_t)par * F + f) * RS + j0 + r] = from_f<W>(u);
          }
        });
      }
    }
    // P1 (cont.): the hidden products of step t-1's states
    if (use_u) {
      layer(2, xh1 + (size_t)prv * F * RS, RS, R, false, no_cond(R, kR),
            [&](int r, int f, float v) { gh1[(size_t)r * F + f] = v; });
      layer(4, xh2 + (size_t)prv * F * RS, RS, R, false, no_cond(R, kR),
            [&](int r, int f, float v) { gh2[(size_t)r * F + f] = v; });
    }
    grid_sync(p.bar, target, G);
    // P2: GRU1 on u; u += h1
    if (use_u) {
      layer(1, xu1 + (size_t)par * F * RS, RS, R, false, no_cond(R, kR),
            [&](int r, int f, float v) { gx[(size_t)r * F + f] = v; });
      gates(b1i, b1n, gh1, h1, xh1 + (size_t)par * F * RS, xu2 + (size_t)par * F * RS);
      if (single) cond_aux(R, 1, t, 0, F);
    }
    grid_sync(p.bar, target, G);
    // P3: GRU2 on [u, a2]; u += h2
    if (use_u) {
      layer(3, xu2 + (size_t)par * F * RS, RS, R, single,
            [&](int f0, int nf) { cond_aux(R, 1, t, f0, nf); },
            [&](int r, int f, float v) { gx[(size_t)r * F + f] = v; });
      gates(b2i, b2n, gh2, h2, xh2 + (size_t)par * F * RS, xu3 + (size_t)par * F * RS);
    }
    if (single && use_v) cond_aux(R, 2, t, 0, F);
    grid_sync(p.bar, target, G);
    // P4: fc1 = relu(W [u, a3] + b)
    if (use_v) {
      layer(5, xu3 + (size_t)par * F * RS, RS, R, single,
            [&](int f0, int nf) { cond_aux(R, 2, t, f0, nf); },
            [&](int r, int f, float v) {
              if (r < mv)
                xf1[((size_t)par * F + f) * FS + v0 + r] = from_f<W>(fmaxf(v + bf1[r], 0.f));
            });
      if (single) cond_aux(FC, 3, t, 0, F);
    }
    grid_sync(p.bar, target, G);
    // P5: fc2 = relu(W [fc1, a4] + b)
    if (use_v) {
      layer(6, xf1 + (size_t)par * F * FS, FS, FC, single,
            [&](int f0, int nf) { cond_aux(FC, 3, t, f0, nf); },
            [&](int r, int f, float v) {
              if (r < mv)
                xf2[((size_t)par * F + f) * FS + v0 + r] = from_f<W>(fmaxf(v + bf2[r], 0.f));
            });
    }
    grid_sync(p.bar, target, G);
    // P6: logits of the block's classes (+ Gumbel noise), best per fold
    if (use_q) {
      layer(7, xf2 + (size_t)par * F * FS, FS, FC, false, no_cond(FC, kF),
            [&](int r, int f, float v) {
              if (r < mq) {
                float s = v + bf3[r];
                if (!p.greedy) {
                  const uint32_t bits = philox((uint32_t)(q0 + r), (uint32_t)f, (uint32_t)t,
                                               0u, p.seed_lo, p.seed_hi);
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
    if (single && use_u && t + 1 < T) cond_I(t + 1, 0, F);
    grid_sync(p.bar, target, G);
  }
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
  const Layout L = layout(d);
  if (L.bytes != smem || smem > kSmemLimit || d.G % kCluster) return (int)cudaErrorInvalidValue;
  int resident = 0;
  cudaError_t err = resident_blocks<W, Cd>(smem, &resident);
  if (err != cudaSuccess) return (int)err;
  if (d.G > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
  Params<W, Cd> p;
  p.mels = static_cast<const Cd*>(mels);
  p.aux = static_cast<const Cd*>(aux);
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

// The 16 packed weights in one dtype (f32 when bf16 == 0, else bf16); mels
// (T, F, M) and aux (T, F, 4A) in that dtype when time_major, else mels
// (F, T, M) and aux (F, T, 4A) in f32; labels (F, T) int32. The plan (G
// blocks; nu units, nv fc columns and nq classes per block; fchunk folds per
// stage; smem bytes) comes from `plan` in wavernn_sample.py, and the
// workspaces at the sizes it gives: xch (exchange rows, weight dtype), arg
// (zeroed uint64), state (f32), bar (a zeroed uint32). Launches
// cooperatively on `stream` without synchronising; returns the CUDA error
// code of the launch (cudaErrorInvalidValue when `smem` disagrees with the
// kernel's own layout or G is not a multiple of the cluster size,
// cudaErrorCooperativeLaunchTooLarge when G blocks cannot all be resident).
extern "C" int wavernn_sample_launch(const void* mels, const void* aux,
                                     const void* const* weights, void* labels, void* xch,
                                     void* arg, void* state, void* bar, int F, int T, int M,
                                     int A, int R, int FC, int C, int G, int nu, int nv, int nq,
                                     int fchunk, int smem, int bf16, int greedy, int time_major,
                                     unsigned long long seed, void* stream) {
  if (F <= 0 || T <= 0) return 0;
  const Dims d{F, T, M, A, R, FC, C, G, nu, nv, nq, fchunk, bf16 ? 2 : 4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch<float, float>(mels, aux, weights, labels, xch, arg, state, bar, d, smem,
                                greedy, time_major, seed, s);
  if (time_major)
    return launch<__nv_bfloat16, __nv_bfloat16>(mels, aux, weights, labels, xch, arg, state,
                                                bar, d, smem, greedy, 1, seed, s);
  return launch<__nv_bfloat16, float>(mels, aux, weights, labels, xch, arg, state, bar, d,
                                      smem, greedy, 0, seed, s);
}

// The blocks the card keeps resident at once, in clusters of 4, of the
// kernel for these weights (f32 when bf16 == 0, else bf16) and conditioning
// layout, at the most shared memory a block may use: the grid `plan` may
// take. Writes it to `out`; returns the CUDA error code.
extern "C" int wavernn_sample_resident_blocks(int bf16, int time_major, int* out) {
  if (!bf16) return (int)resident_blocks<float, float>(kSmemLimit, out);
  if (time_major) return (int)resident_blocks<__nv_bfloat16, __nv_bfloat16>(kSmemLimit, out);
  return (int)resident_blocks<__nv_bfloat16, float>(kSmemLimit, out);
}

extern "C" const char* wavernn_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
