// Fused WaveRNN autoregressive sampler for Hopper (sm_90a).
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
// operations; step by step, a block that re-reads every weight each step is
// bound by how fast one SM can stream 8.1 MB out of L2.
//
// What the design does about it (a simple, correct first version):
//   * the folds are independent, only time is sequential: one block takes
//     kFolds folds and loops over all T steps itself, so no block ever waits
//     for another and there is no grid-wide sync;
//   * the state (h1, h2, u, x) of the block's folds lives in shared memory;
//   * the weights (8.1 MB, too large for one SM's 227 KB) stream from global
//     memory every step and stay resident in the 50 MB L2; each weight read is
//     reused for all kFolds folds of the block;
//   * thread j owns output column j of every dense layer (and unit j of both
//     GRUs), so weight reads are coalesced rows of the (in, out) matrices and
//     each thread finishes its GRU units without exchanging partial sums.
// Later work: wgmma tiles, weights spread over SMs, TMA-fed conditioning.
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
constexpr int kFolds = 4;  // folds per block

template <typename W>
struct Weights {
  const W* I_w; const W* I_b;
  const W* g1_wi; const W* g1_bi; const W* g1_wh; const W* g1_bn;
  const W* g2_wi; const W* g2_bi; const W* g2_wh; const W* g2_bn;
  const W* fc1_w; const W* fc1_b; const W* fc2_w; const W* fc2_b;
  const W* fc3_w; const W* fc3_b;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

template <typename W> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
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

// acc[f] (+)= sum_k in[f*ld_in + k] * w[k*n + col], for the block's folds.
template <typename W>
__device__ __forceinline__ void dot_col(float (&acc)[kFolds], const float* in, int ld_in,
                                        int K, const W* __restrict__ w, int n, int col) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float wv = ld(w + (size_t)k * n + col);
#pragma unroll
    for (int f = 0; f < kFolds; ++f) acc[f] = fmaf(in[f * ld_in + k], wv, acc[f]);
  }
}

// One GRU unit j for the block's folds: x (rounded, K wide) and h (rounded)
// from shared memory; h_own is the f32 state. Writes h' into h_own.
template <typename W>
__device__ __forceinline__ void gru_unit(const float* x, int ld_x, int K, const float* hr,
                                         float* h_own, int R, int j, const W* __restrict__ wi,
                                         const W* __restrict__ bi, const W* __restrict__ wh,
                                         const W* __restrict__ bn, float (&hnew)[kFolds]) {
  float xr[kFolds], xz[kFolds], xn[kFolds], hr_[kFolds], hz[kFolds], hn[kFolds];
#pragma unroll
  for (int f = 0; f < kFolds; ++f) { xr[f] = xz[f] = xn[f] = hr_[f] = hz[f] = hn[f] = 0.f; }
  const int n3 = 3 * R;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const W* row = wi + (size_t)k * n3;
    const float wr = ld(row + j), wz = ld(row + R + j), wn = ld(row + 2 * R + j);
#pragma unroll
    for (int f = 0; f < kFolds; ++f) {
      const float v = x[f * ld_x + k];
      xr[f] = fmaf(v, wr, xr[f]); xz[f] = fmaf(v, wz, xz[f]); xn[f] = fmaf(v, wn, xn[f]);
    }
  }
#pragma unroll 2
  for (int k = 0; k < R; ++k) {
    const W* row = wh + (size_t)k * n3;
    const float wr = ld(row + j), wz = ld(row + R + j), wn = ld(row + 2 * R + j);
#pragma unroll
    for (int f = 0; f < kFolds; ++f) {
      const float v = hr[f * R + k];
      hr_[f] = fmaf(v, wr, hr_[f]); hz[f] = fmaf(v, wz, hz[f]); hn[f] = fmaf(v, wn, hn[f]);
    }
  }
  const float br = ld(bi + j), bz = ld(bi + R + j), bnx = ld(bi + 2 * R + j), bhn = ld(bn + j);
#pragma unroll
  for (int f = 0; f < kFolds; ++f) {
    const float r = sigm((xr[f] + br) + hr_[f]);
    const float z = sigm((xz[f] + bz) + hz[f]);
    const float n = tanhf((xn[f] + bnx) + r * (hn[f] + bhn));
    const float h = h_own[f * R + j];
    hnew[f] = (1.0f - z) * n + z * h;
    h_own[f * R + j] = hnew[f];
  }
}

// Conditioning of type Cd: time-major (T, F, D) in the weight type, or
// fold-major (F, T, D) in f32; either way rounded to W before the products.
template <typename W, typename Cd>
__global__ void __launch_bounds__(kThreads)
wavernn_sample_kernel(const Cd* __restrict__ mels, const Cd* __restrict__ aux, Weights<W> w,
                      int32_t* __restrict__ labels, int F, int T, int M, int A, int R,
                      int FC, int C, int greedy, int time_major, uint32_t seed_lo,
                      uint32_t seed_hi) {
  extern __shared__ float smem[];
  const int K0 = 1 + M + A;                     // I-dense input width
  const int KX = max(K0, max(R, FC) + A);       // input-row stride
  float* xa = smem;                             // [kFolds][KX] rounded inputs
  float* xb = xa + kFolds * KX;                 // [kFolds][KX] rounded inputs
  float* us = xb + kFolds * KX;                 // [kFolds][R]  residual stream u
  float* h1 = us + kFolds * R;                  // [kFolds][R]  GRU1 state (f32)
  float* h1r = h1 + kFolds * R;                 // [kFolds][R]  GRU1 state rounded
  float* h2 = h1r + kFolds * R;
  float* h2r = h2 + kFolds * R;
  float* logits = h2r + kFolds * R;             // [kFolds][C]
  float* xs = logits + kFolds * C;              // [kFolds]     previous sample

  const int tid = threadIdx.x;
  const int f0 = blockIdx.x * kFolds;
  const int nf = min(kFolds, F - f0);
  const int A4 = 4 * A;
  const float cls = (float)(C - 1);

  // conditioning row of fold f at step t, in rows: (t, f) of (T, F, .) or
  // (f, t) of (F, T, .)
  const size_t step_rows = time_major ? (size_t)F : 1, fold_rows = time_major ? 1 : (size_t)T;
  auto row = [&](int t, int f) { return (size_t)t * step_rows + (size_t)(f0 + f) * fold_rows; };
  auto mel_row = [&](int t, int f) { return mels + row(t, f) * M; };
  auto aux_row = [&](int t, int f) { return aux + row(t, f) * A4; };
  // xin[f][0 .. K0) = [x (set later), mel_t, a1_t]
  auto load_cond = [&](float* xin, int t) {
    for (int i = tid; i < kFolds * (K0 - 1); i += kThreads) {
      const int f = i / (K0 - 1), k = i % (K0 - 1);
      float v = 0.f;
      if (f < nf) v = rnd<W>(k < M ? ld(mel_row(t, f) + k) : ld(aux_row(t, f) + (k - M)));
      xin[f * KX + 1 + k] = v;
    }
  };
  // xin[f][off .. off+A) = aux part `part` of step t
  auto load_aux = [&](float* xin, int off, int t, int part) {
    for (int i = tid; i < kFolds * A; i += kThreads) {
      const int f = i / A, a = i % A;
      xin[f * KX + off + a] = f < nf ? rnd<W>(ld(aux_row(t, f) + part * A + a)) : 0.f;
    }
  };

  for (int i = tid; i < kFolds * R; i += kThreads) { h1[i] = h1r[i] = h2[i] = h2r[i] = 0.f; }
  if (tid < kFolds) { xs[tid] = 0.f; xa[tid * KX] = 0.f; }
  load_cond(xa, 0);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // P1: u = I [x, mel, a1] + b  -> us (f32) and xb (rounded)
    for (int j = tid; j < R; j += kThreads) {
      float acc[kFolds];
      const float b = ld(w.I_b + j);
#pragma unroll
      for (int f = 0; f < kFolds; ++f) acc[f] = b;
      dot_col(acc, xa, KX, K0, w.I_w, R, j);
#pragma unroll
      for (int f = 0; f < kFolds; ++f) { us[f * R + j] = acc[f]; xb[f * KX + j] = rnd<W>(acc[f]); }
    }
    __syncthreads();
    // P2: GRU1 on u; u += h1 -> xa = [u, a2]
    load_aux(xa, R, t, 1);
    for (int j = tid; j < R; j += kThreads) {
      float hn[kFolds];
      gru_unit(xb, KX, R, h1r, h1, R, j, w.g1_wi, w.g1_bi, w.g1_wh, w.g1_bn, hn);
#pragma unroll
      for (int f = 0; f < kFolds; ++f) {
        const float u = us[f * R + j] + hn[f];
        us[f * R + j] = u;
        xa[f * KX + j] = rnd<W>(u);
      }
    }
    __syncthreads();
    // P3: GRU2 on [u, a2]; u += h2 -> xb = [u, a3]; publish rounded h1
    load_aux(xb, R, t, 2);
    for (int j = tid; j < R; j += kThreads) {
      float hn[kFolds];
      gru_unit(xa, KX, R + A, h2r, h2, R, j, w.g2_wi, w.g2_bi, w.g2_wh, w.g2_bn, hn);
#pragma unroll
      for (int f = 0; f < kFolds; ++f) {
        const float u = us[f * R + j] + hn[f];
        xb[f * KX + j] = rnd<W>(u);
        h1r[f * R + j] = rnd<W>(h1[f * R + j]);
      }
    }
    __syncthreads();
    // P4: fc1 = relu(W [u, a3] + b) -> xa = [fc1, a4]; publish rounded h2
    load_aux(xa, FC, t, 3);
    for (int j = tid; j < FC; j += kThreads) {
      float acc[kFolds];
      const float b = ld(w.fc1_b + j);
#pragma unroll
      for (int f = 0; f < kFolds; ++f) acc[f] = b;
      dot_col(acc, xb, KX, R + A, w.fc1_w, FC, j);
#pragma unroll
      for (int f = 0; f < kFolds; ++f) xa[f * KX + j] = rnd<W>(fmaxf(acc[f], 0.f));
    }
    for (int i = tid; i < kFolds * R; i += kThreads) h2r[i] = rnd<W>(h2[i]);
    __syncthreads();
    // P5: fc2 = relu(W [fc1, a4] + b) -> xb
    for (int j = tid; j < FC; j += kThreads) {
      float acc[kFolds];
      const float b = ld(w.fc2_b + j);
#pragma unroll
      for (int f = 0; f < kFolds; ++f) acc[f] = b;
      dot_col(acc, xa, KX, FC + A, w.fc2_w, FC, j);
#pragma unroll
      for (int f = 0; f < kFolds; ++f) xb[f * KX + j] = rnd<W>(fmaxf(acc[f], 0.f));
    }
    __syncthreads();
    // P6: logits = W fc2 + b (+ Gumbel noise); prefetch step t+1's conditioning
    if (t + 1 < T) load_cond(xa, t + 1);
    for (int c = tid; c < C; c += kThreads) {
      float acc[kFolds];
      const float b = ld(w.fc3_b + c);
#pragma unroll
      for (int f = 0; f < kFolds; ++f) acc[f] = b;
      dot_col(acc, xb, KX, FC, w.fc3_w, C, c);
#pragma unroll
      for (int f = 0; f < kFolds; ++f) {
        float s = acc[f];
        if (!greedy) {
          const uint32_t bits = philox((uint32_t)c, (uint32_t)(f0 + f), (uint32_t)t, 0u,
                                       seed_lo, seed_hi);
          const float u = (float)(bits & 0x7FFFFFu) * (1.0f / 8388608.0f) + 1e-7f;
          s += -logf(-logf(u));
        }
        logits[f * C + c] = s;
      }
    }
    __syncthreads();
    // P7: argmax per fold (one warp per fold, lowest index wins ties)
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < kFolds) {
      const int f = warp;
      float best = -__int_as_float(0x7f800000);  // -inf
      int idx = C;
      for (int c = lane; c < C; c += 32) {
        const float v = logits[f * C + c];
        if (v > best) { best = v; idx = c; }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
        if (ob > best || (ob == best && oi < idx)) { best = ob; idx = oi; }
      }
      if (lane == 0) {
        if (f < nf) labels[(size_t)(f0 + f) * T + t] = idx;
        const float x = 2.0f * (float)idx / cls - 1.0f;
        xs[f] = x;
        xa[f * KX] = rnd<W>(x);
      }
    }
    __syncthreads();
  }
}

template <typename W, typename Cd>
int launch(const void* mels, const void* aux, const void* const* wp, void* labels, int F,
           int T, int M, int A, int R, int FC, int C, int greedy, int time_major,
           unsigned long long seed, cudaStream_t stream) {
  Weights<W> w;
  const W** dst = reinterpret_cast<const W**>(&w);
  for (int i = 0; i < 16; ++i) dst[i] = static_cast<const W*>(wp[i]);
  const int K0 = 1 + M + A;
  const int KX = K0 > ((R > FC ? R : FC) + A) ? K0 : ((R > FC ? R : FC) + A);
  const size_t smem = sizeof(float) * ((size_t)kFolds * (2 * KX + 5 * R + C) + kFolds);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = wavernn_sample_kernel<W, Cd>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (F + kFolds - 1) / kFolds;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Cd*>(mels), static_cast<const Cd*>(aux), w,
      static_cast<int32_t*>(labels), F, T, M, A, R, FC, C, greedy, time_major,
      (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32));
  return (int)cudaGetLastError();
}

}  // namespace

// The 16 packed weights in one dtype (f32 when bf16 == 0, else bf16); mels
// (T, F, M) and aux (T, F, 4A) in that dtype when time_major, else mels
// (F, T, M) and aux (F, T, 4A) in f32; labels (F, T) int32. Launches on
// `stream` without synchronising; returns the CUDA error code of the launch.
extern "C" int wavernn_sample_launch(const void* mels, const void* aux,
                                     const void* const* weights, void* labels, int F, int T,
                                     int M, int A, int R, int FC, int C, int bf16, int greedy,
                                     int time_major, unsigned long long seed, void* stream) {
  if (F <= 0 || T <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch<float, float>(mels, aux, weights, labels, F, T, M, A, R, FC, C, greedy,
                                time_major, seed, s);
  if (time_major)
    return launch<__nv_bfloat16, __nv_bfloat16>(mels, aux, weights, labels, F, T, M, A, R,
                                                FC, C, greedy, 1, seed, s);
  return launch<__nv_bfloat16, float>(mels, aux, weights, labels, F, T, M, A, R, FC, C,
                                      greedy, 0, seed, s);
}

extern "C" const char* wavernn_sample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
