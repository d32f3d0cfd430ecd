// The element-wise work between two convolutions of a HiFi-GAN generator
// (HiFi-GAN, and the decoder of VITS), in one pass over channels-last
// memory, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package left this work to XLA, which
// fuses it into the convolutions' neighbours. In the port each step was a
// full-tensor pass of its own (bias add, residual add, block sum, its
// division, leaky ReLU, tanh), besides the pads and layout transposes that
// channels-last memory removes. Per element of a convolution's output y,
// bias b[c] along the contiguous channel axis c, in float32 and rounded to
// the storage type where PyTorch's separate operators round:
//
//   v = y (+ b[c]) (+ residual)                -> out_x      (the new residual)
//   v = (sum +) v (* (1.0f / n_blocks))        -> out_sum    (the block sum)
//   v = tanh(v) | leaky_relu(v, slope)         -> out_act    (the next input)
//
// Each step is optional (flags); an output is written only where asked.
// Given the same convolution outputs the result is bit for bit that of the
// operators it replaces: each sum is taken in float32 and rounded once, the
// division is PyTorch's on a card (a product with the float32 reciprocal),
// leaky ReLU is `v > 0 ? v : v * slope` and tanh is `tanhf`.
//
// What bounds it on this card: bytes. It reads one to three tensors and
// writes one or two, with a few flops an element; at the flagship's widest
// stage (128 x 204,800 samples x 64 channels of bf16, 3.36 GB a tensor) a
// pass that reads two and writes two moves 13.4 GB, 4.0 ms at 3.35 TB/s.
//
// What the design does about it: one 16-byte vector a thread (8 bf16 or 4
// float32), every load issued before any store; the bias vector comes from
// the channel index of the vector's first element (C a multiple of the
// vector width), so it is one more 16-byte load from L1. A width or an
// address that does not allow the vector falls to one element a thread.
// An output may alias an input (the wrapper writes in place into the
// convolution's output or the block sum): each thread reads its elements
// before it writes them and touches no other thread's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum : int {
  kBias = 1,
  kResidual = 2,
  kSum = 4,
  kScale = 8,
  kTanh = 16,
  kLeaky = 32,
  kOutX = 64,
  kOutSum = 128,
};

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T st(float v);
template <> __device__ __forceinline__ float st<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 st<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back: where a PyTorch operator on T tensors rounds
template <typename T> __device__ __forceinline__ float rnd(float v) { return ld(st<T>(v)); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void conv_epilogue_kernel(const T* y, const T* bias, const T* residual, const T* sum,
                                     T* out_x, T* out_sum, T* out_act, int64_t n_packs, int C,
                                     int flags, float slope, float inv_n) {
  using P = Pack<T, VEC>;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_packs) return;
  const int c = (int)((i * VEC) % C);
  P py = reinterpret_cast<const P*>(y)[i], pb, pr, ps;
  if (flags & kBias) pb = *reinterpret_cast<const P*>(bias + c);
  if (flags & kResidual) pr = reinterpret_cast<const P*>(residual)[i];
  if (flags & kSum) ps = reinterpret_cast<const P*>(sum)[i];
  P px, pt, pa;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float v = ld(py.v[k]);
    if (flags & kBias) v = rnd<T>(v + ld(pb.v[k]));
    if (flags & kResidual) v = rnd<T>(v + ld(pr.v[k]));
    px.v[k] = st<T>(v);
    if (flags & kSum) v = rnd<T>(ld(ps.v[k]) + v);
    if (flags & kScale) v = rnd<T>(v * inv_n);
    pt.v[k] = st<T>(v);
    if (flags & kTanh) v = tanhf(v);
    if (flags & kLeaky) v = v > 0.f ? v : v * slope;
    pa.v[k] = st<T>(v);
  }
  if (flags & kOutX) reinterpret_cast<P*>(out_x)[i] = px;
  if (flags & kOutSum) reinterpret_cast<P*>(out_sum)[i] = pt;
  if (out_act) reinterpret_cast<P*>(out_act)[i] = pa;
}

template <typename T, int VEC>
int launch(const void* y, const void* bias, const void* residual, const void* sum, void* out_x,
           void* out_sum, void* out_act, int64_t n, int C, int flags, float slope, int n_blocks,
           cudaStream_t stream) {
  const int threads = 256;
  const int64_t n_packs = n / VEC;
  const int64_t blocks = (n_packs + threads - 1) / threads;
  const float inv_n = (flags & kScale) ? 1.0f / (float)n_blocks : 1.0f;
  conv_epilogue_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(bias), static_cast<const T*>(residual),
      static_cast<const T*>(sum), static_cast<T*>(out_x), static_cast<T*>(out_sum),
      static_cast<T*>(out_act), n_packs, C, flags, slope, inv_n);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype 0 = float32, 1 = bfloat16; n = elements of y (rows x C); every
// tensor pointer but bias (C elements) covers n. out_act null = not written.
extern "C" int conv_epilogue_launch(const void* y, const void* bias, const void* residual,
                                    const void* sum, void* out_x, void* out_sum, void* out_act,
                                    int64_t n, int C, int dtype, int flags, float slope,
                                    int n_blocks, void* stream) {
  if (n <= 0) return 0;
  if (C <= 0 || n % C != 0 || dtype < 0 || dtype > 1) return (int)cudaErrorInvalidValue;
  if ((flags & kScale) && n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const int vec = dtype == 1 ? 8 : 4;
  const bool packed = C % vec == 0 && aligned16(y) && aligned16(bias) && aligned16(residual) &&
                      aligned16(sum) && aligned16(out_x) && aligned16(out_sum) &&
                      aligned16(out_act);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return packed ? launch<__nv_bfloat16, 8>(y, bias, residual, sum, out_x, out_sum, out_act, n,
                                             C, flags, slope, n_blocks, s)
                  : launch<__nv_bfloat16, 1>(y, bias, residual, sum, out_x, out_sum, out_act, n,
                                             C, flags, slope, n_blocks, s);
  }
  return packed ? launch<float, 4>(y, bias, residual, sum, out_x, out_sum, out_act, n, C, flags,
                                   slope, n_blocks, s)
                : launch<float, 1>(y, bias, residual, sum, out_x, out_sum, out_act, n, C, flags,
                                   slope, n_blocks, s);
}

extern "C" const char* conv_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
