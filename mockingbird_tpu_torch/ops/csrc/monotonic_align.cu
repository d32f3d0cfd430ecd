// Monotonic alignment search (VITS MAS) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mas_kernel` of
// mockingbird_tpu/ops/monotonic_align_pallas.py (reached from
// `maximum_path_pallas`). Per batch element: the forward DP
//   value[y, x] = neg_cent[y, x] + max(value[y-1, x], value[y-1, x-1])
// inside the band t_x + y - t_y <= x <= min(y, t_x - 1), every other cell
// exactly -1e9, no stay on the diagonal x == y; then a backtrack from
// (t_y - 1, t_x - 1) that steps left when x == y or
// value[y-1, x] < value[y-1, x-1] (strictly less), writing a one-hot path.
//
// What bounds it on this card: counted once per call, bytes (neg_cent read,
// path written: 2 x B*T_y*T_x*4 B, about 6 us at (16, 1000, 160)); the
// operations are negligible. But the T_y rows form a chain of dependent,
// block-wide steps, and the backtrack a chain of T_y dependent steps of one
// thread, so the time is set by latency, not by either bound.
//
// What the design does about it (a simple, correct first version):
//   * batch elements are independent: one block per element, no grid sync;
//   * thread x owns column x (T_x <= 1024 fits one block) and keeps
//     value[y-1, x] in a register; the x-1 neighbour comes through a
//     double-buffered row in shared memory, so each row costs one barrier;
//   * the full f32 table (640 KB at (1000, 160)) exceeds shared memory and is
//     not needed: the backtrack needs only the decision
//     step_left(y, x) = (x == y) || value[y-1, x] < value[y-1, x-1],
//     taken in the forward as one bit per cell with a warp ballot and kept in
//     shared memory (20 KB at (1000, 160));
//   * all threads write the path's zeros, one thread walks the t_y real rows
//     over the bits and writes the ones.
// Numerics: the masked value is exactly -1e9 and each cell is one f32 add
// (row + best, no FMA), in the plain version's order, so paths agree
// exactly with it, ties included.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void maximum_path_kernel(const float* __restrict__ neg_cent,
                                    const int32_t* __restrict__ t_ys,
                                    const int32_t* __restrict__ t_xs,
                                    float* __restrict__ path, int TY, int TX) {
  extern __shared__ uint32_t smem[];
  const int nthreads = blockDim.x;        // TX rounded up to a warp multiple
  const int words = nthreads >> 5;        // decision words per row
  float* rows = reinterpret_cast<float*>(smem);  // [2][nthreads]
  uint32_t* bits = smem + 2 * nthreads;           // [TY][words]

  const int b = blockIdx.x;
  const int x = threadIdx.x;
  const int lane = x & 31, warp = x >> 5;
  const int t_y = min(max(t_ys[b], 0), TY);
  const int t_x = min(max(t_xs[b], 0), TX);
  const float kNeg = -1e9f;
  const float* nc = neg_cent + (size_t)b * TY * TX;

  float prev = kNeg;  // value[y-1, x]
  for (int y = 0; y < t_y; ++y) {
    float* buf = rows + (y & 1) * nthreads;
    buf[x] = prev;
    __syncthreads();
    const float left = x > 0 ? buf[x - 1] : kNeg;  // value[y-1, x-1]
    // the backtrack's decision at (y, x), from row y-1
    const bool step_left = y > 0 && (x == y || prev < left);
    const uint32_t ballot = __ballot_sync(0xffffffffu, step_left);
    if (lane == 0) bits[(size_t)y * words + warp] = ballot;

    float best = fmaxf(x == y ? kNeg : prev, left);
    if (y == 0) best = x == 0 ? 0.0f : kNeg;
    const float row = x < TX ? nc[(size_t)y * TX + x] : 0.0f;
    float v = __fadd_rn(row, best);
    const int band_lo = t_x + y - t_y;
    if (x > y || x < band_lo || x >= t_x) v = kNeg;
    prev = v;
  }

  float* out = path + (size_t)b * TY * TX;
  for (int i = x; i < TY * TX; i += nthreads) out[i] = 0.0f;
  __syncthreads();
  if (x == 0) {
    int index = max(t_x - 1, 0);
    for (int y = t_y - 1; y >= 0; --y) {
      out[(size_t)y * TX + index] = 1.0f;
      const uint32_t word = bits[(size_t)y * words + (index >> 5)];
      if (index != 0 && ((word >> (index & 31)) & 1u)) --index;
    }
  }
}

}  // namespace

// neg_cent (B, TY, TX) f32, t_ys and t_xs (B,) int32, path (B, TY, TX) f32.
// Launches on `stream` without synchronising; returns the CUDA error code of
// the launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int maximum_path_launch(const void* neg_cent, const void* t_ys, const void* t_xs,
                                   void* path, int B, int TY, int TX, void* stream) {
  if (B <= 0 || TY <= 0 || TX <= 0) return 0;
  if (TX > 1024) return (int)cudaErrorInvalidValue;
  const int nthreads = ((TX + 31) / 32) * 32;
  const size_t smem = sizeof(uint32_t) * (2 * (size_t)nthreads + (size_t)TY * (nthreads / 32));
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(maximum_path_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  maximum_path_kernel<<<B, nthreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(neg_cent), static_cast<const int32_t*>(t_ys),
      static_cast<const int32_t*>(t_xs), static_cast<float*>(path), TY, TX);
  return (int)cudaGetLastError();
}

extern "C" const char* maximum_path_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
