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
// operations are negligible. But the T_y rows form a chain of dependent
// steps, and the backtrack a chain of T_y dependent steps of one thread, so
// the time is set by latency and by the instructions one warp issues per
// row, not by either bound.
//
// What the design does about it:
//   * batch elements are independent: one block per element, no grid sync;
//   * one warp carries a whole row (T_x <= 1024): lane l holds the C =
//     ceil(T_x / 32) consecutive columns [l*C, l*C + C) of value[y-1, .] in
//     registers; the x-1 neighbour of its first column comes from lane l-1
//     by one __shfl_up_sync, so a row costs no barrier at all;
//   * one warp issues every instruction of a row, so the row is kept
//     short: each lane loads its own columns of neg_cent into a ring of
//     registers D rows deep (16 rows at C <= 4, 2 at C > 16) through a
//     running pointer, each load issued D rows before its row is used (off
//     the chain), and the band test is one unsigned compare per cell (a
//     ring in shared memory fed by cp.async measured slower: its issue and
//     wait instructions sit on the one warp's path);
//   * the backtrack needs only the decision
//     step_left(y, x) = (x == y) || value[y-1, x] < value[y-1, x-1]:
//     each lane packs the decisions of its C columns into one C-bit word
//     (8, 16 or 32 bits wide) and stores it once per row: bit j of lane l's
//     word is column l*C + j (32 KB at (1000, 160));
//   * the wrapper hands in the path already zeroed (a memset at the card's
//     full bandwidth); after the DP, lane 0 walks the t_y real rows back
//     over the decision words and writes the ones, reading the words of the
//     row below for both columns it can move to before its step is known.
// Numerics: the masked value is exactly -1e9 and each cell is one f32 add
// (row + best, no FMA), in the plain version's order, so paths agree
// exactly with it, ties included.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr float kNeg = -1e9f;

// rows of neg_cent in flight: enough that a row's load, issued kRing - 1
// rows ahead, has landed from device memory when it is read (64 rows at
// ~100 cycles each cover ~6k cycles), at most 64 KB of ring
// rows of neg_cent a lane holds in registers ahead of their use
__host__ __device__ constexpr int ahead_rows(int c) {
  return c <= 4 ? 16 : c <= 8 ? 8 : c <= 16 ? 4 : 2;
}
// bytes of one lane's decision word per row
__host__ __device__ constexpr int word_bytes(int c) { return c <= 8 ? 1 : c <= 16 ? 2 : 4; }

template <int B> struct Word;
template <> struct Word<1> { using type = uint8_t; };
template <> struct Word<2> { using type = uint16_t; };
template <> struct Word<4> { using type = uint32_t; };

// One warp per batch element; `path` arrives zeroed.
template <int C>
__global__ void __launch_bounds__(32)
maximum_path_kernel(const float* __restrict__ neg_cent, const int32_t* __restrict__ t_ys,
                    const int32_t* __restrict__ t_xs, float* __restrict__ path, int TY,
                    int TX) {
  using word_t = typename Word<word_bytes(C)>::type;
  constexpr int kAhead = ahead_rows(C);
  extern __shared__ __align__(16) uint32_t smem[];
  word_t* bits = reinterpret_cast<word_t*>(smem);    // [TY][32]

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int t_y = min(max(t_ys[b], 0), TY);
  const int t_x = min(max(t_xs[b], 0), TX);
  const float* nc = neg_cent + (size_t)b * TY * TX;
  float* out = path + (size_t)b * TY * TX;

  {
    const int x0 = lane * C;
    // the band t_x + y - t_y <= x <= min(y, t_x - 1) as one unsigned compare,
    // (y - lo[j]) <= span with span = t_y - t_x. Past t_x, and everywhere
    // when t_y < t_x (which leaves no band), lo[j] = 2^30: y - 2^30 as
    // unsigned is at least 2^31, above any span, so no cell is in
    const unsigned span = t_y >= t_x ? (unsigned)(t_y - t_x) : 0u;
    int lo[C];
    bool in_row[C];  // the column exists in neg_cent
#pragma unroll
    for (int j = 0; j < C; ++j) {
      lo[j] = (x0 + j < t_x && t_y >= t_x) ? x0 + j : (1 << 30);
      in_row[j] = x0 + j < TX;
    }
    float ahead[kAhead][C];  // rows y .. y + kAhead - 1 of this lane's columns
    const float* next = nc + x0;  // row y + kAhead of this lane's columns, once primed
    int next_y = 0;
    auto load = [&](float (&dst)[C]) {
      const bool live = next_y < t_y;
#pragma unroll
      for (int j = 0; j < C; ++j) dst[j] = (live && in_row[j]) ? __ldg(next + j) : 0.0f;
      next += TX;
      ++next_y;
    };
#pragma unroll
    for (int d = 0; d < kAhead; ++d) load(ahead[d]);

    float prev[C];  // value[y-1, x0 + j]
#pragma unroll
    for (int j = 0; j < C; ++j) prev[j] = kNeg;
    for (int y0 = 0; y0 < t_y; y0 += kAhead) {
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        const int y = y0 + d;
        if (y >= t_y) break;
        float left0 = __shfl_up_sync(0xffffffffu, prev[C - 1], 1);  // value[y-1, x0-1]
        if (lane == 0) left0 = kNeg;
        uint32_t word = 0;
#pragma unroll
        for (int j = C - 1; j >= 0; --j) {  // downwards: prev[j-1] is still row y-1
          const int x = x0 + j;
          const float p = prev[j];
          const float left = j ? prev[j - 1] : left0;
          word |= (uint32_t)(y > 0 && (x == y || p < left)) << j;
          float best = fmaxf(x == y ? kNeg : p, left);
          if (y == 0) best = x == 0 ? 0.0f : kNeg;
          const float v = __fadd_rn(ahead[d][j], best);  // the row is 0 past TX
          prev[j] = (unsigned)(y - lo[j]) <= span ? v : kNeg;
        }
        bits[(size_t)y * 32 + lane] = (word_t)word;
        load(ahead[d]);
      }
    }
  }
  __syncwarp();
  if (lane == 0 && t_y > 0) {
    // column index = wl * C + wj; the words of the row below for both
    // columns the walk can move to are read before this row's step is known
    int index = max(t_x - 1, 0), wl = index / C, wj = index % C;
    uint32_t word = bits[(size_t)(t_y - 1) * 32 + wl];
    float* cell = out + (size_t)(t_y - 1) * TX;
    for (int y = t_y - 1; y >= 0; --y, cell -= TX) {
      cell[index] = 1.0f;
      const word_t* below = bits + (size_t)(y > 0 ? y - 1 : 0) * 32;
      const uint32_t stay = below[wl], move = below[wj || wl == 0 ? wl : wl - 1];
      if (index != 0 && ((word >> wj) & 1u)) {
        --index;
        wl = wj ? wl : wl - 1;
        wj = wj ? wj - 1 : C - 1;
        word = move;
      } else {
        word = stay;
      }
    }
  }
}

template <int C>
int launch(const void* neg_cent, const void* t_ys, const void* t_xs, void* path, int B, int TY,
           int TX, cudaStream_t stream) {
  const size_t smem = (size_t)32 * word_bytes(C) * TY;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kernel = maximum_path_kernel<C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B, 32, smem, stream>>>(
      static_cast<const float*>(neg_cent), static_cast<const int32_t*>(t_ys),
      static_cast<const int32_t*>(t_xs), static_cast<float*>(path), TY, TX);
  return (int)cudaGetLastError();
}

using Launch = int (*)(const void*, const void*, const void*, void*, int, int, int,
                       cudaStream_t);

template <int... Cs>
struct Table {
  static constexpr Launch fns[] = {launch<Cs + 1>...};
};

template <int... Is>
constexpr Table<Is...> make_table(std::integer_sequence<int, Is...>) { return {}; }

}  // namespace

// neg_cent (B, TY, TX) f32, t_ys and t_xs (B,) int32, path (B, TY, TX) f32
// zeroed by the caller.
// Launches on `stream` without synchronising; returns the CUDA error code of
// the launch (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int maximum_path_launch(const void* neg_cent, const void* t_ys, const void* t_xs,
                                   void* path, int B, int TY, int TX, void* stream) {
  if (B <= 0 || TY <= 0 || TX <= 0) return 0;
  if (TX > 1024) return (int)cudaErrorInvalidValue;
  using T = decltype(make_table(std::make_integer_sequence<int, 32>{}));
  return T::fns[(TX + 31) / 32 - 1](neg_cent, t_ys, t_xs, path, B, TY, TX,
                                    static_cast<cudaStream_t>(stream));
}

extern "C" const char* maximum_path_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
