// Fused window attention for SwinIR, written for Hopper (sm_90a).
//
// Replaces both Pallas TPU kernels of srbh_tpu/ops/pallas/window_attention.py:
// _attn_kernel (unshifted windows) and _attn_kernel_masked (shifted windows,
// where window b adds the additive shift mask mask[b % nW]). One kernel takes
// an optional mask pointer and covers both:
//
//     o[h, b] = softmax(q[h, b] * d^-1/2 @ k[h, b]^T + bias[h] (+ mask[b % nW])) @ v[h, b]
//
// q, k, v and o are contiguous (heads, windows, N, d), bias is (heads, N, N)
// f32 and mask is (nW, N, N) f32. N <= 64 and d <= 64. Inputs are f32 or
// bf16; every product, the softmax and the output sum are taken in f32.
//
// What bounds it on this card: one (head, window) pair reads q, k and v once
// and writes o once (4 * N * d values) and does 4 * N^2 * d operations, about
// 16 operations per f32 byte at N = 64, d = 30. That sits just under the
// H100's balance point for f32 arithmetic outside the tensor cores (67 TFLOP/s
// against 3.35 TB/s, about 20 operations per byte), so device-memory traffic
// is the bound, with arithmetic close behind. The design therefore touches
// device memory once per value: one thread block per (window, head) stages
// that window's K and V in shared memory (at most 2 * 64 * 65 * 4 B, 33 KB,
// under the 48 KB static limit), each warp owns one query row at a time, and
// the N x N scores and probabilities never leave the block. Lane j scores keys
// j and j + 32, a warp-shuffle max and sum give the softmax, and the lanes then
// split the d output columns of p @ V. The K tile's row stride is made odd so
// that the 32 lanes, each reading a different key row, hit 32 different banks.
// Tensor-core products (wgmma), TMA staging and several windows per block are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 64;
constexpr int kMaxD = 64;
constexpr int kWarps = 8;

__device__ __forceinline__ float load_f32(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f32(float* p, long i, float x) { p[i] = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, long i, float x) {
  p[i] = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ o,
                        int windows, int n, int d, int n_mask, float scale) {
  __shared__ float ks[kMaxN * (kMaxD + 1)];
  __shared__ float vs[kMaxN * kMaxD];
  __shared__ float qs[kWarps][kMaxD];
  __shared__ float ps[kWarps][kMaxN];

  const int b = blockIdx.x;  // window
  const int h = blockIdx.y;  // head
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kd = d | 1;  // odd stride: key rows j = lane fall in distinct banks
  const long base = ((long)h * windows + b) * n * d;

  for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
    const int j = i / d;
    const int c = i - j * d;
    ks[j * kd + c] = load_f32(k, base + i);
    vs[i] = load_f32(v, base + i);
  }
  __syncthreads();

  const float* bias_h = bias + (long)h * n * n;
  const float* mask_w = mask ? mask + (long)(b % n_mask) * n * n : nullptr;
  const int j0 = lane;
  const int j1 = lane + 32;

  for (int row = warp; row < n; row += kWarps) {
    for (int c = lane; c < d; c += 32) {
      qs[warp][c] = load_f32(q, base + (long)row * d + c) * scale;
    }
    __syncwarp();

    float s0 = -INFINITY;
    float s1 = -INFINITY;
    if (j0 < n) {
      float acc = 0.f;
      for (int c = 0; c < d; ++c) acc = fmaf(qs[warp][c], ks[j0 * kd + c], acc);
      s0 = acc + bias_h[row * n + j0];
      if (mask_w) s0 += mask_w[row * n + j0];
    }
    if (j1 < n) {
      float acc = 0.f;
      for (int c = 0; c < d; ++c) acc = fmaf(qs[warp][c], ks[j1 * kd + c], acc);
      s1 = acc + bias_h[row * n + j1];
      if (mask_w) s1 += mask_w[row * n + j1];
    }

    float m = fmaxf(s0, s1);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    const float e0 = j0 < n ? expf(s0 - m) : 0.f;
    const float e1 = j1 < n ? expf(s1 - m) : 0.f;
    float sum = e0 + e1;
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (j0 < n) ps[warp][j0] = e0 / sum;
    if (j1 < n) ps[warp][j1] = e1 / sum;
    __syncwarp();

    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(ps[warp][j], vs[j * d + c], acc);
      store_f32(o, base + (long)row * d + c, acc);
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* mask, void* o, int heads, int windows, int n, int d,
           int n_mask, float scale, void* stream) {
  if (heads < 1 || heads > 65535 || windows < 1 || n < 1 || n > kMaxN ||
      d < 1 || d > kMaxD || (mask != nullptr && (n_mask < 1 || windows % n_mask != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(windows, heads);
  window_attention_kernel<T><<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const float*)bias,
      (const float*)mask, (T*)o, windows, n, d, n_mask, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, bound with ctypes. Each call launches on `stream` and
// returns cudaGetLastError() (0 on success); `mask` may be NULL.
extern "C" int srbh_window_attention_f32(const void* q, const void* k, const void* v,
                                         const void* bias, const void* mask, void* o,
                                         int heads, int windows, int n, int d,
                                         int n_mask, float scale, void* stream) {
  return launch<float>(q, k, v, bias, mask, o, heads, windows, n, d, n_mask, scale, stream);
}

extern "C" int srbh_window_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* bias, const void* mask, void* o,
                                          int heads, int windows, int n, int d,
                                          int n_mask, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, mask, o, heads, windows, n, d, n_mask,
                               scale, stream);
}
