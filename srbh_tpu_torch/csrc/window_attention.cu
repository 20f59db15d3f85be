// Fused window attention for SwinIR on Hopper's tensor cores (sm_90a).
//
// Replaces both Pallas TPU kernels of srbh_tpu/ops/pallas/window_attention.py:
// _attn_kernel (:48, unshifted windows) and _attn_kernel_masked (:70, shifted
// windows, where window b adds the additive shift mask mask[b % nW]). One
// kernel takes an optional mask pointer and covers both:
//
//     o[h, b] = softmax(q[h, b] * d^-1/2 @ k[h, b]^T + bias[h] (+ mask[b % nW])) @ v[h, b]
//
// q, k and v are (heads, windows, N, d) views whose rows are contiguous (the
// caller passes each one's head, window and row strides, so the q, k and v
// slices of SwinIR's qkv projection come in without a copy); o is a
// contiguous (heads, windows, N, d). bias is (heads, N, N) f32 and mask is
// (nW, N, N) f32, both contiguous. N <= 64 and d <= 64. Inputs are f32 or
// bf16; scores, the softmax and the output sum are f32.
//
// What bounds it on this card. At SwinIR x4's shape (heads 6, 512 windows,
// N 64, d 30, f32) a call must read q, k and v once and write o once,
// 4 x 6 x 512 x 64 x 30 x 4 B = 94.4 MB, plus 0.1 MB of bias (1.1 MB with
// the mask): 0.0282 ms at 3.35 TB/s. Its 4 x h x B_ x N^2 x d = 1.51 GFLOP
// take 0.0225 ms even at the full 67 TFLOP/s of f32 FMAs outside the tensor
// cores, and an FMA whose two operands come from shared memory runs at a
// fraction of that, so a scalar design cannot approach the bytes bound. The
// design therefore moves both products onto the tensor cores and keeps
// memory busy while they run:
//
// - Each warp owns 16 query rows of a window (N is padded to 64, 4 warps)
//   and keeps that row block's 16 x 64 scores in registers as 8 m16n8
//   accumulator tiles. The row max and sum take two quad shuffles, and P
//   feeds P @ V from registers, never through shared memory.
// - f32 inputs use 3xTF32: each operand a splits into a_hi = tf32(a) and
//   a_lo = tf32(a - a_hi), and a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, three
//   mma.sync.m16n8k8.tf32 with f32 sums. That keeps f32 accuracy (1xTF32
//   keeps about three digits) for 3 x 1.61 GFLOP (d padded to 32) at up to
//   495 TFLOP/s, about 0.01 ms. For P @ V the k index t stands for key 2t
//   and t + 4 for key 2t + 1, so a thread's score accumulators are already
//   its A fragment; V's B fragment rows are read in the same order.
// - bf16 inputs use mma.sync.m16n8k16.bf16 with f32 sums (a bf16 product is
//   exact in f32, as in the Pallas kernel, which upcasts first); two score
//   tiles pack into one A fragment and V's B fragments come from
//   ldmatrix.trans.
// - A block takes one head and one mask index and walks that pair's windows
//   (8 at SwinIR x4's shape), as many blocks as the card holds at once. The
//   (bias + mask) * d^1/2 tile is read once per block into registers laid
//   out as the score accumulators, which start from it; scaling the finished
//   sums by d^-1/2 inside the exponent gives q.k * d^-1/2 + bias + mask.
// - Q, K and V move through a two-stage ring in shared memory: window j + 1
//   is staged with cp.async while window j computes. Copies are 16 bytes
//   where every row start is 16-byte aligned, else 8 or 4 (the wrapper picks
//   the width: the qkv projection's f32 rows start 8-byte aligned), and
//   plain loads only for 2-byte rows. Tiles have a row stride of 4 x an odd
//   number of words, so every fragment load is free of bank conflicts. Pad
//   columns (d up to the MMA depth) and pad rows (N up to 64) are zeroed once;
//   pad score columns start at -inf, and only the real rows and columns of o
//   are stored.
//
// What bounds it now (chip_smoke.py phase 3; numbers in PERF.md): at SwinIR
// x4's f32 shape, on the strided qkv views it is given there, the kernel
// takes about 2.4x its bytes bound. Its staging takes 8-byte copies through
// L1 (the views' 120-byte rows start 8-byte aligned, 2,160 bytes apart), its
// arithmetic is three TF32 products for each f32 one, and three blocks of 4
// warps an SM are few warps to overlap the two and to hide the two barriers
// per window.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // query and key rows of a tile: 4 warps x 16
constexpr int kMaxD = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTiles = kRows / 8;  // m16n8 score tiles per warp
constexpr int kStages = 2;  // ring of (Q, K, V) tiles: one computes, one loads

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const float* mask;  // nullptr: no shift mask
  void* o;
  long long sq[3], sk[3], sv[3];  // head, window and row strides, in elements
  int windows, n, d;
  int nw;  // mask windows nW (1 without a mask): window b uses mask[b % nw]
  int chunks, per_block;  // a (head, b % nw) pair's windows split into chunks
  int vec;  // bytes per staging copy: 16, 8 or 4 (cp.async), or 2 (plain loads)
  float scale;
};

// Row stride of a shared tile, in elements: 4 x an odd number of 32-bit words.
template <typename T, int DP>
__host__ __device__ constexpr int tile_stride() { return sizeof(T) == 4 ? DP + 4 : DP + 8; }

__device__ __forceinline__ void cp_async(void* dst, const void* src, int vec) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  if (vec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else if (vec == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  } else if (vec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  } else {
    *(__nv_bfloat16*)dst = *(const __nv_bfloat16*)src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Zeroes the pad of a shared tile: columns [d, DP) of every row, and rows
// [n, 64). A product then sees only zeros beyond the real data.
template <typename T, int DP>
__device__ __forceinline__ void zero_pad(T* tile, int n, int d) {
  constexpr int S = tile_stride<T, DP>();
  const int r = threadIdx.x;
  if (r < kRows) {
    for (int c = r < n ? d : 0; c < DP; ++c) tile[r * S + c] = T(0.f);
  }
}

// Issues the copies of rows [0, n) x columns [0, d) of one (head, window)
// tile into shared memory. A row is d * sizeof(T) / vec copies; a power of
// two of threads (`1 << shift`) serves each row, so no thread divides.
template <typename T, int DP>
__device__ __forceinline__ void stage(T* tile, const T* src, long long row_stride,
                                      int n, int d, int vec) {
  constexpr int S = tile_stride<T, DP>();
  const int per_row = d * (int)sizeof(T) / vec;
  const int shift = 32 - __clz(per_row - 1);
  const int c = threadIdx.x & ((1 << shift) - 1);
  if (c >= per_row) return;
  for (int r = threadIdx.x >> shift; r < n; r += kThreads >> shift) {
    cp_async(reinterpret_cast<char*>(tile + r * S) + c * vec,
             reinterpret_cast<const char*>(src + r * row_stride) + c * vec, vec);
  }
}

// 2^x in one MUFU instruction (2 ulp); results below 2^-126 flush to 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 for one k-step of T tiles: c[i] += a.b[i], with a = a_hi + a_lo and
// b[i] = b_hi + b_lo, as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi. Each pass runs
// over all tiles, so no product waits on the one before it.
template <int T>
__device__ __forceinline__ void mma_3xtf32(float (&c)[T][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const float (&b)[T][2]) {
  uint32_t bh[T][2], bl[T][2];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    split(b[i][0], bh[i][0], bl[i][0]);
    split(b[i][1], bh[i][1], bl[i][1]);
  }
#pragma unroll
  for (int i = 0; i < T; ++i) mma_tf32(c[i], al, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < T; ++i) mma_tf32(c[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < T; ++i) mma_tf32(c[i], ah, bh[i][0], bh[i][1]);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// S = Q K^T for this warp's 16 rows (r0 = its first row + g), 3xTF32.
template <int DP>
__device__ __forceinline__ void scores(const float* qs, const float* ks, int r0,
                                       int g, int t, float (&s)[kTiles][4]) {
  constexpr int S = tile_stride<float, DP>();
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const float* qa = qs + r0 * S + kk * 8 + t;
    uint32_t ah[4], al[4];
    split(qa[0], ah[0], al[0]);
    split(qa[8 * S], ah[1], al[1]);
    split(qa[4], ah[2], al[2]);
    split(qa[8 * S + 4], ah[3], al[3]);
    float b[kTiles][2];
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      const float* kb = ks + (nt * 8 + g) * S + kk * 8 + t;
      b[nt][0] = kb[0];
      b[nt][1] = kb[4];
    }
    mma_3xtf32(s, ah, al, b);
  }
}

// S = Q K^T for this warp's 16 rows, bf16 products summed in f32.
template <int DP>
__device__ __forceinline__ void scores(const __nv_bfloat16* qs, const __nv_bfloat16* ks,
                                       int r0, int g, int t, float (&s)[kTiles][4]) {
  constexpr int S = tile_stride<__nv_bfloat16, DP>();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* qa = qs + r0 * S + kk * 16 + 2 * t;
    const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * S), ld32(qa + 8), ld32(qa + 8 * S + 8)};
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      const __nv_bfloat16* kb = ks + (nt * 8 + g) * S + kk * 16 + 2 * t;
      mma_bf16(s[nt], a, ld32(kb), ld32(kb + 8));
    }
  }
}

// O += P V from the probabilities in registers, 3xTF32. The k index t of
// key block kk stands for key 8kk + 2t and t + 4 for key 8kk + 2t + 1, so
// the score tile's (row g, cols 2t, 2t+1) values are the A fragment as they
// lie.
template <int DP>
__device__ __forceinline__ void values(const float (&p)[kTiles][4], const float* vs,
                                       int g, int t, float (&o)[DP / 8][4]) {
  constexpr int S = tile_stride<float, DP>();
#pragma unroll
  for (int kk = 0; kk < kTiles; ++kk) {
    uint32_t ah[4], al[4];
    split(p[kk][0], ah[0], al[0]);
    split(p[kk][2], ah[1], al[1]);
    split(p[kk][1], ah[2], al[2]);
    split(p[kk][3], ah[3], al[3]);
    const float* vb = vs + (kk * 8 + 2 * t) * S + g;
    float b[DP / 8][2];
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      b[nd][0] = vb[nd * 8];
      b[nd][1] = vb[S + nd * 8];
    }
    mma_3xtf32(o, ah, al, b);
  }
}

// O += P V, bf16: score tiles 2kk and 2kk+1 pack into one m16n8k16 A
// fragment; ldmatrix.trans reads V's B fragments for two column tiles.
template <int DP>
__device__ __forceinline__ void values(const float (&p)[kTiles][4],
                                       const __nv_bfloat16* vs, int g, int t,
                                       float (&o)[DP / 8][4]) {
  constexpr int S = tile_stride<__nv_bfloat16, DP>();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < kTiles / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int nd = 0; nd < DP / 8; nd += 2) {
      const __nv_bfloat16* row = vs + (kk * 16 + (lane & 15)) * S + (nd + (lane >> 4)) * 8;
      const uint32_t addr = (uint32_t)__cvta_generic_to_shared(row);
      uint32_t b[4];
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                   : "r"(addr));
      mma_bf16(o[nd], a, b[0], b[1]);
      mma_bf16(o[nd + 1], a, b[2], b[3]);
    }
  }
}

// The score accumulators' starting values at (row r, columns c and c + 1):
// (bias + mask) * d^1/2, so that scaling the finished sum by d^-1/2 gives
// q.k * d^-1/2 + bias + mask. Columns beyond N start at -inf, rows beyond N
// at 0.
__device__ __forceinline__ void bias_pair(float& x0, float& x1, const float* bias,
                                          const float* mask, int r, int c, int n,
                                          float inv_scale) {
  float b0 = 0.f, b1 = 0.f, m0 = 0.f, m1 = 0.f;
  const int i = r * n + c;
  if ((n & 1) == 0) {
    if (r < n && c < n) {
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + i));
      b0 = bb.x;
      b1 = bb.y;
      if (mask) {
        const float2 mm = __ldg(reinterpret_cast<const float2*>(mask + i));
        m0 = mm.x;
        m1 = mm.y;
      }
    }
  } else if (r < n) {
    if (c < n) {
      b0 = __ldg(bias + i);
      if (mask) m0 = __ldg(mask + i);
    }
    if (c + 1 < n) {
      b1 = __ldg(bias + i + 1);
      if (mask) m1 = __ldg(mask + i + 1);
    }
  }
  x0 = c < n ? (b0 + m0) * inv_scale : -INFINITY;
  x1 = c + 1 < n ? (b1 + m1) * inv_scale : -INFINITY;
}

__device__ __forceinline__ void store2(float* o, int i, float x0, float x1, bool pair,
                                       bool second) {
  if (pair) {
    *reinterpret_cast<float2*>(o + i) = make_float2(x0, x1);
  } else {
    o[i] = x0;
    if (second) o[i + 1] = x1;
  }
}

__device__ __forceinline__ void store2(__nv_bfloat16* o, int i, float x0, float x1,
                                       bool pair, bool second) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(o + i) = __floats2bfloat162_rn(x0, x1);
  } else {
    o[i] = __float2bfloat16(x0);
    if (second) o[i + 1] = __float2bfloat16(x1);
  }
}

// DP: d padded to the MMA depth (8 for f32, 16 for bf16). Block x takes head
// h, mask index r and windows b = r + nw * (first + j), j < count: every
// window of the block shares bias[h] and mask[r], which stay in registers.
// A two-stage ring in shared memory loads window j + 1 while window j
// computes.
// Three blocks an SM: up to 168 registers a thread; 55 KB of shared memory a
// block for f32 at d <= 32.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 3)
window_attention_kernel(const Params p) {
  constexpr int S = tile_stride<T, DP>();
  constexpr int kTile = kRows * S;  // elements of one Q, K or V tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);  // stage i: Q, K, V at ring + 3 * kTile * i

  int x = blockIdx.x;
  const int chunk = x % p.chunks;
  x /= p.chunks;
  const int r = x % p.nw;
  const int h = x / p.nw;
  const int first = chunk * p.per_block;
  const int count = min(p.per_block, p.windows / p.nw - first);
  const int n = p.n, d = p.d;
  const T* q = static_cast<const T*>(p.q) + h * p.sq[0];
  const T* k = static_cast<const T*>(p.k) + h * p.sk[0];
  const T* v = static_cast<const T*>(p.v) + h * p.sv[0];

  for (int i = 0; i < 3 * kStages; ++i) zero_pad<T, DP>(ring + i * kTile, n, d);
  auto load = [&](int j) {
    const long long b = r + (long long)p.nw * (first + j);
    T* tile = ring + (j % kStages) * 3 * kTile;
    stage<T, DP>(tile, q + b * p.sq[1], p.sq[2], n, d, p.vec);
    stage<T, DP>(tile + kTile, k + b * p.sk[1], p.sk[2], n, d, p.vec);
    stage<T, DP>(tile + 2 * kTile, v + b * p.sv[1], p.sv[2], n, d, p.vec);
    cp_async_commit();
  };
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < count) load(j); else cp_async_commit();
  }

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16 + g;  // this thread's rows: r0, r0 + 8
  const int r1 = r0 + 8;

  float init[kTiles][4];
  {
    const float* bias = p.bias + (long long)h * n * n;
    const float* mask = p.mask ? p.mask + (long long)r * n * n : nullptr;
    const float inv_scale = 1.f / p.scale;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      bias_pair(init[nt][0], init[nt][1], bias, mask, r0, nt * 8 + 2 * t, n, inv_scale);
      bias_pair(init[nt][2], init[nt][3], bias, mask, r1, nt * 8 + 2 * t, n, inv_scale);
    }
  }
  const float scale_log2e = p.scale * 1.4426950408889634f;  // exp(x) = 2^(x log2 e)

  for (int j = 0; j < count; ++j) {
    if (j + kStages - 1 < count) load(j + kStages - 1); else cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* qs = ring + (j % kStages) * 3 * kTile;
    float s[kTiles][4];
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = init[nt][i];
    }
    scores<DP>(qs, qs + kTile, r0, g, t, s);

    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      m0 = fmaxf(m0, fmaxf(s[nt][0], s[nt][1]));
      m1 = fmaxf(m1, fmaxf(s[nt][2], s[nt][3]));
    }
    // the four threads of a quad hold one row's 64 columns
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kTiles; ++nt) {
      s[nt][0] = exp2_approx((s[nt][0] - m0) * scale_log2e);
      s[nt][1] = exp2_approx((s[nt][1] - m0) * scale_log2e);
      s[nt][2] = exp2_approx((s[nt][2] - m1) * scale_log2e);
      s[nt][3] = exp2_approx((s[nt][3] - m1) * scale_log2e);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0;
    const float inv1 = 1.f / l1;

    float o[DP / 8][4];
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
    values<DP>(s, qs + 2 * kTile, g, t, o);

    const long long b = r + (long long)p.nw * (first + j);
    T* out = static_cast<T*>(p.o) + ((long long)h * p.windows + b) * n * d;
    const bool even = (d & 1) == 0;
#pragma unroll
    for (int nd = 0; nd < DP / 8; ++nd) {
      const int c = nd * 8 + 2 * t;
      if (c < d) {
        if (r0 < n) store2(out, r0 * d + c, o[nd][0] * inv0, o[nd][1] * inv0, even, c + 1 < d);
        if (r1 < n) store2(out, r1 * d + c, o[nd][2] * inv1, o[nd][3] * inv1, even, c + 1 < d);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

// Launches one block per (head, mask index, chunk of windows), with as many
// chunks as keep the card's resident blocks busy in one wave.
template <typename T, int DP>
int launch_padded(Params p, int heads, cudaStream_t stream) {
  constexpr int smem = kStages * 3 * kRows * tile_stride<T, DP>() * (int)sizeof(T);
  auto kernel = window_attention_kernel<T, DP>;
  static int resident[64] = {};  // blocks the card holds at once, per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= 64) return e != cudaSuccess ? (int)e : (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
            cudaSuccess) {
      return (int)e;
    }
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = sms * per_sm;
  }
  const int groups = heads * p.nw;
  const int images = p.windows / p.nw;
  const int chunks = max(1, min(images, resident[dev] / groups));
  p.per_block = (images + chunks - 1) / chunks;
  p.chunks = (images + p.per_block - 1) / p.per_block;
  const long long blocks = (long long)groups * p.chunks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* mask, void* o, int heads, int windows, int n, int d,
           int n_mask, float scale, const long long* strides, int vec, void* stream) {
  const int elt = (int)sizeof(T);
  bool ok = heads >= 1 && windows >= 1 && n >= 1 && n <= kRows && d >= 1 && d <= kMaxD &&
            (mask == nullptr || (n_mask >= 1 && windows % n_mask == 0)) &&
            (vec == 2 || vec == 4 || vec == 8 || vec == 16) && vec >= elt &&
            (d * elt) % vec == 0;
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; ok && i < 3; ++i) ok = (uintptr_t)ptrs[i] % vec == 0;
  for (int i = 0; ok && i < 9; ++i) ok = strides[i] >= 0 && (strides[i] * elt) % vec == 0;
  // bias_pair reads float2 pairs when N is even
  const uintptr_t pair = (n & 1) == 0 ? 8 : 4;
  ok = ok && (uintptr_t)bias % pair == 0 && (uintptr_t)mask % pair == 0;
  if (!ok) return (int)cudaErrorInvalidValue;

  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = (const float*)bias;
  p.mask = (const float*)mask;
  p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
  }
  p.windows = windows;
  p.n = n;
  p.d = d;
  p.nw = mask ? n_mask : 1;
  p.vec = vec;
  p.scale = scale;
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (sizeof(T) == 4) {
    switch ((d + 7) / 8) {
      case 1: return launch_padded<T, 8>(p, heads, s);
      case 2: return launch_padded<T, 16>(p, heads, s);
      case 3: return launch_padded<T, 24>(p, heads, s);
      case 4: return launch_padded<T, 32>(p, heads, s);
      case 5: return launch_padded<T, 40>(p, heads, s);
      case 6: return launch_padded<T, 48>(p, heads, s);
      case 7: return launch_padded<T, 56>(p, heads, s);
      default: return launch_padded<T, 64>(p, heads, s);
    }
  } else {
    switch ((d + 15) / 16) {
      case 1: return launch_padded<T, 16>(p, heads, s);
      case 2: return launch_padded<T, 32>(p, heads, s);
      case 3: return launch_padded<T, 48>(p, heads, s);
      default: return launch_padded<T, 64>(p, heads, s);
    }
  }
}

}  // namespace

// Plain C interface, bound with ctypes. `strides` holds nine element strides:
// the head, window and row strides of q, then of k, then of v (each row's d
// elements are contiguous); `vec` is the bytes per staging copy, which every
// row start and row length must be a multiple of. Each call launches on
// `stream` and returns cudaGetLastError() (0 on success); `mask` may be NULL.
extern "C" int srbh_window_attention_f32(const void* q, const void* k, const void* v,
                                         const void* bias, const void* mask, void* o,
                                         int heads, int windows, int n, int d,
                                         int n_mask, float scale,
                                         const long long* strides, int vec, void* stream) {
  return launch<float>(q, k, v, bias, mask, o, heads, windows, n, d, n_mask, scale,
                       strides, vec, stream);
}

extern "C" int srbh_window_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* bias, const void* mask, void* o,
                                          int heads, int windows, int n, int d,
                                          int n_mask, float scale,
                                          const long long* strides, int vec, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, mask, o, heads, windows, n, d, n_mask,
                               scale, strides, vec, stream);
}
