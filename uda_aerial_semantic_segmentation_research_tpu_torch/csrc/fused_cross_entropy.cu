// Mean softmax cross-entropy over channel-last logits (N, C) with integer
// labels (N), forward and backward.
//
// Replaces: uda_aerial_semantic_segmentation_research_tpu/ops/pallas_ops.py
//           ::fused_cross_entropy (Pallas kernels _ce_fwd_kernel and
//           _ce_bwd_kernel, custom VJP).
//
//   forward:  loss = (1/N) * sum_i ( logsumexp(x_i) - x_i[label_i] )
//   backward: dx_i = (softmax(x_i) - onehot(label_i)) * (g / N), in x's type
//
// A label outside [0, C) has an all-zero one-hot, as in the TPU kernel: the
// pixel adds its logsumexp to the sum and gets the plain softmax as gradient.
//
// What bounds it on an H100: the bytes.  The forward reads the logits and the
// labels once and writes one float; the backward reads them once and writes
// the gradient once.  Neither the per-pixel loss nor an f32 softmax ever
// reaches device memory.  The TPU kernel wanted (C, N) logits and paid a
// transpose and a pad to 4096 columns; here the rows are read as they lie.
// A row of C=23 floats is 92 bytes, so "one thread per row" straight from
// device memory would scatter every warp load over 23 lines; instead a block
// copies a tile of 128 rows into shared memory with consecutive threads on
// consecutive elements, and then each thread walks its own row there (row
// stride C|1 words, odd, so the 32 rows of a warp fall into 32 banks).  The
// backward overwrites the tile with the gradient and stores it the same way.
// The sum over N is taken in two fixed-order stages (a grid of at most 2112
// blocks striding over the tiles, then one block folding the partials): no
// float atomics, the same bits on every run.
//
// C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;             // rows per tile = threads per block
constexpr int MAX_BLOCKS = 132 * 16;  // partial sums of the forward
constexpr int FOLD_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// tile[r * (C|1) + c] = logits[(row0 + r) * C + c] for the tile's rows
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ logits, float* tile,
                                          long long row0, int rows, int C) {
  const int CP = C | 1;
  const T* src = logits + row0 * C;
  for (int k = threadIdx.x; k < rows * C; k += ROWS) {
    const int r = k / C;
    const int c = k - r * C;
    tile[r * CP + c] = to_f32(src[k]);
  }
}

template <typename T, typename L>
__global__ void __launch_bounds__(ROWS)
ce_fwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
              float* __restrict__ partials, long long N, int C) {
  extern __shared__ float tile[];  // ROWS * (C|1)
  __shared__ float wsum[ROWS / 32];
  const int CP = C | 1;
  const long long ntiles = (N + ROWS - 1) / ROWS;
  float acc = 0.f;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long row0 = t * ROWS;
    const int rows = N - row0 < ROWS ? (int)(N - row0) : ROWS;
    load_tile(logits, tile, row0, rows, C);
    __syncthreads();
    if ((int)threadIdx.x < rows) {
      const float* x = tile + threadIdx.x * CP;
      float m = x[0];
      for (int c = 1; c < C; ++c) m = fmaxf(m, x[c]);
      float s = 0.f;
      for (int c = 0; c < C; ++c) s += expf(x[c] - m);
      const long long lab = (long long)labels[row0 + threadIdx.x];
      const float picked = (lab >= 0 && lab < C) ? x[lab] : 0.f;
      acc += logf(s) + m - picked;
    }
    __syncthreads();
  }
  // fixed-order block sum: butterfly inside each warp, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (threadIdx.x % 32 == 0) wsum[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < ROWS / 32; ++w) total += wsum[w];
    partials[blockIdx.x] = total;
  }
}

// out[0] = (sum of partials) / N; one block, strided sums then a tree.
__global__ void __launch_bounds__(FOLD_THREADS)
ce_fold_kernel(const float* __restrict__ partials, float* __restrict__ out,
               int num_partials, long long N) {
  __shared__ float s[FOLD_THREADS];
  float t = 0.f;
  for (int i = threadIdx.x; i < num_partials; i += FOLD_THREADS) t += partials[i];
  s[threadIdx.x] = t;
  __syncthreads();
  for (int k = FOLD_THREADS / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) s[threadIdx.x] += s[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)((double)s[0] / (double)N);
}

template <typename T, typename L>
__global__ void __launch_bounds__(ROWS)
ce_bwd_kernel(const T* __restrict__ logits, const L* __restrict__ labels,
              const float* __restrict__ g, T* __restrict__ dx, long long N, int C,
              float inv_n) {
  extern __shared__ float tile[];  // ROWS * (C|1)
  const int CP = C | 1;
  const long long ntiles = (N + ROWS - 1) / ROWS;
  const float coef = g[0] * inv_n;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long row0 = t * ROWS;
    const int rows = N - row0 < ROWS ? (int)(N - row0) : ROWS;
    load_tile(logits, tile, row0, rows, C);
    __syncthreads();
    if ((int)threadIdx.x < rows) {
      float* x = tile + threadIdx.x * CP;
      float m = x[0];
      for (int c = 1; c < C; ++c) m = fmaxf(m, x[c]);
      float s = 0.f;
      for (int c = 0; c < C; ++c) {
        const float e = expf(x[c] - m);
        x[c] = e;
        s += e;
      }
      const long long lab = (long long)labels[row0 + threadIdx.x];
      for (int c = 0; c < C; ++c) {
        const float onehot = (long long)c == lab ? 1.f : 0.f;
        x[c] = (x[c] / s - onehot) * coef;
      }
    }
    __syncthreads();
    T* dst = dx + row0 * C;
    for (int k = threadIdx.x; k < rows * C; k += ROWS) {
      const int r = k / C;
      const int c = k - r * C;
      dst[k] = from_f32<T>(tile[r * CP + c]);
    }
    __syncthreads();
  }
}

unsigned grid_for(long long N) {
  const long long ntiles = (N + ROWS - 1) / ROWS;
  return (unsigned)(ntiles < MAX_BLOCKS ? ntiles : MAX_BLOCKS);
}

template <typename T, typename L>
cudaError_t forward(const void* logits, const void* labels, float* partials, float* out,
                    long long N, int C, cudaStream_t stream) {
  const unsigned nb = grid_for(N);
  const size_t smem = sizeof(float) * ROWS * (C | 1);
  ce_fwd_kernel<T, L><<<nb, ROWS, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<const L*>(labels), partials, N, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_fold_kernel<<<1, FOLD_THREADS, 0, stream>>>(partials, out, (int)nb, N);
  return cudaGetLastError();
}

template <typename T, typename L>
cudaError_t backward(const void* logits, const void* labels, const float* g, void* dx,
                     long long N, int C, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ROWS * (C | 1);
  ce_bwd_kernel<T, L><<<grid_for(N), ROWS, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<const L*>(labels), g,
      static_cast<T*>(dx), N, C, (float)(1.0 / (double)N));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Length of the forward's scratch buffer of partial sums (f32).
int fused_cross_entropy_max_blocks() { return MAX_BLOCKS; }

// logits (N, C) contiguous, is_bf16: 0 -> float32, 1 -> bfloat16.
// labels (N), label_kind: 0 -> uint8, 1 -> int32, 2 -> int64.
// partials: fused_cross_entropy_max_blocks() f32 scratch; out: 1 f32.
// Shapes are checked by the caller: N >= 1, 1 <= C <= 64.
int fused_cross_entropy_forward(const void* logits, const void* labels, void* partials,
                                void* out, int is_bf16, int label_kind, long long N, int C,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partials);
  float* po = static_cast<float*>(out);
  using bf16 = __nv_bfloat16;
  if (is_bf16) {
    if (label_kind == 1) return (int)forward<bf16, int>(logits, labels, pp, po, N, C, s);
    if (label_kind == 2) return (int)forward<bf16, long long>(logits, labels, pp, po, N, C, s);
    return (int)forward<bf16, uint8_t>(logits, labels, pp, po, N, C, s);
  }
  if (label_kind == 1) return (int)forward<float, int>(logits, labels, pp, po, N, C, s);
  if (label_kind == 2) return (int)forward<float, long long>(logits, labels, pp, po, N, C, s);
  return (int)forward<float, uint8_t>(logits, labels, pp, po, N, C, s);
}

// g: 1 f32 on the device (the loss's cotangent); dx (N, C) of the logits' type.
int fused_cross_entropy_backward(const void* logits, const void* labels, const void* g,
                                 void* dx, int is_bf16, int label_kind, long long N, int C,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pg = static_cast<const float*>(g);
  using bf16 = __nv_bfloat16;
  if (is_bf16) {
    if (label_kind == 1) return (int)backward<bf16, int>(logits, labels, pg, dx, N, C, s);
    if (label_kind == 2) return (int)backward<bf16, long long>(logits, labels, pg, dx, N, C, s);
    return (int)backward<bf16, uint8_t>(logits, labels, pg, dx, N, C, s);
  }
  if (label_kind == 1) return (int)backward<float, int>(logits, labels, pg, dx, N, C, s);
  if (label_kind == 2) return (int)backward<float, long long>(logits, labels, pg, dx, N, C, s);
  return (int)backward<float, uint8_t>(logits, labels, pg, dx, N, C, s);
}

}  // extern "C"
