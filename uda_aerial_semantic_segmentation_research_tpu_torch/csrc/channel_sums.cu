// Per-channel f32 sums over the rows of a channel-last (M, C) activation:
//   channel_sums:       (sum x,  sum x*x)    -- BatchNorm forward statistics
//   channel_dual_sums:  (sum dy, sum dy*x)   -- BatchNorm backward sums
//
// Replaces: uda_aerial_semantic_segmentation_research_tpu/ops/pallas_moments.py
//           ::lane_sums and ::lane_dual_sums (Pallas kernels _sums_kernel and
//           _dual_kernel) together with the lane -> channel fold of
//           ops/lane_bn.py::_fold.
//
// What bounds it on an H100: the bytes.  Every element is read once and takes
// two FMAs; the output is 2*C floats.  The design therefore only has to keep
// the loads wide and coalesced and the result reproducible:
//
// - The TPU kernel sums a flat (M, 128) lane view across its sequential grid
//   and needs C | 128 or 128 | C.  Here any C and any row count are taken.
// - Vector path (C a multiple of the 16-byte vector width and the row's
//   vector count a divisor of the block size): a thread reads 16-byte vectors
//   at a stride of one block, so a warp reads 512 consecutive bytes, and --
//   because the block size is a multiple of the vectors per row -- a thread
//   always sees the same channels and keeps its sums in registers.  This is
//   the element -> channel map "index modulo C", also for C=16 in 2-byte
//   elements (two threads per row).
// - Generic path (any other C, or an unaligned pointer): threads along x take
//   channels, threads along y take rows; scalar loads, still coalesced.
// - Blocks run in no order, so nothing is accumulated across blocks with
//   atomics.  Each block reduces its threads in a fixed order and writes one
//   row of partial sums; a second kernel folds the rows in a fixed order.
//   The same input gives the same bits on every run.
//
// C interface for ctypes; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 8;   // rows of the partials scratch buffer
constexpr int VECS_PER_THREAD = 4;    // least work per thread before more blocks
constexpr int FOLD_THREADS = 256;
constexpr int GX = 32;                // generic path: threads over channels
constexpr int GY = THREADS / GX;      // generic path: threads over rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// a, b: (n_vec * VEC) elements; partials (gridDim.x, 2, C).
// DUAL: sums of a and a*b; else sums of a and a*a (b unused).
template <typename TA, typename TB, int VEC, bool DUAL>
__global__ void __launch_bounds__(THREADS)
sums_vec_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                float* __restrict__ partials, long long n_vec, long long chunk, int C) {
  __shared__ float sm[THREADS][2 * VEC + 1];
  const int G = C / VEC;  // vectors per row; THREADS % G == 0, chunk % THREADS == 0
  const long long begin = (long long)blockIdx.x * chunk;
  const long long end = begin + chunk < n_vec ? begin + chunk : n_vec;
  const Pack<TA, VEC>* pa = reinterpret_cast<const Pack<TA, VEC>*>(a);
  const Pack<TB, VEC>* pb = reinterpret_cast<const Pack<TB, VEC>*>(b);

  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.f;

#pragma unroll 4
  for (long long v = begin + threadIdx.x; v < end; v += THREADS) {
    const Pack<TA, VEC> va = pa[v];
    Pack<TB, VEC> vb;
    if (DUAL) vb = pb[v];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float fa = to_f32(va.v[k]);
      const float fb = DUAL ? to_f32(vb.v[k]) : fa;
      s[k] += fa;
      q[k] += fa * fb;
    }
  }

#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    sm[threadIdx.x][k] = s[k];
    sm[threadIdx.x][VEC + k] = q[k];
  }
  __syncthreads();
  // thread t holds channels (t % G) * VEC .. + VEC; sum the THREADS / G
  // threads of each channel in thread order
  for (int o = threadIdx.x; o < 2 * C; o += THREADS) {
    const int m = o / C;
    const int c = o - m * C;
    const int g = c / VEC;
    const int k = c - g * VEC;
    float t = 0.f;
    for (int th = g; th < THREADS; th += G) t += sm[th][m * VEC + k];
    partials[(size_t)blockIdx.x * 2 * C + o] = t;
  }
}

// a, b: (M, C); partials (gridDim.x, 2, C).  Any C, no alignment needed.
template <typename TA, typename TB, bool DUAL>
__global__ void __launch_bounds__(THREADS)
sums_generic_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                    float* __restrict__ partials, long long M, long long rows_per_block,
                    int C) {
  __shared__ float sm[2][GY][GX];
  const int tx = threadIdx.x % GX;
  const int ty = threadIdx.x / GX;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < M ? r0 + rows_per_block : M;
  for (int c0 = 0; c0 < C; c0 += GX) {
    const int c = c0 + tx;
    float s = 0.f, q = 0.f;
    if (c < C) {
      for (long long r = r0 + ty; r < r1; r += GY) {
        const float fa = to_f32(a[r * C + c]);
        const float fb = DUAL ? to_f32(b[r * C + c]) : fa;
        s += fa;
        q += fa * fb;
      }
    }
    sm[0][ty][tx] = s;
    sm[1][ty][tx] = q;
    __syncthreads();
    if (ty < 2 && c < C) {
      float t = 0.f;
      for (int y = 0; y < GY; ++y) t += sm[ty][y][tx];
      partials[(size_t)blockIdx.x * 2 * C + (size_t)ty * C + c] = t;
    }
    __syncthreads();
  }
}

// out[j] = sum over blocks of partials[blk][j], j < n; one block per j,
// fixed-order strided sums then a tree: the same bits on every run.
__global__ void __launch_bounds__(FOLD_THREADS)
fold_kernel(const float* __restrict__ partials, float* __restrict__ out,
            int num_blocks, int n) {
  __shared__ float s[FOLD_THREADS];
  const int j = blockIdx.x;
  float t = 0.f;
  for (int i = threadIdx.x; i < num_blocks; i += FOLD_THREADS)
    t += partials[(size_t)i * n + j];
  s[threadIdx.x] = t;
  __syncthreads();
  for (int k = FOLD_THREADS / 2; k > 0; k >>= 1) {
    if (threadIdx.x < k) s[threadIdx.x] += s[threadIdx.x + k];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[j] = s[0];
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename TA, typename TB, bool DUAL>
cudaError_t run(const void* a, const void* b, float* partials, float* out,
                long long M, int C, cudaStream_t stream) {
  constexpr int WIDEST = sizeof(TA) > sizeof(TB) ? sizeof(TA) : sizeof(TB);
  constexpr int VEC = 16 / WIDEST;
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  const int G = C / VEC;
  const bool vec = C % VEC == 0 && G <= THREADS && THREADS % G == 0 &&
                   aligned(a, sizeof(TA) * VEC) && (!DUAL || aligned(b, sizeof(TB) * VEC));
  long long nb;
  if (vec) {
    const long long n_vec = M * C / VEC;
    const long long per_block = (long long)THREADS * VECS_PER_THREAD;
    nb = (n_vec + per_block - 1) / per_block;
    if (nb > MAX_BLOCKS) nb = MAX_BLOCKS;
    long long chunk = (n_vec + nb - 1) / nb;
    chunk = (chunk + THREADS - 1) / THREADS * THREADS;
    nb = (n_vec + chunk - 1) / chunk;
    sums_vec_kernel<TA, TB, VEC, DUAL><<<(unsigned)nb, THREADS, 0, stream>>>(
        pa, pb, partials, n_vec, chunk, C);
  } else {
    long long rows = (M + MAX_BLOCKS - 1) / MAX_BLOCKS;
    if (rows < GY) rows = GY;
    nb = (M + rows - 1) / rows;
    sums_generic_kernel<TA, TB, DUAL><<<(unsigned)nb, THREADS, 0, stream>>>(
        pa, pb, partials, M, rows, C);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fold_kernel<<<2 * C, FOLD_THREADS, 0, stream>>>(partials, out, (int)nb, 2 * C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of the scratch buffer the caller allocates: (rows, 2, C) f32.
int channel_sums_max_blocks() { return MAX_BLOCKS; }

// a (M, C) contiguous; b null for (sum a, sum a*a), else (M, C) for
// (sum a, sum a*b).  a_bf16 / b_bf16: 0 -> float32, 1 -> bfloat16.
// partials: (channel_sums_max_blocks(), 2, C) f32 scratch; out (2, C) f32.
// Shapes are checked by the caller: M >= 1, C >= 1.
int channel_sums_launch(const void* a, const void* b, void* partials, void* out,
                        int a_bf16, int b_bf16, long long M, int C, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pp = static_cast<float*>(partials);
  float* po = static_cast<float*>(out);
  using bf16 = __nv_bfloat16;
  if (b == nullptr) {
    if (a_bf16) return (int)run<bf16, bf16, false>(a, nullptr, pp, po, M, C, s);
    return (int)run<float, float, false>(a, nullptr, pp, po, M, C, s);
  }
  if (a_bf16 && b_bf16) return (int)run<bf16, bf16, true>(a, b, pp, po, M, C, s);
  if (a_bf16) return (int)run<bf16, float, true>(a, b, pp, po, M, C, s);
  if (b_bf16) return (int)run<float, bf16, true>(a, b, pp, po, M, C, s);
  return (int)run<float, float, true>(a, b, pp, po, M, C, s);
}

}  // extern "C"
