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
// two FMAs; the output is 2*C floats.  A train step calls it 92 times, on
// 8 MB to 537 MB (B=32, C from 512 down to 16), so the design has to (a) keep
// enough bytes in flight per SM to run at the memory rate on the large inputs
// and (b) add as little fixed time per call as it can on the small ones.  (a)
// holds; what is left is (b): after its last load, a launch still spends a
// few microseconds on the epilogue, the cluster exchange, the ticket and the
// last block's fold, one after the other, and on the inputs under ~70 MB
// that is as much as the loads (PERF.md, section 6).
//
// - One launch per call.  Blocks run in no order, so nothing is accumulated
//   across blocks with float atomics: each block reduces its rows to one
//   partial row, takes a ticket from a device counter with one acquire-release
//   atomic, and the block that draws the last ticket folds the rows
//   in row order (threads along channels, float4 loads that coalesce) into
//   the (2, C) result and sets the counter back to 0 for the next call on the
//   stream.  The fold order does not depend on which block arrives last, so
//   the same input gives the same bits on every run.
// - Bulk path (16-byte aligned pointers, every operand's row a multiple of
//   16 bytes, G = C / VEC <= 256 vectors of the wider type a row; every
//   BatchNorm input of every bf16 model the port trains): persistent
//   blocks, one per SM (the ring takes 128-192 KB of shared memory), fewer
//   where the input is small (at least 64 KB per block), so the grid is one
//   wave.  A block takes a contiguous range of rows.  Thread 0 streams it
//   through a ring of 4 stages (3 for the two-input form) of 32 KB per
//   operand with 1-d bulk copies (cp.async.bulk, the TMA's linear form) that
//   complete on mbarriers: 96-128 KB in flight per SM with no registers
//   spent on it (16 KB stages, 48-64 KB in flight, left 12-18% of the byte
//   bound on the 268 MB inputs).  The first T' = G * floor(256 / G) threads
//   (the consumers: all 256 where G is a power of two; 255 for G = 3, 240
//   for G = 120, 160 for G = 160) read the stage from shared memory in
//   16-byte vectors, stepping by T'; a stage starts on a row and T' is a
//   multiple of G, so a consumer always sees the same channels ("index
//   modulo C") and keeps its sums in registers.  Where T' is 256 the loop
//   steps by that constant.
// - Epilogue: where G is a power of two below 32, lanes that hold the same
//   channels combine with __shfl_xor_sync first (holders g + 32 j); else
//   every consumer is a holder (g, g + G, ... below T': at most 85, for
//   G = 3).  The holders write their sums to shared memory and one
//   fixed-order pass over the holders of each channel writes the block's
//   row.  The blocks of a cluster fold their rows through distributed
//   shared memory (block r sums a slice of the columns over ranks 0..n-1)
//   into one partial row per cluster.  The cluster size (1, 2, 4 or 8,
//   chosen at launch) is the smallest that keeps what the last block reads
//   under 64 KB: the large inputs have few channels and use all 132 SMs
//   (clusters of 8 leave 4 idle), the 512-channel ones fold 8 rows at a
//   time so the last block reads 15-16 rows, not 128.  Above 512 channels no
//   cluster size does, so the plan runs fewer clusters of 8 (C=960: 8, 64
//   blocks; C=2048: 4); that is faster than the full grid (PERF.md, section 6).
//   The last block keeps 16 loads in flight a thread (fold_columns).
// - Generic path (what the bulk path cannot take: an unaligned pointer, a
//   row that is not a multiple of 16 bytes, G > 256, i.e. bf16 C > 2048 or
//   a float32 operand with C > 1024; no BatchNorm input of a bf16 model the
//   port trains takes it): threads along x take channels, threads along y
//   take rows, scalar loads, still coalesced; one partial row per block (at
//   least 128 rows a block) and the same last-block fold.
//
// The grid, the rows per block and the scratch size are planned by the
// caller (ops/channel_sums.py::plan); the entry point checks the plan against
// what the kernel needs.  The scratch is 4 words (the ticket counter, 0
// between calls) followed by the partial rows.
//
// C interface for ctypes; the entry points return cudaError_t codes.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CLUSTER = 8;          // blocks whose rows fold in shared memory
constexpr int STAGE_BYTES = 32768;      // of the wider operand, per ring stage
constexpr int RING_OFFSET = 128;        // the stages' mbarriers sit before the ring
constexpr int SCRATCH_HEAD = 4;         // words before the partial rows (counter + pad)
constexpr int GX = 32;                  // generic path: threads over channels
constexpr int GY = THREADS / GX;        // generic path: threads over rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename TA, typename TB, bool DUAL>
struct Bulk {
  static constexpr int WIDEST = sizeof(TA) > sizeof(TB) ? sizeof(TA) : sizeof(TB);
  static constexpr int VEC = 16 / WIDEST;         // elements of a 16-byte load of the wider type
  static constexpr int STAGES = DUAL ? 3 : 4;
  // a stage holds rows * C elements of each operand, rows * C * WIDEST <= STAGE_BYTES
  static constexpr int RING_BYTES =
      STAGES * STAGE_BYTES * (int)(sizeof(TA) + (DUAL ? sizeof(TB) : 0)) / WIDEST;
  static constexpr int SMEM = RING_OFFSET + RING_BYTES;
  static constexpr int RED = 2 * VEC + 1;         // floats per thread in the epilogue (padded)
  // the epilogue's buffers overlay the drained ring
  static_assert(4 * (THREADS * RED + 2 * THREADS * VEC) <= RING_BYTES, "epilogue overlay");
};

__device__ __forceinline__ void add4(float4& t, const float4& v) {
  t.x += v.x;
  t.y += v.y;
  t.z += v.z;
  t.w += v.w;
}

// Columns j, j + THREADS, ... (COLS of them; one at or past n4 reads column
// j again and is not written) of `rows` rows of n4 float4s, each summed in
// row order into out.  The loads of CHUNK rows of every column are issued
// before any of them is added, so a chunk costs one L2 round trip; a loop
// left to the compiler's unrolling runs the rows past its last whole
// unrolled trip (all of them, below 17 rows) as a remainder loop that waits
// for each load in turn.
template <int COLS, int CHUNK>
__device__ __forceinline__ void fold_columns(const float4* p4, int rows, int n4,
                                             float4* __restrict__ o4) {
  for (int j = threadIdx.x; j < n4; j += COLS * THREADS) {
    bool in[COLS];
    float4 t[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      in[c] = j + c * THREADS < n4;
      t[c] = __ldcg(p4 + (in[c] ? j + c * THREADS : j));
    }
    int r0 = 1;
    for (; r0 + CHUNK <= rows; r0 += CHUNK) {
      float4 v[COLS][CHUNK];
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          v[c][k] = __ldcg(p4 + (size_t)(r0 + k) * n4 + (in[c] ? j + c * THREADS : j));
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
#pragma unroll
        for (int c = 0; c < COLS; ++c) add4(t[c], v[c][k]);
    }
    if (r0 < rows) {
      float4 v[COLS][CHUNK];
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          if (r0 + k < rows)
            v[c][k] = __ldcg(p4 + (size_t)(r0 + k) * n4 + (in[c] ? j + c * THREADS : j));
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          if (r0 + k < rows) add4(t[c], v[c][k]);
    }
#pragma unroll
    for (int c = 0; c < COLS; ++c)
      if (in[c]) o4[j + c * THREADS] = t[c];
  }
}

// Every thread of every block calls this once its block's partial rows are
// written.  The block that draws the last ticket sums `rows` rows of n floats
// in row order into out (threads along the row, so the loads coalesce) and
// re-arms the counter.
__device__ void fold_last(const float* partials, int rows, int n, float* __restrict__ out,
                          unsigned* counter) {
  __shared__ bool last;
  __syncthreads();  // the block's rows are written
  if (threadIdx.x == 0) {
    // one atomic releases them (cumulative over the barrier) and acquires
    // every other block's: a block's ticket comes after its rows
    unsigned ticket;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(ticket) : "l"(counter) : "memory");
    last = ticket == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  if ((n & 3) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(partials);
    float4* o4 = reinterpret_cast<float4*>(out);
    // 16 loads in flight a thread: one column of 16 rows, or two of 8
    if ((n >> 2) > THREADS)
      fold_columns<2, 8>(p4, rows, n >> 2, o4);
    else
      fold_columns<1, 16>(p4, rows, n >> 2, o4);
  } else {
    for (int j = threadIdx.x; j < n; j += THREADS) {
      float t = __ldcg(partials + j);
#pragma unroll 8
      for (int r = 1; r < rows; ++r) t += __ldcg(partials + (size_t)r * n + j);
      out[j] = t;
    }
  }
  if (threadIdx.x == 0) *counter = 0u;  // the next launch on this stream starts from 0
}

// Consumers of the bulk kernel for G vectors a row: the most threads of the
// block that is a multiple of G (THREADS where G is a power of two).
__host__ __device__ constexpr int bulk_consumers(int G) { return G * (THREADS / G); }

// One consumer's share of a stage: vectors v = first, first + stride, ...
// below n_vec, added into its sums.  STRIDE is the stride where it is known
// when compiled (THREADS), 0 where it is `consumers`.
template <int STRIDE, typename TA, typename TB, bool DUAL, int VEC>
__device__ __forceinline__ void consume(const Pack<TA, VEC>* pa, const Pack<TB, VEC>* pb,
                                        int first, int n_vec, int consumers, float (&s)[VEC],
                                        float (&q)[VEC]) {
  const int stride = STRIDE > 0 ? STRIDE : consumers;
#pragma unroll 4
  for (int v = first; v < n_vec; v += stride) {
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
}

// a, b: (M, C); block i takes rows [i * rows_per_block, +rows_per_block).
// DUAL: sums of a and a*b; else sums of a and a*a (b unused).  Launched in
// clusters of 1, 2, 4 or 8 blocks; partials: (clusters, 2, C); out (2, C).
template <typename TA, typename TB, bool DUAL>
__global__ void __launch_bounds__(THREADS, 1)
channel_sums_bulk_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                         float* partials, float* __restrict__ out, unsigned* counter,
                         long long M, int C, long long rows_per_block) {
  using K = Bulk<TA, TB, DUAL>;
  constexpr int VEC = K::VEC;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + RING_OFFSET;

  const int tid = threadIdx.x;
  const int G = C / VEC;                               // vectors per row, 1..THREADS
  const int consumers = bulk_consumers(G);             // a multiple of G
  const int stage_rows = STAGE_BYTES / (C * K::WIDEST);
  const uint32_t a_row = C * sizeof(TA);
  const uint32_t b_row = DUAL ? C * sizeof(TB) : 0;
  const uint32_t slot_bytes = stage_rows * (a_row + b_row);
  const long long r0 = min(M, (long long)blockIdx.x * rows_per_block);
  const long long r1 = min(M, r0 + rows_per_block);
  const int n_stages = (int)((r1 - r0 + stage_rows - 1) / stage_rows);

  if (tid == 0) {
    for (int s = 0; s < K::STAGES; ++s) mbar_init(smem_u32(&bars[s]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 only: stage i -> slot i % STAGES
  auto issue = [&](int i) {
    const int slot = i % K::STAGES;
    const long long row = r0 + (long long)i * stage_rows;
    const uint32_t rows = (uint32_t)min((long long)stage_rows, r1 - row);
    const uint32_t dst = smem_u32(ring + slot * slot_bytes);
    const uint32_t bar = smem_u32(&bars[slot]);
    mbar_expect_tx(bar, rows * (a_row + b_row));
    bulk_load(dst, a + row * C, rows * a_row, bar);
    if (DUAL) bulk_load(dst + stage_rows * a_row, b + row * C, rows * b_row, bar);
  };
  if (tid == 0)
    for (int i = 0; i < K::STAGES && i < n_stages; ++i) issue(i);

  float s[VEC], q[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) s[k] = q[k] = 0.f;

  for (int i = 0; i < n_stages; ++i) {
    const int slot = i % K::STAGES;
    mbar_wait(smem_u32(&bars[slot]), (i / K::STAGES) & 1);
    const long long row = r0 + (long long)i * stage_rows;
    const int n_vec = (int)min((long long)stage_rows, r1 - row) * G;
    const unsigned char* base = ring + slot * slot_bytes;
    const Pack<TA, VEC>* pa = reinterpret_cast<const Pack<TA, VEC>*>(base);
    const Pack<TB, VEC>* pb = reinterpret_cast<const Pack<TB, VEC>*>(base + stage_rows * a_row);
    if (consumers == THREADS)
      consume<THREADS, TA, TB, DUAL>(pa, pb, tid, n_vec, consumers, s, q);
    else if (tid < consumers)
      consume<0, TA, TB, DUAL>(pa, pb, tid, n_vec, consumers, s, q);
    __syncthreads();  // every thread is done with this slot
    if (tid == 0 && i + K::STAGES < n_stages) {
      fence_proxy_async();
      issue(i + K::STAGES);
    }
  }

  // consumer t holds channels (t % G) * VEC .. + VEC.  Where G is a power of
  // two below 32, the lanes t, t + G, ... of a warp hold the same channels:
  // fold them by shuffles, after which lane l < G holds its warp's sums, and
  // the holders of channel group g are threads g + j * 32 (8 of them).
  // Otherwise every consumer is a holder: g + j * G below `consumers`.
  const bool shuffled = G < 32 && consumers == THREADS;
  if (shuffled) {
    for (int off = 16; off >= G; off >>= 1) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        s[k] += __shfl_xor_sync(0xffffffffu, s[k], off);
        q[k] += __shfl_xor_sync(0xffffffffu, q[k], off);
      }
    }
  }
  const int step = shuffled ? 32 : G;
  float* s_red = reinterpret_cast<float*>(ring);  // [THREADS][RED]
  float* s_part = s_red + THREADS * K::RED;       // [2][C]: this block's row
  cg::cluster_group cluster = cg::this_cluster();
  const int n = (int)cluster.num_blocks();
  float* prow = partials + (size_t)(blockIdx.x / n) * 2 * C;  // the cluster's row
  if (tid < consumers && tid % step < G) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      s_red[tid * K::RED + k] = s[k];
      s_red[tid * K::RED + VEC + k] = q[k];
    }
  }
  __syncthreads();
  for (int o = tid; o < 2 * C; o += THREADS) {
    const int m = o >= C;
    const int c = o - m * C;
    const int g = c / VEC;
    const int k = c - g * VEC;
    // the holders in order, 8 loads issued before they are added
    float t = 0.f;
    for (int th0 = g; th0 < consumers; th0 += 8 * step) {
      float v[8];
#pragma unroll
      for (int h = 0; h < 8; ++h)
        if (th0 + h * step < consumers) v[h] = s_red[(th0 + h * step) * K::RED + m * VEC + k];
#pragma unroll
      for (int h = 0; h < 8; ++h)
        if (th0 + h * step < consumers) t += v[h];
    }
    if (n == 1)
      prow[o] = t;
    else
      s_part[o] = t;
  }

  // the cluster's rows -> one partial row, block r folding columns
  // [r * THREADS, +THREADS) (+ multiples of n * THREADS) in rank order; the
  // n remote loads of a column are issued before they are added
  if (n > 1) {
    const int rank = (int)cluster.block_rank();
    cluster.sync();
    for (int o = rank * THREADS + tid; o < 2 * C; o += n * THREADS) {
      float v[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < n) v[r] = cluster.map_shared_rank(s_part, r)[o];
      float t = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < n) t += v[r];
      prow[o] = t;
    }
    cluster.sync();  // the peers are done reading this block's row
  }
  fold_last(partials, gridDim.x / n, 2 * C, out, counter);
}

// a, b: (M, C), any C, no alignment needed; partials (gridDim.x, 2, C).
template <typename TA, typename TB, bool DUAL>
__global__ void __launch_bounds__(THREADS)
channel_sums_generic_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
                            float* partials, float* __restrict__ out, unsigned* counter,
                            long long M, int C, long long rows_per_block) {
  __shared__ float sm[2][GY][GX];
  const int tx = threadIdx.x % GX;
  const int ty = threadIdx.x / GX;
  const long long r0 = min(M, (long long)blockIdx.x * rows_per_block);
  const long long r1 = min(M, r0 + rows_per_block);
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
  fold_last(partials, gridDim.x, 2 * C, out, counter);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the launch configuration of the bulk kernel: `blocks` in clusters of `cluster`
struct BulkLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  BulkLaunch(int blocks, int cluster, int smem, cudaStream_t stream) {
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Clusters of `cluster` blocks of the bulk kernel that run at once on the
// current device (one block per SM, as the shared memory allows); negative: a
// CUDA error code.  Also sets the kernel's shared memory limit on this
// device, which every launch needs.
template <typename TA, typename TB, bool DUAL>
int max_clusters(int cluster) {
  using K = Bulk<TA, TB, DUAL>;
  const void* fn = reinterpret_cast<const void*>(&channel_sums_bulk_kernel<TA, TB, DUAL>);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (err != cudaSuccess) return -(int)err;
  BulkLaunch launch(cluster * 32, cluster, K::SMEM, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &launch.cfg);
  return err == cudaSuccess ? n : -(int)err;
}

template <typename TA, typename TB, bool DUAL>
cudaError_t run(const void* a, const void* b, float* scratch, float* out, long long M, int C,
                int blocks, long long rows_per_block, int cluster, cudaStream_t stream) {
  using K = Bulk<TA, TB, DUAL>;
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  unsigned* counter = reinterpret_cast<unsigned*>(scratch);
  float* partials = scratch + SCRATCH_HEAD;
  if (blocks < 1 || rows_per_block < 1 || rows_per_block * blocks < M) return cudaErrorInvalidValue;
  if (cluster > 0) {
    // every operand's row a whole number of 16-byte vectors, G of them of
    // the wider type, 1..THREADS: then the consumers, bulk_consumers(G),
    // are a multiple of G and at most THREADS
    const int G = C / K::VEC;
    const bool fits = cluster <= MAX_CLUSTER && (cluster & (cluster - 1)) == 0 &&
                      blocks % cluster == 0 && (C * sizeof(TA)) % 16 == 0 &&
                      (!DUAL || (C * sizeof(TB)) % 16 == 0) && G >= 1 && G <= THREADS &&
                      aligned16(a) && (!DUAL || aligned16(b));
    if (!fits) return cudaErrorInvalidValue;
    BulkLaunch launch(blocks, cluster, K::SMEM, stream);
    const cudaError_t err = cudaLaunchKernelEx(&launch.cfg, channel_sums_bulk_kernel<TA, TB, DUAL>,
                                               pa, pb, partials, out, counter, M, C,
                                               rows_per_block);
    if (err != cudaSuccess) return err;
  } else {
    channel_sums_generic_kernel<TA, TB, DUAL><<<blocks, THREADS, 0, stream>>>(
        pa, pb, partials, out, counter, M, C, rows_per_block);
  }
  return cudaGetLastError();
}

template <typename A, typename B, bool D>
struct Types {
  using TA = A;
  using TB = B;
  static constexpr bool DUAL = D;
};

// b_kind: -1 no second operand, 0 float32, 1 bfloat16
template <typename Fn>
int dispatch(int a_bf16, int b_kind, Fn fn) {
  using bf16 = __nv_bfloat16;
  if (b_kind < 0) return a_bf16 ? fn(Types<bf16, bf16, false>{}) : fn(Types<float, float, false>{});
  if (a_bf16) return b_kind ? fn(Types<bf16, bf16, true>{}) : fn(Types<bf16, float, true>{});
  return b_kind ? fn(Types<float, bf16, true>{}) : fn(Types<float, float, true>{});
}

}  // namespace

extern "C" {

// Clusters of `cluster` blocks (1, 2, 4 or 8) of the bulk kernel for these
// operand types that run at once on the current device (see max_clusters);
// negative: a CUDA error code.
int channel_sums_max_clusters(int a_bf16, int b_kind, int cluster) {
  return dispatch(a_bf16, b_kind, [&](auto t) {
    using T = decltype(t);
    return max_clusters<typename T::TA, typename T::TB, T::DUAL>(cluster);
  });
}

// a (M, C) contiguous; b null for (sum a, sum a*a), else (M, C) for
// (sum a, sum a*b).  a_bf16 / b_bf16: 0 -> float32, 1 -> bfloat16.
// scratch: f32, 4 words (the counter, 0 before the first call) + the partial
// rows, private to `stream`; out (2, C) f32.  blocks / rows_per_block /
// cluster as planned by the caller: cluster 0 takes the generic kernel, 1-8
// the bulk kernel in clusters of that many blocks; M >= 1, C >= 1.
int channel_sums_launch(const void* a, const void* b, void* scratch, void* out, int a_bf16,
                        int b_bf16, long long M, int C, int blocks, long long rows_per_block,
                        int cluster, void* stream) {
  return dispatch(a_bf16, b == nullptr ? -1 : b_bf16, [&](auto t) {
    using T = decltype(t);
    return (int)run<typename T::TA, typename T::TB, T::DUAL>(
        a, b, static_cast<float*>(scratch), static_cast<float*>(out), M, C, blocks,
        rows_per_block, cluster, static_cast<cudaStream_t>(stream));
  });
}

}  // extern "C"
