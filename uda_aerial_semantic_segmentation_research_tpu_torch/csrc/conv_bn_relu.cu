// Fused [BN-affine + ReLU ->] conv3x3 (SAME) [-> per-channel output moments]
// for NHWC activations with few channels (<= 32 in, <= 32 out).
//
// Replaces: uda_aerial_semantic_segmentation_research_tpu/ops/pallas_conv.py
//           ::packed_conv_bn_relu (Pallas kernel _conv_kernel), the serving
//           path's BN1 -> ReLU -> conv2 chain of the two low-channel U-Net
//           decoder blocks (models/unet.py:187-202).
//
// Computes   y = conv3x3_SAME(a),   a = relu(scale * x + shift)  (or a = x)
// with the activation rounded to the input type before the product, as the
// Pallas kernel does, f32 accumulation, and the zero pad ring applied AFTER
// the ReLU (pad pixels read as exact zeros).  Optional moments are the
// per-channel (sum y, sum y^2) of the f32 accumulator over (B, H, W).
//
// What bounds it on an H100: the bytes.  At the slice's shapes (B=32,
// 512x512x16 -> 16 and 256x256x32 -> 32, bf16) the activation is read once
// and written once (2 x 268 MB -> ~0.16 ms at 3.35 TB/s) against 38.7 GFLOP
// (~0.04 ms on the bf16 tensor cores).  The design keeps the BN/ReLU pass out
// of device memory: the prologue runs on the tile in shared memory, so the
// activation makes one round trip instead of three.  This first version
// multiplies on the f32 CUDA cores (one output pixel per thread, all output
// channels in registers, weights broadcast from shared memory), so it is
// bound by the FMA rate until a wgmma/TMA version replaces the inner loop.
//
// Layout: one thread block per (image, 8-row x 32-column output tile).  The
// block loads its (8+2) x (32+2) input tile with halo into shared memory in
// channel-major order (conflict-free reads along the warp's 32 columns),
// applying the prologue to in-image pixels only.  Blocks run in no order, so
// moments are per-block partial sums (fixed-order reduction inside the block)
// folded by a second small kernel in a fixed order: deterministic.
//
// C interface for ctypes; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TH = 8;             // output rows per block
constexpr int TW = 32;            // output columns per block (one warp wide)
constexpr int IH = TH + 2;        // input tile rows with halo
constexpr int IW = TW + 2;        // input tile columns with halo
constexpr int THREADS = TH * TW;  // one output pixel per thread
constexpr int WARPS = THREADS / 32;
constexpr int FOLD_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// x (B,H,W,cin) T, w (3,3,cin,cout) f32 HWIO, scale/shift (cin) f32,
// y (B,H,W,cout) T, partials (num_blocks, 2, cout) f32.
// CO is cout rounded up to 16 or 32 (extra channels are zero weights).
template <typename T, int CO, bool AFFINE, bool MOMENTS>
__global__ void __launch_bounds__(THREADS)
conv_bn_relu_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    T* __restrict__ y, float* __restrict__ partials,
                    int H, int W, int cin, int cout) {
  extern __shared__ float smem[];
  float* s_in = smem;                   // [cin][IH][IW]
  float* s_w = smem + cin * IH * IW;    // [9][cin][CO]
  __shared__ float s_mom[WARPS][2][CO];

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH;
  const int ox0 = blockIdx.x * TW;
  const int tid = threadIdx.x;

  for (int i = tid; i < 9 * cin * CO; i += THREADS) {
    const int co = i % CO;
    const int tap_ci = i / CO;
    s_w[i] = co < cout ? w[tap_ci * cout + co] : 0.f;
  }

  // input tile + halo; channel-fastest global reads (coalesced)
  const T* xb = x + (size_t)b * H * W * cin;
  const int n_in = IH * IW * cin;
  for (int i = tid; i < n_in; i += THREADS) {
    const int c = i % cin;
    const int pix = i / cin;
    const int col = pix % IW;
    const int row = pix / IW;
    const int gy = oy0 - 1 + row;
    const int gx = ox0 - 1 + col;
    float v = 0.f;  // pad ring: exact zero after the ReLU
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = to_f32(xb[((size_t)gy * W + gx) * cin + c]);
      if (AFFINE) v = to_f32(from_f32<T>(fmaxf(v * scale[c] + shift[c], 0.f)));
    }
    s_in[(c * IH + row) * IW + col] = v;
  }
  __syncthreads();

  const int ty = tid / TW;
  const int tx = tid % TW;
  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;

  for (int ci = 0; ci < cin; ++ci) {
    const float* sp = s_in + (ci * IH + ty) * IW + tx;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float a = sp[ky * IW + kx];
        const float* wp = s_w + ((ky * 3 + kx) * cin + ci) * CO;
#pragma unroll
        for (int co = 0; co < CO; ++co) acc[co] = fmaf(a, wp[co], acc[co]);
      }
    }
  }

  const int oy = oy0 + ty;
  const int ox = ox0 + tx;
  const bool inside = oy < H && ox < W;
  if (inside) {
    T* yp = y + (((size_t)b * H + oy) * W + ox) * cout;
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      if (co < cout) yp[co] = from_f32<T>(acc[co]);
    }
  }

  if (MOMENTS) {
    const int lane = tid % 32;
    const int warp = tid / 32;
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      float s = inside ? acc[co] : 0.f;
      float q = s * s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
        q += __shfl_xor_sync(0xffffffffu, q, off);
      }
      if (lane == 0) {
        s_mom[warp][0][co] = s;
        s_mom[warp][1][co] = q;
      }
    }
    __syncthreads();
    if (tid < 2 * cout) {
      const int m = tid / cout;
      const int co = tid % cout;
      float t = 0.f;
      for (int wi = 0; wi < WARPS; ++wi) t += s_mom[wi][m][co];
      const size_t blk =
          ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      partials[blk * 2 * cout + tid] = t;
    }
  }
}

// out[j] = sum over blocks of partials[blk][j], j < n; one block per j,
// fixed-order strided sums then a tree: the same bits on every run.
__global__ void __launch_bounds__(FOLD_THREADS)
fold_moments_kernel(const float* __restrict__ partials, float* __restrict__ out,
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

template <typename T, int CO, bool AFFINE, bool MOMENTS>
cudaError_t launch(const void* x, const float* w, const float* scale,
                   const float* shift, void* y, float* partials, int B, int H,
                   int W, int cin, int cout, cudaStream_t stream) {
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  const size_t smem = sizeof(float) * ((size_t)cin * IH * IW + (size_t)9 * cin * CO);
  auto kernel = conv_bn_relu_kernel<T, CO, AFFINE, MOMENTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), w, scale, shift, static_cast<T*>(y), partials,
      H, W, cin, cout);
  return cudaGetLastError();
}

template <typename T, int CO>
cudaError_t dispatch_flags(const void* x, const float* w, const float* scale,
                           const float* shift, void* y, float* partials, int B,
                           int H, int W, int cin, int cout, cudaStream_t stream) {
  const bool affine = scale != nullptr;
  const bool moments = partials != nullptr;
  if (affine && moments)
    return launch<T, CO, true, true>(x, w, scale, shift, y, partials, B, H, W, cin, cout, stream);
  if (affine)
    return launch<T, CO, true, false>(x, w, scale, shift, y, partials, B, H, W, cin, cout, stream);
  if (moments)
    return launch<T, CO, false, true>(x, w, scale, shift, y, partials, B, H, W, cin, cout, stream);
  return launch<T, CO, false, false>(x, w, scale, shift, y, partials, B, H, W, cin, cout, stream);
}

template <typename T>
cudaError_t dispatch_co(const void* x, const float* w, const float* scale,
                        const float* shift, void* y, float* partials, int B,
                        int H, int W, int cin, int cout, cudaStream_t stream) {
  if (cout <= 16)
    return dispatch_flags<T, 16>(x, w, scale, shift, y, partials, B, H, W, cin, cout, stream);
  return dispatch_flags<T, 32>(x, w, scale, shift, y, partials, B, H, W, cin, cout, stream);
}

}  // namespace

extern "C" {

// Number of thread blocks (= rows of the moments scratch buffer).
long long conv_bn_relu_num_blocks(int B, int H, int W) {
  return (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
}

// is_bf16: 0 -> float32 x/y, 1 -> bfloat16 x/y.  scale/shift both null for
// no prologue; partials null for no moments.  Shapes are checked by the
// caller: 1 <= cin <= 32, 1 <= cout <= 32, B and ceil(H/8) <= 65535.
int conv_bn_relu_launch(const void* x, const void* w, const void* scale,
                        const void* shift, void* y, void* partials, int is_bf16,
                        int B, int H, int W, int cin, int cout, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* pm = static_cast<float*>(partials);
  if (is_bf16)
    return (int)dispatch_co<__nv_bfloat16>(x, wf, sc, sh, y, pm, B, H, W, cin, cout, s);
  return (int)dispatch_co<float>(x, wf, sc, sh, y, pm, B, H, W, cin, cout, s);
}

// out (2*cout) = sum over num_blocks rows of partials (num_blocks, 2*cout).
int conv_bn_relu_fold_moments(const void* partials, void* out, long long num_blocks,
                              int cout, void* stream) {
  fold_moments_kernel<<<2 * cout, FOLD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partials), static_cast<float*>(out),
      (int)num_blocks, 2 * cout);
  return (int)cudaGetLastError();
}

}  // extern "C"
