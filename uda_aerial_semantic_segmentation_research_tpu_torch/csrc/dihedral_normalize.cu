// Per-image dihedral transform (gated transpose / flip-x / flip-y) of a uint8
// (B, S, S, C) batch of square tiles fused with the dequantization to f32
// (x / 255, optionally (x - mean) / std), and the same gates on the (B, S, S)
// label masks, cast to int32 -- one launch for both.
//
// Replaces: uda_aerial_semantic_segmentation_research_tpu/ops/pallas_ops.py
//           ::dihedral_normalize (Pallas kernels _dihedral_norm_kernel and
//           _dihedral_mask_kernel).
//
// Flag bits per image: bit 0 transpose, bit 1 flip width, bit 2 flip height,
// applied in that order, so output pixel (i, j) reads source pixel
//   (i', j') = (bit2 ? S-1-i : i,  bit1 ? S-1-j : j),  swapped when bit 0.
//
// What bounds it on an H100: the bytes (1 byte in and 4 bytes out per image
// element, 1..8 in and 4 out per mask element); there is no arithmetic to
// speak of.  The TPU kernel's permutation matmuls, channel-planar layout and
// f32 mask round trip were Mosaic workarounds; here the transform is index
// arithmetic and the values are moved, not multiplied, so the result is
// bit-exact.  The one difficulty is the transposed read: reading the source
// along the output's row order would stride by a whole image row.  So each
// block stages one 32 x 32 pixel tile through shared memory: it reads the
// tile in the SOURCE's row order (neighbouring threads on neighbouring bytes,
// forwards or backwards), converts, and writes the output tile in the
// output's row order.  Pixels are C-byte groups (C = 3: 3-byte pixels), so
// the loops run over the tile's elements with the channel fastest; the tile's
// rows are padded by one pixel so that the transposed store spreads over the
// shared-memory banks.
//
// C interface for ctypes; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 256;

struct Stats {
  float mean[3];
  float sd[3];
  int normalize;
};

struct ImageOp {
  Stats st;
  __device__ __forceinline__ float operator()(uint8_t v, int ch) const {
    float x = (float)v / 255.0f;
    if (st.normalize) {
      const float m = ch == 0 ? st.mean[0] : (ch == 1 ? st.mean[1] : st.mean[2]);
      const float s = ch == 0 ? st.sd[0] : (ch == 1 ? st.sd[1] : st.sd[2]);
      x = (x - m) / s;
    }
    return x;
  }
};

struct MaskOp {
  template <typename T>
  __device__ __forceinline__ int operator()(T v, int) const { return (int)v; }
};

// One TILE x TILE output tile of one image: src, dst (S, S, C).
template <typename TIn, typename TOut, typename Op>
__device__ __forceinline__ void permute_tile(const TIn* __restrict__ src,
                                             TOut* __restrict__ dst, TOut* tile,
                                             int bits, int S, int C, int oi0, int oj0,
                                             Op op) {
  const bool tr = bits & 1, fx = bits & 2, fy = bits & 4;
  const int n = TILE * TILE * C;
  for (int k = threadIdx.x; k < n; k += THREADS) {
    const int ch = k % C;
    const int p = k / C;
    const int fast = p % TILE;
    const int slow = p / TILE;
    // walk the tile so that the SOURCE column moves fastest
    const int li = tr ? fast : slow;
    const int lj = tr ? slow : fast;
    const int i = oi0 + li;
    const int j = oj0 + lj;
    if (i < S && j < S) {
      const int si = fy ? S - 1 - i : i;
      const int sj = fx ? S - 1 - j : j;
      const int row = tr ? sj : si;
      const int col = tr ? si : sj;
      tile[(li * (TILE + 1) + lj) * C + ch] = op(src[((size_t)row * S + col) * C + ch], ch);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += THREADS) {
    const int ch = k % C;
    const int p = k / C;
    const int lj = p % TILE;
    const int li = p / TILE;
    const int i = oi0 + li;
    const int j = oj0 + lj;
    if (i < S && j < S)
      dst[((size_t)i * S + j) * C + ch] = tile[(li * (TILE + 1) + lj) * C + ch];
  }
  __syncthreads();
}

template <typename TMask>
__global__ void __launch_bounds__(THREADS)
dihedral_kernel(const uint8_t* __restrict__ images, const int* __restrict__ flags,
                float* __restrict__ out, const TMask* __restrict__ masks,
                int* __restrict__ out_masks, int S, int C, Stats st) {
  extern __shared__ float smem[];  // TILE * (TILE + 1) * C
  const int b = blockIdx.z;
  const int bits = flags[b];
  const int oi0 = blockIdx.y * TILE;
  const int oj0 = blockIdx.x * TILE;
  const size_t plane = (size_t)S * S;
  permute_tile<uint8_t, float>(images + b * plane * C, out + b * plane * C, smem, bits,
                               S, C, oi0, oj0, ImageOp{st});
  if (masks != nullptr)
    permute_tile<TMask, int>(masks + b * plane, out_masks + b * plane,
                             reinterpret_cast<int*>(smem), bits, S, 1, oi0, oj0, MaskOp{});
}

template <typename TMask>
cudaError_t launch(const void* images, const void* flags, void* out, const void* masks,
                   void* out_masks, int B, int S, int C, Stats st, cudaStream_t stream) {
  const int tiles = (S + TILE - 1) / TILE;
  const dim3 grid(tiles, tiles, B);
  const size_t smem = sizeof(float) * TILE * (TILE + 1) * C;
  dihedral_kernel<TMask><<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(images), static_cast<const int*>(flags),
      static_cast<float*>(out), static_cast<const TMask*>(masks),
      static_cast<int*>(out_masks), S, C, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// images (B, S, S, C) uint8, flags (B) int32, out (B, S, S, C) f32.
// masks null, or (B, S, S) of mask_kind 0 -> uint8, 1 -> int32, 2 -> int64,
// with out_masks (B, S, S) int32.  normalize != 0 needs C == 3 and applies
// (x - mean) / std per channel.  Shapes are checked by the caller:
// 1 <= C <= 8, B <= 65535, ceil(S / 32) <= 65535.
int dihedral_normalize_launch(const void* images, const void* flags, void* out,
                              const void* masks, void* out_masks, int mask_kind, int B,
                              int S, int C, int normalize, float m0, float m1, float m2,
                              float s0, float s1, float s2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Stats st;
  st.mean[0] = m0; st.mean[1] = m1; st.mean[2] = m2;
  st.sd[0] = s0; st.sd[1] = s1; st.sd[2] = s2;
  st.normalize = normalize;
  if (mask_kind == 1)
    return (int)launch<int>(images, flags, out, masks, out_masks, B, S, C, st, s);
  if (mask_kind == 2)
    return (int)launch<long long>(images, flags, out, masks, out_masks, B, S, C, st, s);
  return (int)launch<uint8_t>(images, flags, out, masks, out_masks, B, S, C, st, s);
}

}  // extern "C"
