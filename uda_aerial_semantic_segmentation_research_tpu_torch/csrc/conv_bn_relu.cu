// Fused [BN-affine + ReLU ->] conv3x3 (SAME) [-> per-channel output moments]
// for NHWC activations with few channels (<= 32 in, <= 32 out).
//
// Replaces: uda_aerial_semantic_segmentation_research_tpu/ops/pallas_conv.py
//           ::packed_conv_bn_relu (Pallas kernel _conv_kernel, bf16 jnp.dot
//           with f32 accumulation), the serving path's BN1 -> ReLU -> conv2
//           chain of the two low-channel U-Net decoder blocks
//           (models/unet.py:187-202).
//
// Computes   y = conv3x3_SAME(a),   a = relu(scale * x + shift)  (or a = x)
// with the activation and the weights rounded to the input type before the
// product, as the Pallas kernel does, f32 accumulation, and the zero pad ring
// applied AFTER the ReLU (pad pixels read as exact zeros).  Optional moments
// are the per-channel (sum y, sum y^2) of the f32 accumulator over (B, H, W).
//
// What bounds it on an H100: the bytes.  At the serving shapes (B=32, bf16)
// a launch reads the activation once and writes the output once -- 268 MB at
// 256x256x32 -> 32 (0.080 ms at 3.35 TB/s) and 537 MB at 512x512x16 -> 16
// (0.160 ms) -- for 38.65 GFLOP each, 144 and 72 FLOP per byte.  The f32 CUDA
// cores (67 TFLOP/s, ridge ~20 FLOP/byte) need 0.58 ms for that work, so only
// the bf16 tensor cores (ridge ~295 FLOP/byte) put it under its byte bound.
//
// bf16: a tensor-core implicit GEMM (conv_bn_relu_mma_kernel).
// - GEMM view: M = output pixels (a block tile of 8 rows x 32 columns; each of
//   the 4 warps takes 2 rows, i.e. 4 m16 tiles), N = Cout rounded up to 8 (n8
//   tiles: Cout=20 -> 24), K = 9 taps x Cin rounded up to 16 (zero weights in
//   the padding: Cin=3 -> 16, Cin=24 -> 32).  For tap (ky, kx) the A operand
//   is the halo tile shifted by (ky, kx) pixels, B is W[ky, kx] (Cin x Cout).
// - mma.sync.m16n8k16 (bf16 in, f32 accumulate) with A in registers, loaded
//   by ldmatrix from the shifted window: each lane gives its own 16-byte row
//   address, so any one-pixel shift works (a wgmma shared-memory descriptor
//   for A needs 8-row core-matrix alignment, which a one-pixel shift breaks).
//   At 72-144 FLOP/byte the bytes, not the mma.sync rate, set the floor.
// - Shared-memory traffic is what the inner loop has to save.  A warp loads
//   its 4 halo rows once per (kx, k step) and each A fragment feeds every
//   output row it is a tap of (row r, halo row r+ky); each B fragment feeds
//   the warp's 4 m16 tiles.
// - The halo tile's pixels are 32 or 64 bytes apart; their 16-byte chunks are
//   XOR-swizzled by pixel index (the TMA's 32- and 64-byte swizzles), so the 8
//   rows of every ldmatrix phase fall on 8 different bank quads, for any shift.
// - The weights (at most 9 x 32 x 32 bf16 = 18 KB) are read once per block,
//   rounded to bf16 and laid out in shared memory in mma B-fragment order, so
//   a lane fetches its fragment with one 8-byte load.
// - Loads: one TMA request per halo tile (cp.async.bulk.tensor, a 4-d map of
//   x, completion on an mbarrier): out-of-image pixels arrive as zeros.  The
//   map comes from cuTensorMapEncodeTiled, found with
//   cudaGetDriverEntryPointByVersion, so the library links the runtime only.
//   Channel counts other than 16 and 32 (or an unaligned x) take a plain
//   per-element load into the same layout.
// - Prologue once per element, in shared memory: relu(scale*x + shift) is
//   applied in place to in-image pixels only and rounded to bf16, so the pad
//   ring stays exact 0 after the ReLU (the TMA's zero fill comes before the
//   prologue, and relu(scale*0 + shift) = relu(shift) != 0).
// - Persistent blocks (as many as fit on the SMs at once) walk over
//   (image, tile row, tile column); a two-stage ring of halo tiles keeps the
//   next tile's load in flight under this tile's tensor-core work: a slot is
//   refilled, two tiles ahead, as soon as its MMAs are done.  The halo
//   re-read (10x34 pixels for 8x32 outputs, 1.33x) is served from L2.
// - Epilogue: f32 accumulators -> bf16 -> staged in shared memory in the
//   TMA's swizzled layout (conflict-free fragment stores) -> one TMA store per
//   tile, which also clips the image edge.  Cout not a multiple of 8 takes
//   plain stores.  Moments come from the f32 accumulators of in-image pixels,
//   kept per thread across the block's tiles and reduced in a fixed order into
//   one partial row per block; a fold kernel sums the rows in a fixed order,
//   so two launches give the same bits.
//
// float32: the CUDA-core direct convolution (conv_bn_relu_f32_kernel), exact
// to 1e-4 against an f32 reference; TF32 tensor cores would not be.  One
// block per (image, 8-row x 32-column output tile) loads its halo tile into
// shared memory channel-major, applying the prologue to in-image pixels only;
// one output pixel per thread, all output channels in registers.
//
// C interface for ctypes; each launching entry point returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr int FOLD_THREADS = 256;

// ---------------------------------------------------------------------------
// float32: CUDA-core direct convolution
// ---------------------------------------------------------------------------

constexpr int F_TH = 8;                 // output rows per block
constexpr int F_TW = 32;                // output columns per block (one warp wide)
constexpr int F_IH = F_TH + 2;          // input tile rows with halo
constexpr int F_IW = F_TW + 2;          // input tile columns with halo
constexpr int F_THREADS = F_TH * F_TW;  // one output pixel per thread
constexpr int F_WARPS = F_THREADS / 32;

// x (B,H,W,cin), w (3,3,cin,cout) HWIO, scale/shift (cin), y (B,H,W,cout),
// partials (num_blocks, 2, cout).  CO is cout rounded up to 16 or 32.
template <int CO, bool AFFINE, bool MOMENTS>
__global__ void __launch_bounds__(F_THREADS)
conv_bn_relu_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        float* __restrict__ y, float* __restrict__ partials,
                        int H, int W, int cin, int cout) {
  extern __shared__ float smem_f32[];
  float* s_in = smem_f32;                     // [cin][F_IH][F_IW]
  float* s_w = smem_f32 + cin * F_IH * F_IW;  // [9][cin][CO]
  __shared__ float s_mom[F_WARPS][2][CO];

  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * F_TH;
  const int ox0 = blockIdx.x * F_TW;
  const int tid = threadIdx.x;

  for (int i = tid; i < 9 * cin * CO; i += F_THREADS) {
    const int co = i % CO;
    const int tap_ci = i / CO;
    s_w[i] = co < cout ? w[tap_ci * cout + co] : 0.f;
  }

  // input tile + halo; channel-fastest global reads (coalesced)
  const float* xb = x + (size_t)b * H * W * cin;
  const int n_in = F_IH * F_IW * cin;
  for (int i = tid; i < n_in; i += F_THREADS) {
    const int c = i % cin;
    const int pix = i / cin;
    const int col = pix % F_IW;
    const int row = pix / F_IW;
    const int gy = oy0 - 1 + row;
    const int gx = ox0 - 1 + col;
    float v = 0.f;  // pad ring: exact zero after the ReLU
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = xb[((size_t)gy * W + gx) * cin + c];
      if (AFFINE) v = fmaxf(__fadd_rn(__fmul_rn(v, scale[c]), shift[c]), 0.f);
    }
    s_in[(c * F_IH + row) * F_IW + col] = v;
  }
  __syncthreads();

  const int ty = tid / F_TW;
  const int tx = tid % F_TW;
  float acc[CO];
#pragma unroll
  for (int co = 0; co < CO; ++co) acc[co] = 0.f;

  for (int ci = 0; ci < cin; ++ci) {
    const float* sp = s_in + (ci * F_IH + ty) * F_IW + tx;
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        const float a = sp[ky * F_IW + kx];
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
    float* yp = y + (((size_t)b * H + oy) * W + ox) * cout;
#pragma unroll
    for (int co = 0; co < CO; ++co) {
      if (co < cout) yp[co] = acc[co];
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
      for (int wi = 0; wi < F_WARPS; ++wi) t += s_mom[wi][m][co];
      const size_t blk =
          ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
      partials[blk * 2 * cout + tid] = t;
    }
  }
}

template <int CO, bool AFFINE, bool MOMENTS>
cudaError_t launch_f32(const float* x, const float* w, const float* scale,
                       const float* shift, float* y, float* partials, int B, int H,
                       int W, int cin, int cout, cudaStream_t stream) {
  const dim3 grid((W + F_TW - 1) / F_TW, (H + F_TH - 1) / F_TH, B);
  const size_t smem = sizeof(float) * ((size_t)cin * F_IH * F_IW + (size_t)9 * cin * CO);
  auto kernel = conv_bn_relu_f32_kernel<CO, AFFINE, MOMENTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, F_THREADS, smem, stream>>>(x, w, scale, shift, y, partials, H, W,
                                            cin, cout);
  return cudaGetLastError();
}

template <int CO>
cudaError_t dispatch_f32_flags(const float* x, const float* w, const float* scale,
                               const float* shift, float* y, float* partials, int B,
                               int H, int W, int cin, int cout, cudaStream_t stream) {
  const bool affine = scale != nullptr;
  const bool moments = partials != nullptr;
  if (affine && moments)
    return launch_f32<CO, true, true>(x, w, scale, shift, y, partials, B, H, W, cin, cout, stream);
  if (affine)
    return launch_f32<CO, true, false>(x, w, scale, shift, y, partials, B, H, W, cin, cout, stream);
  if (moments)
    return launch_f32<CO, false, true>(x, w, scale, shift, y, partials, B, H, W, cin, cout, stream);
  return launch_f32<CO, false, false>(x, w, scale, shift, y, partials, B, H, W, cin, cout, stream);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core implicit GEMM
// ---------------------------------------------------------------------------

constexpr int TH = 8;                    // output rows per tile
constexpr int TW = 32;                   // output columns per tile
constexpr int HH = TH + 2;               // halo tile rows
constexpr int HW = TW + 2;               // halo tile columns
constexpr int HALO_PIX = HH * HW;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int R = TH / WARPS;            // output rows per warp
constexpr int MT = TW / 16;              // m16 tiles per output row
constexpr int STAGES = 2;                // halo tiles per block: one used, one in flight
static_assert(R == 2, "two output rows per warp share their halo rows");

constexpr int align1k(int n) { return (n + 1023) / 1024 * 1024; }

template <int CIN_P, int NT>
struct Cfg {
  static constexpr int KC = CIN_P / 16;   // k16 steps per tap
  static constexpr int CH = CIN_P / 8;    // 16-byte chunks per halo pixel
  static constexpr int PIX_BYTES = CIN_P * 2;
  static constexpr int NP = NT * 8;
  static constexpr int OUT_PIX_BYTES = NP * 2;
  // slots start on 1 KB boundaries, so the swizzle below is the one the
  // tensor memory accelerator applies to absolute shared addresses
  static constexpr int SLOT_BYTES = align1k(HALO_PIX * PIX_BYTES);
  static constexpr int OUT_BYTES = align1k(TH * TW * OUT_PIX_BYTES);
  static constexpr int W_FRAGS = 9 * KC * NT * 32;  // one uint2 per lane
  static constexpr int W_BYTES = W_FRAGS * 8;
  static constexpr int MOM_FLOATS = WARPS * 2 * NP;
  static constexpr int SMEM = 1024 /* alignment slack */ + STAGES * SLOT_BYTES + OUT_BYTES +
                              W_BYTES + 4 * (2 * CIN_P + MOM_FLOATS) + 8 * STAGES;
  // 2 blocks per SM where shared memory allows no more (all registers
  // free for the accumulators), else 4
  static constexpr int MIN_BLOCKS = CIN_P == 32 && NT >= 3 ? 2 : 4;
};

// 16-byte chunk c of halo pixel p sits at chunk position c ^ swizzle(p).  For
// 64-byte pixels this is the TMA's 64-byte swizzle (address bits 4-5 ^= bits
// 7-8), for 32-byte pixels its 32-byte swizzle (bit 4 ^= bit 7).  Any 8
// consecutive pixels then put the chunk one ldmatrix phase reads on 8
// different bank quads, whatever the shift.
template <int CH>
__device__ __forceinline__ int swizzle(int p) {
  return CH == 4 ? (p >> 1) & 3 : CH == 2 ? (p >> 2) & 1 : 0;
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      "cp.async.bulk.commit_group;\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3) : "memory");
}

// wait until the block's TMA stores have read their shared memory source
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

struct Tile {
  int b, oy0, ox0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_x, int tiles_y) {
  const int tx = t % tiles_x;
  const int rest = t / tiles_x;
  return {rest / tiles_y, (rest % tiles_y) * TH, tx * TW};
}

// Tile t's raw halo into a ring slot.  TMA: one thread, one request; pixels
// outside the image and channels past cin arrive as zeros.  Otherwise (cin
// not 16 or 32, or x not 16-byte aligned) every thread loads elements.
template <int CIN_P>
__device__ __forceinline__ void load_halo(unsigned char* slot, uint32_t bar,
                                          const CUtensorMap* map_x,
                                          const __nv_bfloat16* __restrict__ x, Tile tl,
                                          int H, int W, int cin, bool tma) {
  constexpr int CH = Cfg<CIN_P, 1>::CH;
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, HALO_PIX * Cfg<CIN_P, 1>::PIX_BYTES);
      tma_load_4d(smem_u32(slot), map_x, bar, 0, tl.ox0 - 1, tl.oy0 - 1, tl.b);
    }
    return;
  }
  for (int i = threadIdx.x; i < HALO_PIX * CH; i += THREADS) {
    const int p = i / CH;
    const int c = i % CH;
    const int hy = p / HW;
    const int gy = tl.oy0 - 1 + hy;
    const int gx = tl.ox0 - 1 + (p - hy * HW);
    const bool in_image = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const __nv_bfloat16* src = x + (((size_t)tl.b * H + gy) * W + gx) * cin + c * 8;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = in_image && c * 8 + j < cin ? src[j] : __float2bfloat16(0.f);
    *reinterpret_cast<uint4*>(slot + p * Cfg<CIN_P, 1>::PIX_BYTES +
                              ((c ^ swizzle<CH>(p)) << 4)) = *reinterpret_cast<const uint4*>(v);
  }
}

// a = bf16(relu(scale*x + shift)) in place, in-image pixels only: the pad
// ring keeps its exact zeros.  Padded channels have scale = shift = 0.
template <int CIN_P>
__device__ __forceinline__ void prologue(unsigned char* slot, const float* s_aff, Tile tl,
                                         int H, int W, int chunks) {
  constexpr int CH = Cfg<CIN_P, 1>::CH;
  for (int i = threadIdx.x; i < HALO_PIX * CH; i += THREADS) {
    const int p = i / CH;
    const int c = i % CH;
    const int hy = p / HW;
    const int gy = tl.oy0 - 1 + hy;
    const int gx = tl.ox0 - 1 + (p - hy * HW);
    if (c >= chunks || gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    uint4* q = reinterpret_cast<uint4*>(slot + p * Cfg<CIN_P, 1>::PIX_BYTES +
                                        ((c ^ swizzle<CH>(p)) << 4));
    uint4 raw = *q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = c * 8 + 2 * j;
      const float2 f = __bfloat1622float2(h[j]);
      const float lo = fmaxf(__fadd_rn(__fmul_rn(f.x, s_aff[ch]), s_aff[CIN_P + ch]), 0.f);
      const float hi = fmaxf(__fadd_rn(__fmul_rn(f.y, s_aff[ch + 1]), s_aff[CIN_P + ch + 1]), 0.f);
      h[j] = __floats2bfloat162_rn(lo, hi);
    }
    *q = raw;
  }
}

// Byte offset of output chunk c (8 channels) of tile pixel pix in the staging
// buffer: the layout the TMA store reads (64- or 32-byte swizzle for 32 or 16
// channels), so that fragment stores hit 32 different banks.
template <int NP>
__device__ __forceinline__ int out_offset(int pix, int c) {
  constexpr int SW = NP == 32 ? 4 : NP == 16 ? 2 : 1;
  return pix * NP * 2 + ((c ^ swizzle<SW>(pix)) << 4);
}

// x (B,H,W,cin) bf16, w (3,3,cin,cout) f32 HWIO, scale/shift (cin) f32 or
// null, y (B,H,W,cout) bf16, partials (gridDim.x, 2, cout) f32 or null.
// CIN_P = cin rounded up to 16 or 32, NT = ceil(cout / 8).  map_x / map_y:
// tensor maps of x and y (used when tma_in / tma_out).
template <int CIN_P, int NT>
__global__ void __launch_bounds__(THREADS, Cfg<CIN_P, NT>::MIN_BLOCKS)
conv_bn_relu_mma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_y,
                        const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ scale, const float* __restrict__ shift,
                        __nv_bfloat16* __restrict__ y, float* __restrict__ partials,
                        int H, int W, int cin, int cout, int tiles_x, int tiles_y,
                        int n_tiles, int tma_in, int tma_out) {
  using C = Cfg<CIN_P, NT>;
  extern __shared__ unsigned char smem_raw[];  // not smem_f32: another type
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);
  unsigned char* s_halo = smem;                                   // [STAGES][HALO_PIX][CIN_P] swizzled
  unsigned char* s_out = smem + STAGES * C::SLOT_BYTES;           // [TH*TW][NP] swizzled
  const uint2* s_w = reinterpret_cast<const uint2*>(s_out + C::OUT_BYTES);  // [9][KC][NT][32]
  float* s_aff = reinterpret_cast<float*>(s_out + C::OUT_BYTES + C::W_BYTES);  // scale, shift
  float* s_mom = s_aff + 2 * CIN_P;                               // [WARPS][2][NP]
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_mom + C::MOM_FLOATS);  // [STAGES]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool affine = scale != nullptr;
  const bool moments = partials != nullptr;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(smem_u32(&s_bar[s]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first tiles' loads run while the weights are staged
  for (int s = 0; s < STAGES; ++s) {
    const int t = blockIdx.x + s * gridDim.x;
    if (t < n_tiles)
      load_halo<CIN_P>(s_halo + s * C::SLOT_BYTES, smem_u32(&s_bar[s]), &map_x, x,
                       tile_of(t, tiles_x, tiles_y), H, W, cin, tma_in);
  }

  // weights -> bf16 B fragments: lane l of n-tile nt holds
  // B[k = kc*16 + (l%4)*2 + {0, 1, 8, 9}][n = nt*8 + l/4]
  {
    __nv_bfloat16* wf = reinterpret_cast<__nv_bfloat16*>(s_out + C::OUT_BYTES);
    for (int i = tid; i < C::W_FRAGS * 4; i += THREADS) {
      const int j = i & 3;
      const int l = (i >> 2) & 31;
      const int frag = i >> 7;                 // (tap * KC + kc) * NT + nt
      const int nt = frag % NT;
      const int kc = (frag / NT) % C::KC;
      const int tap = frag / (NT * C::KC);
      const int k = kc * 16 + (l & 3) * 2 + (j & 1) + (j >> 1) * 8;
      const int n = nt * 8 + (l >> 2);
      wf[i] = __float2bfloat16(k < cin && n < cout ? w[((size_t)tap * cin + k) * cout + n] : 0.f);
    }
    for (int i = tid; i < CIN_P; i += THREADS) {
      s_aff[i] = affine && i < cin ? scale[i] : 0.f;
      s_aff[CIN_P + i] = affine && i < cin ? shift[i] : 0.f;
    }
  }

  // ldmatrix.x4 row addresses: lane l reads row l%16 of an m16 tile, k-half
  // l/16; the second m16 tile of a row is 16 pixels on, which keeps the
  // swizzle phase
  const int p_lane = warp * R * HW + (lane & 15);
  const int g = lane >> 2;     // fragment row group
  const int tig = lane & 3;    // thread in group
  const int chunks_in = (cin + 7) / 8;

  float msum[NT][2], msq[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    msum[nt][0] = msum[nt][1] = msq[nt][0] = msq[nt][1] = 0.f;
  }
  __syncthreads();

  for (int i = 0;; ++i) {
    const int t = blockIdx.x + i * gridDim.x;
    if (t >= n_tiles) break;
    const Tile tl = tile_of(t, tiles_x, tiles_y);
    const int s = i % STAGES;
    unsigned char* slot = s_halo + s * C::SLOT_BYTES;

    if (tma_in) mbar_wait(smem_u32(&s_bar[s]), (i / STAGES) & 1);
    if (affine) {
      prologue<CIN_P>(slot, s_aff, tl, H, W, chunks_in);
      __syncthreads();
    }

    float acc[R][MT][NT][4];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][mt][nt][e] = 0.f;

    // implicit GEMM: for each kx and k step, the warp's R+2 halo rows are
    // loaded once and each feeds the output rows it is a tap of (row r uses
    // halo row r+ky); each B fragment feeds R*MT m16 tiles
    const uint32_t slot_addr = smem_u32(slot);
#pragma unroll
    for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
      for (int kc = 0; kc < C::KC; ++kc) {
        uint32_t a[R + 2][MT][4];
#pragma unroll
        for (int hr = 0; hr < R + 2; ++hr) {
          const int p = p_lane + hr * HW + kx;
          const uint32_t row = slot_addr + p * C::PIX_BYTES +
                               (((kc * 2 + (lane >> 4)) ^ swizzle<C::CH>(p)) << 4);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[hr][mt], row + mt * 16 * C::PIX_BYTES);
        }
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const uint2 bf = s_w[(((ky * 3 + kx) * C::KC + kc) * NT + nt) * 32 + lane];
#pragma unroll
            for (int r = 0; r < R; ++r)
#pragma unroll
              for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[r][mt][nt], a[r + ky][mt], bf);
          }
        }
      }
    }

    // every warp is done with this slot and with the previous tile's staged
    // output: refill the slot two tiles ahead, then stage this tile
    fence_proxy_async();
    if (tma_out && tid == 0) tma_store_wait_read();
    __syncthreads();
    {
      const int tn = blockIdx.x + (i + STAGES) * gridDim.x;
      if (tn < n_tiles)
        load_halo<CIN_P>(slot, smem_u32(&s_bar[s]), &map_x, x, tile_of(tn, tiles_x, tiles_y),
                         H, W, cin, tma_in);
    }

    // fragments -> bf16 staging buffer (+ moments of in-image pixels)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int col = mt * 16 + g + half * 8;
        const int pix = (warp * R + r) * TW + col;
        const bool inside = tl.oy0 + warp * R + r < H && tl.ox0 + col < W;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float v0 = acc[r][mt][nt][half * 2];
          const float v1 = acc[r][mt][nt][half * 2 + 1];
          const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(s_out + out_offset<C::NP>(pix, nt) + tig * 4) = h;
          if (moments && inside) {
            msum[nt][0] += v0;
            msum[nt][1] += v1;
            msq[nt][0] += v0 * v0;
            msq[nt][1] += v1 * v1;
          }
        }
      }
    }
    fence_proxy_async();
    __syncthreads();

    if (tma_out) {
      // one request; rows and columns past the image are not written
      if (tid == 0) tma_store_4d(&map_y, smem_u32(s_out), 0, tl.ox0, tl.oy0, tl.b);
    } else {
      for (int j = tid; j < TH * TW * cout; j += THREADS) {
        const int pix = j / cout;
        const int c = j - pix * cout;
        const int oy = tl.oy0 + pix / TW;
        const int ox = tl.ox0 + pix % TW;
        if (oy < H && ox < W)
          y[(((size_t)tl.b * H + oy) * W + ox) * cout + c] = *reinterpret_cast<const __nv_bfloat16*>(
              s_out + out_offset<C::NP>(pix, c / 8) + (c % 8) * 2);
      }
    }
  }
  if (tma_out && tid == 0) tma_store_wait_all();

  if (moments) {
    // lanes of one tig hold the same channels: reduce over g, then warps
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = msum[nt][e], q = msq[nt][e];
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, off);
          q += __shfl_xor_sync(0xffffffffu, q, off);
        }
        if (g == 0) {
          s_mom[(warp * 2 + 0) * C::NP + nt * 8 + tig * 2 + e] = s;
          s_mom[(warp * 2 + 1) * C::NP + nt * 8 + tig * 2 + e] = q;
        }
      }
    }
    __syncthreads();
    if (tid < 2 * cout) {
      const int m = tid / cout;
      const int co = tid % cout;
      float t = 0.f;
      for (int wi = 0; wi < WARPS; ++wi) t += s_mom[(wi * 2 + m) * C::NP + co];
      partials[(size_t)blockIdx.x * 2 * cout + tid] = t;
    }
  }
}

struct MmaShape {
  int tiles_x, tiles_y, n_tiles;
};

MmaShape mma_shape(int B, int H, int W) {
  const int tx = (W + TW - 1) / TW;
  const int ty = (H + TH - 1) / TH;
  return {tx, ty, tx * ty * B};
}

template <int CIN_P, int NT>
cudaError_t mma_grid(int n_tiles, int* grid) {
  auto kernel = conv_bn_relu_mma_kernel<CIN_P, NT>;
  constexpr int smem = Cfg<CIN_P, NT>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)))
    return err;
  if ((err = cudaGetDevice(&dev))) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *grid = n_tiles < per_sm * sms ? n_tiles : per_sm * sms;
  return cudaSuccess;
}

// cuTensorMapEncodeTiled from libcuda, found at run time: the library
// links against the runtime only.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
            cudaSuccess || q != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// 4-d map of a (B, H, W, C) bf16 tensor with a (1, box_h, box_w, C) box;
// 64- or 32-byte swizzle for 64- or 32-byte pixels, zeros out of bounds.
cudaError_t nhwc_map(CUtensorMap* map, const void* base, int B, int H, int W, int C,
                     int box_h, int box_w) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = C == 32   ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : C == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
                                           : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int CIN_P, int NT>
cudaError_t mma_launch(const __nv_bfloat16* x, const float* w, const float* scale,
                       const float* shift, __nv_bfloat16* y, float* partials, int B,
                       int H, int W, int cin, int cout, int grid, cudaStream_t stream) {
  // mma_grid (conv_bn_relu_bf16_num_blocks) has raised the kernel's shared
  // memory limit before; without it the launch fails and says so
  const MmaShape s = mma_shape(B, H, W);
  if (grid < 1 || grid > s.n_tiles) return cudaErrorInvalidValue;
  // TMA: pixels of exactly 16 or 32 channels in, a multiple of 8 out,
  // 16-byte aligned bases (the strides are multiples of 16 bytes then)
  const int tma_in = cin == CIN_P && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int tma_out = cout % 8 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  CUtensorMap map_x{}, map_y{};
  cudaError_t err;
  if (tma_in && (err = nhwc_map(&map_x, x, B, H, W, cin, HH, HW))) return err;
  if (tma_out && (err = nhwc_map(&map_y, y, B, H, W, cout, TH, TW))) return err;
  conv_bn_relu_mma_kernel<CIN_P, NT><<<grid, THREADS, Cfg<CIN_P, NT>::SMEM, stream>>>(
      map_x, map_y, x, w, scale, shift, y, partials, H, W, cin, cout, s.tiles_x, s.tiles_y,
      s.n_tiles, tma_in, tma_out);
  return cudaGetLastError();
}

// Calls F<CIN_P, NT>::run(args...) for the instance that takes (cin, cout).
template <template <int, int> class F, typename... Args>
cudaError_t dispatch_mma(int cin, int cout, Args... args) {
  const int nt = (cout + 7) / 8;
  if (cin <= 16) {
    switch (nt) {
      case 1: return F<16, 1>::run(args...);
      case 2: return F<16, 2>::run(args...);
      case 3: return F<16, 3>::run(args...);
      default: return F<16, 4>::run(args...);
    }
  }
  switch (nt) {
    case 1: return F<32, 1>::run(args...);
    case 2: return F<32, 2>::run(args...);
    case 3: return F<32, 3>::run(args...);
    default: return F<32, 4>::run(args...);
  }
}

template <int CIN_P, int NT>
struct GridOp {
  static cudaError_t run(int n_tiles, int* grid) { return mma_grid<CIN_P, NT>(n_tiles, grid); }
};

template <int CIN_P, int NT>
struct LaunchOp {
  template <typename... Args>
  static cudaError_t run(Args... args) { return mma_launch<CIN_P, NT>(args...); }
};

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

}  // namespace

extern "C" {

// Thread blocks of a float32 launch (= rows of its moments scratch buffer).
long long conv_bn_relu_f32_num_blocks(int B, int H, int W) {
  return (long long)((W + F_TW - 1) / F_TW) * ((H + F_TH - 1) / F_TH) * B;
}

// Thread blocks of a bfloat16 launch: the persistent blocks that fit on the
// device at once, at most one per tile.  Returns a negative CUDA error code
// on failure.
long long conv_bn_relu_bf16_num_blocks(int B, int H, int W, int cin, int cout) {
  int grid = 0;
  const cudaError_t err =
      dispatch_mma<GridOp>(cin, cout, mma_shape(B, H, W).n_tiles, &grid);
  return err == cudaSuccess ? (long long)grid : -(long long)err;
}

// float32 x/y.  scale/shift both null for no prologue; partials null for no
// moments.  Shapes are checked by the caller: 1 <= cin, cout <= 32,
// B and ceil(H/8) <= 65535.
int conv_bn_relu_f32_launch(const void* x, const void* w, const void* scale,
                            const void* shift, void* y, void* partials, int B, int H,
                            int W, int cin, int cout, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  float* yf = static_cast<float*>(y);
  float* pm = static_cast<float*>(partials);
  if (cout <= 16)
    return (int)dispatch_f32_flags<16>(xf, wf, sc, sh, yf, pm, B, H, W, cin, cout, s);
  return (int)dispatch_f32_flags<32>(xf, wf, sc, sh, yf, pm, B, H, W, cin, cout, s);
}

// bfloat16 x/y, f32 HWIO weights (rounded to bf16 in the kernel), f32
// scale/shift or both null, partials (grid, 2, cout) or null; grid from
// conv_bn_relu_bf16_num_blocks, called before in this process on this
// device.  1 <= cin, cout <= 32.
int conv_bn_relu_bf16_launch(const void* x, const void* w, const void* scale,
                             const void* shift, void* y, void* partials, int B, int H,
                             int W, int cin, int cout, int grid, void* stream) {
  return (int)dispatch_mma<LaunchOp>(
      cin, cout, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(partials), B, H, W, cin, cout,
      grid, static_cast<cudaStream_t>(stream));
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
