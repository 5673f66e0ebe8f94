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
// Higher bits are ignored; int64 flags are read through their low word.
//
// What bounds it on an H100: the bytes (1 byte in and 4 bytes out per image
// element, 1 in and 4 out per uint8 mask element: 168 MB at the train step's
// (32, 512, 512, 3) with uint8 masks).  There is no arithmetic to speak of:
// the values are moved, and the division is a table lookup, so the result is
// bit-exact against the plain version.  The design keeps the write stream
// (4/5 of the bytes) busy:
//
// - The division.  An image element has 256 possible values, so each block
//   fills a shared table lut[c][v] = (float)v / 255.0f once, with the IEEE
//   division of the plain version (this file is built without fast math);
//   under `normalize` the table holds (lut - mean[c]) / std[c], the same two
//   operations in the same order.  Per element: one shared-memory read.
// - Bulk path (C = 3, no masks or uint8 masks, S a multiple of 16, 16-byte
//   aligned pointers: the train step).  A work unit is a tile of R output rows
//   by W output columns of one image (64 x 256 at the step), planned on the
//   host (ops/dihedral.py::plan).  A block walks its units through a ring of
//   two stages in shared memory: the next unit's loads run under the current
//   unit's stores.  A block takes the ring's 138 KB at the step, so an SM
//   holds one; the grid is two blocks per SM, so that blocks that drew
//   slower units are evened out by the block scheduler handing the next
//   block to the SM that is free.  The bytes stay bytes in shared memory
//   (1 byte an element, not a converted float).  The flag decides per unit,
//   inside the one launch:
//   * Identity and flip-only elements (flags 0, 2, 4, 6): output row i is
//     source row i', read forwards or backwards by whole C-byte pixels.  The
//     unit's R source rows are staged densely by one thread's 1-d bulk
//     copies (cp.async.bulk, one a row segment, one in all when W = S),
//     completing on the stage's mbarrier; the reversal is index arithmetic
//     on the staged bytes.
//   * Transposed elements (flags 1, 3, 5, 7): output row i is source column
//     i'.  The unit is W source row segments of R pixels: 192 + 64 bytes
//     each at the step, too many and too small for one thread to issue as
//     bulk copies one by one at the memory rate, so every thread copies
//     16-byte chunks with cp.async and arrives on the same mbarrier when
//     they have landed.  The segments sit at row offsets
//     skewed by 16 bytes every 4 rows, so that the column reads (one lane a
//     row) spread over the 8 groups of 16-byte banks that 16-byte aligned
//     rows allow: 4 wavefronts per 32 lanes, the least those rows permit
//     (unskewed: 11 for images, 32 for masks).
//   Each warp writes output rows as 16-byte vectors (float4 / int4, four
//   elements a lane, consecutive lanes on consecutive vectors) with the
//   streaming hint st.global.cs: 134 MB of output against a 50 MB L2 is
//   never read back from it.  C = 3 is a compile-time constant: e / 3 is a
//   multiply.
// - Generic path (any C from 1 to 8, int32 / int64 masks, a pitch or pointer
//   that is not 16-byte aligned, S not a multiple of 16): threads along the
//   output row, one pixel each, scalar loads and stores, the same tables.
//   The channel loop runs to C: no division by C.
//
// C interface for ctypes; the entry points return cudaGetLastError() (or
// cudaErrorInvalidValue for a plan the kernel cannot take).

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace {

constexpr int THREADS = 512;                  // bulk kernel
constexpr int WARPS = THREADS / 32;
constexpr int GENERIC_THREADS = 256;
constexpr int MAX_CHANNELS = 8;
constexpr int MAX_STAGES = 4;
constexpr int LUT_OFFSET = 128;               // the stages' mbarriers sit before the tables
constexpr int RING_OFFSET = LUT_OFFSET + 3 * 256 * 4;   // 3,200: the ring after the tables

struct Stats {
  float mean[3];
  float sd[3];
  int normalize;
};

// the table entry of value v in channel ch: the plain version's arithmetic
__device__ __forceinline__ float table_value(int v, int ch, const Stats& st) {
  float x = (float)v / 255.0f;
  if (st.normalize) {
    const float m = ch == 0 ? st.mean[0] : (ch == 1 ? st.mean[1] : st.mean[2]);
    const float s = ch == 0 ? st.sd[0] : (ch == 1 ? st.sd[1] : st.sd[2]);
    x = (x - m) / s;
  }
  return x;
}

__device__ __forceinline__ int flag_bits(const int* flags, int stride, int b) {
  return __ldg(flags + (size_t)b * stride) & 7;
}

// ---------------------------------------------------------------------------
// bulk path
// ---------------------------------------------------------------------------
struct Bulk {
  const uint8_t* images;
  const int* flags;
  float* out;
  const uint8_t* masks;      // null: no masks
  int* out_masks;
  int flag_stride;           // 32-bit words from one image's flag to the next
  int B, S;
  int rows, cols;            // unit: rows x cols output pixels
  int tiles_i, tiles_j, units;
  int stages;
  uint32_t img_stage;        // bytes of a stage's image area; the masks follow
  uint32_t stage_bytes;
  Stats st;
};

// byte offset of staged row r of a transposed unit, rows of `chunks` 16-byte
// chunks: 16 bytes of skew every 4 rows
__device__ __forceinline__ uint32_t t_off(int r, int chunks) {
  return 16u * (uint32_t)(r * chunks + (r >> 2));
}

// the layout (host and device): bytes of a stage's image and mask areas for
// units of rows x cols pixels, dense (untransposed) or skewed (transposed),
// each rounded up to 128 bytes
__host__ __device__ inline uint32_t round128(uint32_t n) { return (n + 127u) & ~127u; }
__host__ __device__ inline uint32_t area_bytes(int rows, int cols, int ch) {
  const uint32_t dense = (uint32_t)rows * cols * ch;
  const uint32_t chunks = (uint32_t)rows * ch / 16;
  const uint32_t skewed = 16u * ((uint32_t)cols * chunks + (uint32_t)((cols - 1) >> 2));
  return round128(dense > skewed ? dense : skewed);
}

struct Tile {
  int b, i0, j0, rr, ww;     // image, first output row and column, rows, columns
  bool tr, fx, fy;
};

__device__ __forceinline__ Tile tile_at(const Bulk& p, int u) {
  Tile t;
  const int per_image = p.tiles_i * p.tiles_j;
  t.b = u / per_image;
  const int rem = u - t.b * per_image;
  const int ti = rem / p.tiles_j;
  t.i0 = ti * p.rows;
  t.j0 = (rem - ti * p.tiles_j) * p.cols;
  t.rr = min(p.rows, p.S - t.i0);
  t.ww = min(p.cols, p.S - t.j0);
  const int bits = flag_bits(p.flags, p.flag_stride, t.b);
  t.tr = bits & 1;
  t.fx = bits & 2;
  t.fy = bits & 4;
  return t;
}

// every thread: the source bytes of unit u into a stage, completing on `bar`
// (THREADS arrivals a phase).  Untransposed: thread 0 posts the bytes and
// issues bulk copies of whole rows (or row segments), the others arrive.
// Transposed: a unit is W' row segments of R' pixels, too many and too
// small to issue one bulk copy each from one thread, so every thread copies
// 16-byte chunks with cp.async and arrives when its chunks have landed.
__device__ void issue(const Bulk& p, int u, unsigned char* stage, uint32_t bar, int tid) {
  const Tile t = tile_at(p, u);
  const int S = p.S;
  // first source row and column of the unit
  const int row0 = t.tr ? (t.fx ? S - t.j0 - t.ww : t.j0) : (t.fy ? S - t.i0 - t.rr : t.i0);
  const int col0 = t.tr ? (t.fy ? S - t.i0 - t.rr : t.i0) : (t.fx ? S - t.j0 - t.ww : t.j0);
  const uint32_t dst_img = smem_u32(stage);
  const uint32_t dst_mask = smem_u32(stage + p.img_stage);
  const size_t plane = (size_t)t.b * S;
  if (!t.tr) {
    if (tid != 0) {
      mbar_arrive(bar);
      return;
    }
    const uint32_t img_bytes = (uint32_t)t.rr * t.ww * 3;
    fence_proxy_async();  // the stage's last reads came through the generic proxy
    mbar_expect_tx(bar, img_bytes + (p.masks ? (uint32_t)t.rr * t.ww : 0u));
    if (t.ww == S) {  // whole source rows: one contiguous copy each
      bulk_load(dst_img, p.images + (plane + row0) * S * 3, img_bytes, bar);
      if (p.masks) bulk_load(dst_mask, p.masks + (plane + row0) * S, (uint32_t)t.rr * S, bar);
      return;
    }
    for (int r = 0; r < t.rr; ++r) {
      const size_t src = (plane + row0 + r) * S + col0;
      bulk_load(dst_img + (uint32_t)r * t.ww * 3, p.images + src * 3, t.ww * 3, bar);
      if (p.masks) bulk_load(dst_mask + (uint32_t)r * t.ww, p.masks + src, t.ww, bar);
    }
    return;
  }
  const int ci = t.rr * 3 / 16;             // chunks of a staged image row
  const int cm = p.masks ? t.rr / 16 : 0;   // and of a staged mask row
  const int per_row = ci + cm;
  for (int q = tid; q < t.ww * per_row; q += THREADS) {
    const int r = q / per_row;
    const int c = q - r * per_row;
    const size_t src = (plane + row0 + r) * S + col0;
    if (c < ci)
      cp_async16(dst_img + t_off(r, ci) + 16 * c, p.images + src * 3 + 16 * c);
    else
      cp_async16(dst_mask + t_off(r, cm) + 16 * (c - ci), p.masks + src + 16 * (c - ci));
  }
  cp_async_arrive(bar);
}

// one unit's images: warp w writes output rows w, w + WARPS, ...; lane l the
// float4s l, l + 32, ... of the row (elements 4f .. 4f+3)
template <bool TR>
__device__ __forceinline__ void image_unit(const Bulk& p, const Tile& t,
                                           const unsigned char* sm, const float* lut,
                                           int warp, int lane) {
  const unsigned nf = (unsigned)t.ww * 3 / 4;
  const int chunks = t.rr * 3 / 16;
  for (int li = warp; li < t.rr; li += WARPS) {
    const int ls = t.fy ? t.rr - 1 - li : li;  // staged row (TR: staged column)
    float4* dst = reinterpret_cast<float4*>(
        p.out + (((size_t)t.b * p.S + t.i0 + li) * p.S + t.j0) * 3);
    const unsigned char* row = sm + (size_t)ls * t.ww * 3;
    if (!TR && !t.fx) {  // the staged row as it is: one word per float4
#pragma unroll 4
      for (unsigned f = lane; f < nf; f += 32) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * f);
        const unsigned c0 = f % 3;  // channel of element 4f (4 = 1 mod 3)
        const unsigned c1 = c0 == 2 ? 0 : c0 + 1;
        const unsigned c2 = c1 == 2 ? 0 : c1 + 1;
        __stcs(dst + f, make_float4(lut[c0 * 256 + (w & 255)], lut[c1 * 256 + ((w >> 8) & 255)],
                                    lut[c2 * 256 + ((w >> 16) & 255)],
                                    lut[c0 * 256 + (w >> 24)]));
      }
    } else {
#pragma unroll 4
      for (unsigned f = lane; f < nf; f += 32) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned e = 4 * f + k;
          const unsigned lj = e / 3;
          const unsigned ch = e - 3 * lj;
          const unsigned sj = t.fx ? t.ww - 1 - lj : lj;
          const unsigned byte = TR ? sm[t_off(sj, chunks) + ls * 3 + ch] : row[sj * 3 + ch];
          v[k] = lut[ch * 256 + byte];
        }
        __stcs(dst + f, make_float4(v[0], v[1], v[2], v[3]));
      }
    }
  }
}

// one unit's masks: as image_unit, one int4 (4 pixels) a lane
template <bool TR>
__device__ __forceinline__ void mask_unit(const Bulk& p, const Tile& t,
                                          const unsigned char* sm, int warp, int lane) {
  const unsigned nf = (unsigned)t.ww / 4;
  const int chunks = t.rr / 16;
  for (int li = warp; li < t.rr; li += WARPS) {
    const int ls = t.fy ? t.rr - 1 - li : li;
    int4* dst = reinterpret_cast<int4*>(p.out_masks + ((size_t)t.b * p.S + t.i0 + li) * p.S + t.j0);
    const unsigned char* row = sm + (size_t)ls * t.ww;
#pragma unroll 4
    for (unsigned f = lane; f < nf; f += 32) {
      int4 o;
      if (!TR) {
        if (!t.fx) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(row + 4 * f);
          o = make_int4(w & 255, (w >> 8) & 255, (w >> 16) & 255, w >> 24);
        } else {  // pixels ww-1-4f .. ww-4-4f: one word, bytes reversed
          const uint32_t w = *reinterpret_cast<const uint32_t*>(row + t.ww - 4 - 4 * f);
          o = make_int4(w >> 24, (w >> 16) & 255, (w >> 8) & 255, w & 255);
        }
      } else {
        int v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const unsigned lj = 4 * f + k;
          const unsigned sj = t.fx ? t.ww - 1 - lj : lj;
          v[k] = sm[t_off(sj, chunks) + ls];
        }
        o = make_int4(v[0], v[1], v[2], v[3]);
      }
      __stcs(dst + f, o);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1) dihedral_normalize_bulk_kernel(const Bulk p) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* lut = reinterpret_cast<float*>(smem + LUT_OFFSET);
  unsigned char* ring = smem + RING_OFFSET;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(smem_u32(&bars[s]), THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int k = tid; k < 3 * 256; k += THREADS) lut[k] = table_value(k & 255, k >> 8, p.st);
  __syncthreads();
  for (int s = 0; s < p.stages; ++s) {
    const int u = blockIdx.x + s * gridDim.x;
    if (u < p.units) issue(p, u, ring + (size_t)s * p.stage_bytes, smem_u32(&bars[s]), tid);
  }

  for (int k = 0;; ++k) {
    const int u = blockIdx.x + k * gridDim.x;
    if (u >= p.units) break;
    const int s = k % p.stages;
    unsigned char* stage = ring + (size_t)s * p.stage_bytes;
    const Tile t = tile_at(p, u);
    mbar_wait(smem_u32(&bars[s]), (k / p.stages) & 1);
    if (t.tr) {
      image_unit<true>(p, t, stage, lut, warp, lane);
      if (p.masks) mask_unit<true>(p, t, stage + p.img_stage, warp, lane);
    } else {
      image_unit<false>(p, t, stage, lut, warp, lane);
      if (p.masks) mask_unit<false>(p, t, stage + p.img_stage, warp, lane);
    }
    __syncthreads();  // every thread is done with this stage
    const int next = u + p.stages * gridDim.x;
    if (next < p.units) issue(p, next, stage, smem_u32(&bars[s]), tid);
  }
}

// ---------------------------------------------------------------------------
// generic path
// ---------------------------------------------------------------------------
template <typename TMask>
__global__ void __launch_bounds__(GENERIC_THREADS)
dihedral_normalize_generic_kernel(const uint8_t* __restrict__ images, const int* __restrict__ flags,
                                  int flag_stride, float* __restrict__ out,
                                  const TMask* __restrict__ masks, int* __restrict__ out_masks,
                                  int B, int S, int C, Stats st) {
  __shared__ float lut[MAX_CHANNELS * 256];
  for (int k = threadIdx.x; k < C * 256; k += GENERIC_THREADS)
    lut[k] = table_value(k & 255, k >> 8, st);
  __syncthreads();
  const long long rows = (long long)B * S;
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const int b = (int)(row / S);
    const int i = (int)(row - (long long)b * S);
    const int bits = flag_bits(flags, flag_stride, b);
    const bool tr = bits & 1, fx = bits & 2, fy = bits & 4;
    const int si = fy ? S - 1 - i : i;
    for (int j = threadIdx.x; j < S; j += GENERIC_THREADS) {
      const int sj = fx ? S - 1 - j : j;
      const size_t src = ((size_t)b * S + (tr ? sj : si)) * S + (tr ? si : sj);
      const size_t dst = (size_t)row * S + j;
      const uint8_t* in = images + src * C;
      float* o = out + dst * C;
      for (int ch = 0; ch < C; ++ch) o[ch] = lut[ch * 256 + in[ch]];
      if (masks != nullptr) out_masks[dst] = (int)masks[src];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Once per device, with it current: lets the bulk kernel use up to the
// device's opt-in shared memory a block.  Returns the SM count, or a negative
// CUDA error code.
int dihedral_normalize_prepare() {
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(&dihedral_normalize_bulk_kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  return err == cudaSuccess ? sms : -(int)err;
}

// images (B, S, S, C) uint8, flags (B) int32 or int64 (flag_stride 32-bit
// words from one image's flag to the next), out (B, S, S, C) f32.  masks null, or
// (B, S, S) of mask_kind 0 -> uint8, 1 -> int32, 2 -> int64, with out_masks
// (B, S, S) int32.  normalize != 0 needs C == 3 and applies (x - mean) / std
// per channel.  The launch is planned by the caller
// (ops/dihedral.py::plan): bulk != 0 takes the bulk kernel on `grid`
// blocks with units of rows x cols pixels in `stages` stages and
// `smem` bytes of shared memory, which must be what the kernel computes;
// bulk == 0 the generic kernel on `grid` blocks.  1 <= C <= 8.
int dihedral_normalize_launch(const void* images, const void* flags, int flag_stride, void* out,
                              const void* masks, void* out_masks, int mask_kind, int B, int S,
                              int C, int normalize, float m0, float m1, float m2, float s0,
                              float s1, float s2, int bulk, int grid, int rows, int cols,
                              int stages, int smem, void* stream) {
  const cudaStream_t strm = static_cast<cudaStream_t>(stream);
  Stats st;
  st.mean[0] = m0; st.mean[1] = m1; st.mean[2] = m2;
  st.sd[0] = s0; st.sd[1] = s1; st.sd[2] = s2;
  st.normalize = normalize;
  const int* fl = static_cast<const int*>(flags);
  if (B < 1 || S < 1 || C < 1 || C > MAX_CHANNELS || grid < 1 || (normalize && C != 3) ||
      flag_stride < 0 || (masks != nullptr) != (mask_kind >= 0))
    return (int)cudaErrorInvalidValue;
  if (bulk) {
    const bool has_masks = masks != nullptr;
    if (C != 3 || mask_kind > 0 || S % 16 != 0 || rows < 16 || rows % 16 != 0 ||
        cols < 16 || cols % 16 != 0 || rows > S || cols > S || stages < 1 ||
        stages > MAX_STAGES || !aligned16(images) || !aligned16(out) ||
        (has_masks && !(aligned16(masks) && aligned16(out_masks))))
      return (int)cudaErrorInvalidValue;
    Bulk p;
    p.images = static_cast<const uint8_t*>(images);
    p.flags = fl;
    p.out = static_cast<float*>(out);
    p.masks = static_cast<const uint8_t*>(masks);
    p.out_masks = static_cast<int*>(out_masks);
    p.flag_stride = flag_stride;
    p.B = B;
    p.S = S;
    p.rows = rows;
    p.cols = cols;
    p.tiles_i = (S + rows - 1) / rows;
    p.tiles_j = (S + cols - 1) / cols;
    const long long units = (long long)B * p.tiles_i * p.tiles_j;
    p.stages = stages;
    p.img_stage = area_bytes(rows, cols, 3);
    p.stage_bytes = p.img_stage + (has_masks ? area_bytes(rows, cols, 1) : 0u);
    p.st = st;
    if (units > 0x7fffffffLL || grid > units ||
        (long long)smem != RING_OFFSET + (long long)stages * p.stage_bytes)
      return (int)cudaErrorInvalidValue;
    p.units = (int)units;
    dihedral_normalize_bulk_kernel<<<grid, THREADS, smem, strm>>>(p);
    return (int)cudaGetLastError();
  }
  const uint8_t* img = static_cast<const uint8_t*>(images);
  float* o = static_cast<float*>(out);
  int* om = static_cast<int*>(out_masks);
  if (mask_kind == 1)
    dihedral_normalize_generic_kernel<int><<<grid, GENERIC_THREADS, 0, strm>>>(
        img, fl, flag_stride, o, static_cast<const int*>(masks), om, B, S, C, st);
  else if (mask_kind == 2)
    dihedral_normalize_generic_kernel<long long><<<grid, GENERIC_THREADS, 0, strm>>>(
        img, fl, flag_stride, o, static_cast<const long long*>(masks), om, B, S, C, st);
  else
    dihedral_normalize_generic_kernel<uint8_t><<<grid, GENERIC_THREADS, 0, strm>>>(
        img, fl, flag_stride, o, static_cast<const uint8_t*>(masks), om, B, S, C, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
