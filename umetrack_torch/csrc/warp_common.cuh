// What the bilinear warp kernels share (warp_pool.cu, warp_image.cu): the
// sample rule, the explicitly rounded lerp, and the tiled kernel that the
// image-pool warp and the windowed single-image warp both are.
//
// The function, for every kernel here: out[n, p] = bilinear sample of an
// image at coords[n, p] = (x, y) with f32 lerp weights; a sample is valid
// only if x >= 0, x < W-1, y >= 0 and y < H-1 and is 0 otherwise (NaN is
// invalid).  Valid coordinates are clamped to [0, W-2] x [0, H-2] before
// the floor, so the weights follow the clamped value.
//
// The tiled kernel (`tile_kernel`).  A block owns a rectangular tile of one
// crop's output pixels, so its source footprint is compact in both
// directions; a thread owns kPix x-adjacent pixels of one row, reads their
// coordinates as two 16-byte words and writes their outputs as one, both
// past L1 (streaming), and keeps 4 * kPix independent tap loads in flight.
// The tile's width in threads (1 << log2_tx) and the block size are launch
// arguments, so one binary serves square tiles and flat lists.  Crops whose
// width is no multiple of kPix, or whose coordinates are not 16-byte
// aligned, take the scalar instantiation (VEC = false): the same index map,
// 8-byte loads and 4-byte stores masked at the crop's edge.
//
// Where the taps come from is the STAGED template argument:
//   false  in place from global memory, through L1;
//   true   the block reduces the floor-cell box of its valid samples and,
//          when the box and its +1 taps fit the kWinRows x kWinCols window,
//          copies exactly that box into shared memory with 16-byte cp.async
//          chunks (from a start rounded down to 16 bytes; rows by thread
//          group, no division per element) and samples from there.
// A block whose box does not fit samples in place; a block with no valid
// sample stages nothing.  These branches are uniform per block and no thread
// leaves before the barrier: threads past the crop's edge and threads with
// invalid samples stay, and stay out of the min/max.  Every path ends in
// the same `lerp4`, so all of them, the full kernel and the plain PyTorch
// version agree bit for bit.
//
// Staging needs a 16-byte-aligned image base and row pitch; the wrappers
// send other shapes to the unstaged form by a rule on the shape
// (ops/_tiles.py).  Offsets are 64-bit throughout.
//
// Measured on an H100 (PERF.md has the numbers): with 2-D tiles the taps
// read in place are as fast as any staged form that was tried (cp.async
// chunks, a TMA tensor copy, one bulk copy per row: all within a few
// percent at the tracker's shape; at the torch_data shape, where a crop
// spans a third of the frame and the taps touch a third of their box,
// staging moves more bytes than it saves).  So the pool warp instantiates
// the unstaged form alone.  The windowed warp, whose TPU counterpart is
// defined by its staged window, keeps the cp.async form, which copies
// exactly the box at either scale.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

namespace warp {

constexpr int kPix = 4;  // x-adjacent output pixels per thread
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
// The staged window in source pixels.  A 32 x 32 tile of a 96 x 96 crop
// that spans a third of a 480 x 640 frame covers about 106 x 100 source
// pixels (99th percentile 131 x 130), plus up to 15 pixels of alignment.
constexpr int kWinRows = 136;
constexpr int kWinCols = 160;

// The constants above by index, -1 past the last: the wrappers state the
// same numbers and check them against each library when it loads.
inline int constant(int which) {
  const int all[] = {kPix, kMaxThreads, kWinRows, kWinCols};
  return which >= 0 && which < (int)(sizeof(all) / sizeof(all[0])) ? all[which] : -1;
}

struct Sample {
  bool valid;
  int x0, y0;
  float wx, wy;
};

__device__ __forceinline__ Sample prepare(float2 c, int height, int width) {
  Sample s;
  // Comparisons are false for NaN, so a NaN coordinate is invalid.
  s.valid = (c.x >= 0.f) && (c.x < (float)(width - 1)) &&
            (c.y >= 0.f) && (c.y < (float)(height - 1));
  s.x0 = 0;
  s.y0 = 0;
  s.wx = 0.f;
  s.wy = 0.f;
  if (s.valid) {
    const float x = fminf(c.x, (float)(width - 2));
    const float y = fminf(c.y, (float)(height - 2));
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    s.x0 = (int)x0f;
    s.y0 = (int)y0f;
    s.wx = x - x0f;
    s.wy = y - y0f;
  }
  return s;
}

// f00 (1-wx)(1-wy) + f10 wx (1-wy) + f01 (1-wx) wy + f11 wx wy, each
// operation rounded on its own and summed left to right, so that no path
// is contracted into FMAs differently from another.
__device__ __forceinline__ float lerp4(float f00, float f10, float f01,
                                       float f11, float wx, float wy) {
  const float ux = __fsub_rn(1.f, wx);
  const float uy = __fsub_rn(1.f, wy);
  float acc = __fmul_rn(__fmul_rn(f00, ux), uy);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(f10, wx), uy));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(f01, ux), wy));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(f11, wx), wy));
  return acc;
}

template <typename T>
__device__ __forceinline__ float sample_global(const T* __restrict__ image,
                                               int width, const Sample& s) {
  const T* row0 = image + (int64_t)s.y0 * width + s.x0;
  const T* row1 = row0 + width;
  return lerp4((float)__ldg(row0), (float)__ldg(row0 + 1),
               (float)__ldg(row1), (float)__ldg(row1 + 1), s.wx, s.wy);
}

// (x, y) is the sample's floor cell relative to the window's origin.
template <typename T>
__device__ __forceinline__ float sample_window(const T* window, int pitch,
                                               int x, int y, const Sample& s) {
  const T* t = window + y * pitch + x;
  return lerp4((float)t[0], (float)t[1], (float)t[pitch],
               (float)t[pitch + 1], s.wx, s.wy);
}

// ---- the box of a block's valid samples -------------------------------------

struct Box {
  int xmin, xmax, ymin, ymax;  // floor cells; xmin > xmax: no valid sample
};

__device__ __forceinline__ void box_add(Box& b, const Sample& s) {
  if (s.valid) {
    b.xmin = min(b.xmin, s.x0);
    b.xmax = max(b.xmax, s.x0);
    b.ymin = min(b.ymin, s.y0);
    b.ymax = max(b.ymax, s.y0);
  }
}

// The whole block's box, the same in every thread.  Holds the block's one
// __syncthreads(): every thread of the block must call it.
__device__ __forceinline__ Box block_box(Box b, int (*scratch)[kMaxWarps]) {
  b.xmin = __reduce_min_sync(0xffffffffu, b.xmin);
  b.xmax = __reduce_max_sync(0xffffffffu, b.xmax);
  b.ymin = __reduce_min_sync(0xffffffffu, b.ymin);
  b.ymax = __reduce_max_sync(0xffffffffu, b.ymax);
  if ((threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    scratch[0][w] = b.xmin;
    scratch[1][w] = b.xmax;
    scratch[2][w] = b.ymin;
    scratch[3][w] = b.ymax;
  }
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  for (int w = 0; w < n_warps; ++w) {
    b.xmin = min(b.xmin, scratch[0][w]);
    b.xmax = max(b.xmax, scratch[1][w]);
    b.ymin = min(b.ymin, scratch[2][w]);
    b.ymax = max(b.ymax, scratch[3][w]);
  }
  return b;
}

// ---- asynchronous staging ---------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Rows [ymin, ymin + rows) x 16-byte chunks [0, chunks) from column x_start
// (a multiple of 16 bytes) into the window, kWinCols elements per row.  The
// block's threads form groups of the next power of two above `chunks`; a
// group copies one row per pass.  Ends with the copies landed for this
// thread; the caller's __syncthreads() makes them the block's.
template <typename T>
__device__ __forceinline__ void stage_cp_async(T* window, const T* image,
                                               int width, int x_start,
                                               int ymin, int rows,
                                               int chunks) {
  constexpr int kChunk = 16 / (int)sizeof(T);
  const int log2_group = 32 - __clz(chunks - 1);  // __clz(0) == 32
  const int c = threadIdx.x & ((1 << log2_group) - 1);
  const int rows_per_pass = blockDim.x >> log2_group;
  if (c < chunks) {
    const T* src = image + (int64_t)ymin * width + x_start + c * kChunk;
    const uint32_t dst = smem_addr(window) + (uint32_t)c * 16u;
    for (int r = threadIdx.x >> log2_group; r < rows; r += rows_per_pass) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       dst + (uint32_t)(r * kWinCols * (int)sizeof(T))),
                   "l"(src + (int64_t)r * width)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---- the tiled kernel -------------------------------------------------------

struct TileArgs {
  int crop_h, crop_w;  // output pixels of one crop
  int tiles_x, tiles;  // tiles along x, tiles per crop
  int log2_tx;         // threads along x: 1 << log2_tx; the rest along y
  int height, width;   // one source image
};

// src_idx == nullptr: crop n samples image n (the single-image warp);
// otherwise crop n samples image src_idx[n] (the pool warp).
template <typename T, bool VEC, bool STAGED>
__device__ __forceinline__ void warp_tile(const T* __restrict__ images,
                                          const float2* __restrict__ coords,
                                          const int32_t* __restrict__ src_idx,
                                          float* __restrict__ out,
                                          const TileArgs& a) {
  const unsigned crop = blockIdx.x / (unsigned)a.tiles;
  const int tile = (int)(blockIdx.x - crop * (unsigned)a.tiles);
  const int tile_y = tile / a.tiles_x;
  const int tile_x = tile - tile_y * a.tiles_x;
  const int y = tile_y * (int)(blockDim.x >> a.log2_tx) +
                (int)(threadIdx.x >> a.log2_tx);
  const int x = ((tile_x << a.log2_tx) +
                 (int)(threadIdx.x & ((1u << a.log2_tx) - 1u))) * kPix;
  // Pixels of this thread inside the crop: 0 past its edges.  The thread
  // stays either way (the barrier below).
  const int live = (y < a.crop_h && x < a.crop_w) ? min(kPix, a.crop_w - x) : 0;
  const int64_t first = ((int64_t)crop * a.crop_h + y) * a.crop_w + x;

  Sample s[kPix];
#pragma unroll
  for (int j = 0; j < kPix; ++j) s[j] = Sample{false, 0, 0, 0.f, 0.f};
  if constexpr (VEC) {  // crop_w % kPix == 0: live is 0 or kPix
    if (live) {
      const float4* c4 = reinterpret_cast<const float4*>(coords + first);
      const float4 c01 = __ldcs(c4);
      const float4 c23 = __ldcs(c4 + 1);
      s[0] = prepare(make_float2(c01.x, c01.y), a.height, a.width);
      s[1] = prepare(make_float2(c01.z, c01.w), a.height, a.width);
      s[2] = prepare(make_float2(c23.x, c23.y), a.height, a.width);
      s[3] = prepare(make_float2(c23.z, c23.w), a.height, a.width);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (j < live) s[j] = prepare(__ldg(coords + first + j), a.height, a.width);
    }
  }

  const int64_t src = src_idx ? (int64_t)__ldg(src_idx + crop) : (int64_t)crop;
  const T* image = images + src * a.height * a.width;
  float v[kPix] = {0.f, 0.f, 0.f, 0.f};

  if constexpr (!STAGED) {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (s[j].valid) v[j] = sample_global(image, a.width, s[j]);
    }
  } else {
    extern __shared__ __align__(128) unsigned char window_bytes[];
    __shared__ int scratch[4][kMaxWarps];
    T* window = reinterpret_cast<T*>(window_bytes);

    Box b = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
#pragma unroll
    for (int j = 0; j < kPix; ++j) box_add(b, s[j]);
    b = block_box(b, scratch);

    // From here on every condition but `valid` is the same for the whole
    // block.  The box holds the floor cells and their +1 taps: x0 <= W-2,
    // so column x0+1 exists even for a coordinate in (W-2, W-1).
    bool staged = false;
    // A row's copy starts on a 16-byte boundary at or before xmin.  W is a
    // multiple of the chunk, so the chunk that holds column
    // xmax + 1 <= W - 1 ends inside the row.
    constexpr int kChunk = 16 / (int)sizeof(T);
    const int x_start = b.xmin & ~(kChunk - 1);
    if (b.xmin <= b.xmax) {
      const int rows = b.ymax - b.ymin + 2;
      const int chunks = (b.xmax + 1 - x_start) / kChunk + 1;
      if (rows <= kWinRows && chunks * kChunk <= kWinCols) {
        stage_cp_async(window, image, a.width, x_start, b.ymin, rows, chunks);
        __syncthreads();
        staged = true;
      }
    }
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (s[j].valid) {
        v[j] = staged ? sample_window(window, kWinCols, s[j].x0 - x_start,
                                      s[j].y0 - b.ymin, s[j])
                      : sample_global(image, a.width, s[j]);
      }
    }
  }

  if constexpr (VEC) {
    if (live) {
      __stcs(reinterpret_cast<float4*>(out + first),
             make_float4(v[0], v[1], v[2], v[3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPix; ++j) {
      if (j < live) out[first + j] = v[j];
    }
  }
}

// Blocks of kMaxThreads that must fit an SM.  The staged form runs in
// phases (coordinates, reduction, copy, taps) with the block waiting between
// them, so it wants every thread the SM can hold: 8 blocks cap it at 32
// registers, which it meets without spilling on uint8 images.  Left to
// itself the compiler gives it 49, the SM then holds 1280 threads, and it
// loses clearly to the unstaged form.  That one keeps the 40 registers it
// asks for (capped at 32 it spills and is slower).
constexpr int min_blocks(bool staged) { return staged ? 8 : 1; }

// Tag names the kernel in a profile: each source instantiates its own.
template <typename Tag, typename T, bool VEC, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads, min_blocks(STAGED))
tile_kernel(const T* __restrict__ images, const float2* __restrict__ coords,
            const int32_t* __restrict__ src_idx, float* __restrict__ out,
            const TileArgs a) {
  warp_tile<T, VEC, STAGED>(images, coords, src_idx, out, a);
}

// ---- host side --------------------------------------------------------------

// What a launch of the tiled kernel takes, as the C interfaces carry it.
struct TileLaunch {
  const void* images;   // [n_images, height, width]
  const void* coords;   // [n_crops, crop_h, crop_w, 2] f32
  const void* src_idx;  // [n_crops] i32, or null: crop n samples image n
  void* out;            // [n_crops, crop_h, crop_w] f32
  long long n_crops;
  int crop_h, crop_w, height, width;
  int vector;   // 1: 16-byte coordinate loads and output stores
  int threads;  // 64, 128 or 256
  int log2_tx;  // threads along x = 1 << log2_tx
  void* stream;
};

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Checks the launch against what the chosen instantiation needs (a wrong
// choice is refused, never repaired) and launches.  Returns a cudaError_t.
template <typename Tag, typename T, bool STAGED>
int launch_tiles(const TileLaunch& l) {
  if (l.n_crops <= 0 || l.crop_h <= 0 || l.crop_w <= 0) {
    return (int)cudaGetLastError();
  }
  const bool threads_ok = l.threads == 64 || l.threads == 128 || l.threads == 256;
  if (!threads_ok || l.log2_tx < 0 || (1 << l.log2_tx) > l.threads) {
    return (int)cudaErrorInvalidValue;
  }
  if (l.vector && (l.crop_w % kPix || !aligned16(l.coords) || !aligned16(l.out))) {
    return (int)cudaErrorInvalidValue;
  }
  if (STAGED && (!aligned16(l.images) || ((size_t)l.width * sizeof(T)) % 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tile_h = l.threads >> l.log2_tx;
  const long long tile_w = (long long)kPix << l.log2_tx;
  const long long tiles_x = (l.crop_w + tile_w - 1) / tile_w;
  const long long tiles = tiles_x * ((l.crop_h + tile_h - 1) / tile_h);
  if (tiles > INT_MAX || l.n_crops * tiles > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const TileArgs args = {l.crop_h, l.crop_w, (int)tiles_x, (int)tiles,
                         l.log2_tx, l.height,  l.width};

  using Kernel = void (*)(const T*, const float2*, const int32_t*, float*,
                          const TileArgs);
  const Kernel kernel = l.vector ? tile_kernel<Tag, T, true, STAGED>
                                 : tile_kernel<Tag, T, false, STAGED>;
  const size_t window = STAGED ? (size_t)kWinRows * kWinCols * sizeof(T) : 0;
  if (window + 256 > 48 * 1024) {
    // more than the 48 KB a block gets without asking (the static part, the
    // reduction scratch, is under 256 bytes); asked once per device for both
    // forms, at the first launch, so that no later launch (one that a CUDA
    // graph captures) makes the call
    static std::atomic<unsigned long long> raised{0};  // one bit per device
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return (int)e;
    if (device >= 64) return (int)cudaErrorInvalidDevice;
    const unsigned long long bit = 1ull << device;
    if (!(raised.load() & bit)) {
      const Kernel forms[2] = {tile_kernel<Tag, T, true, STAGED>,
                               tile_kernel<Tag, T, false, STAGED>};
      for (const Kernel k : forms) {
        e = cudaFuncSetAttribute((const void*)k,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)window);
        if (e != cudaSuccess) return (int)e;
      }
      raised.fetch_or(bit);
    }
  }
  kernel<<<(unsigned)(l.n_crops * tiles), l.threads, window,
           (cudaStream_t)l.stream>>>(
      (const T*)l.images, (const float2*)l.coords, (const int32_t*)l.src_idx,
      (float*)l.out, args);
  return (int)cudaGetLastError();
}

}  // namespace warp
