// Single-image bilinear warps for Hopper (sm_90a), plain C interface for
// ctypes: one image (or a batch of N images, each with its own coordinate
// list) sampled at a list of (x, y) source coordinates.
//
// Two kernels replace the two TPU kernels of
// umetrack_tpu/ops/pallas_resample.py that sample ONE image:
//
//   warp_image_full_kernel      <- pallas_bilinear_sample / _warp_kernel
//                                  (body :68-107, wrapper :110-171)
//   warp_image_windowed_kernel  <- pallas_bilinear_sample_windowed /
//                                  _warp_kernel_win (body :174-240,
//                                  wrapper :422-535)
//
// Same function for both: out[n, p] = bilinear sample of image[n] at
// coords[n, p] = (x, y) with f32 lerp weights; a sample is valid only if
// x >= 0, x < W-1, y >= 0 and y < H-1 and is 0 otherwise (NaN is invalid).
// Valid coordinates are clamped to [0, W-2] x [0, H-2] before the floor, as
// `_sample_prep` does, so the weights follow the clamped value.  A float
// image is sampled in f32 exactly (the TPU float path rounded it to bf16).
//
// What carries over from the TPU pair is what tells the two apart, not
// their one-hot matmuls:
//
// * full: no assumption about where samples land.  One thread per sample,
//   the four taps read in place from global memory; the cost does not
//   depend on the coordinates.
// * windowed: uses the spatial coherence of warp grids.  A block takes 256
//   consecutive output pixels, reduces the min/max floor cell of its VALID
//   samples (warp shuffles, then shared memory), and when that box plus the
//   +1 taps fits the kWinRows x kWinCols shared-memory window it loads the
//   box with coalesced row reads and samples from shared memory.  A block
//   whose box does not fit reads its taps from global memory like the full
//   kernel; a block with no valid sample stages nothing.  The branch is
//   uniform per block, and the output is bit-identical either way and to
//   the full kernel: every path ends in the same `lerp4`, written with
//   explicitly rounded operations so that no path is contracted into FMAs
//   differently from another.
//
// Bound on the H100 (3.35 TB/s, ~17 f32 operations per sample): bytes.
// Each pixel reads 8 B of coordinates and writes 4 B of output, plus the
// source bytes its taps touch.  Offsets are 64-bit: N * H * W passes 2^31
// at 6991 images of 480 x 640.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The shared-memory window, in source pixels.  Wide and short: 256
// consecutive pixels of a crop are a few crop rows.  The wrapper states the
// same two numbers and checks them against these when the library loads.
constexpr int kWinRows = 32;
constexpr int kWinCols = 384;

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
// operation rounded on its own and summed left to right.
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

// Grid: blockIdx.x = image * tiles + tile, `tiles` tiles of kThreads pixels
// per image.
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_image_full_kernel(const T* __restrict__ images,
                       const float2* __restrict__ coords,
                       float* __restrict__ out, int64_t pixels,
                       unsigned tiles, int height, int width) {
  const int64_t n = blockIdx.x / tiles;
  const int64_t p = (int64_t)(blockIdx.x % tiles) * kThreads + threadIdx.x;
  if (p >= pixels) return;
  const int64_t i = n * pixels + p;
  const Sample s = prepare(coords[i], height, width);
  float v = 0.f;
  if (s.valid) {
    v = sample_global(images + n * (int64_t)height * width, width, s);
  }
  out[i] = v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_image_windowed_kernel(const T* __restrict__ images,
                           const float2* __restrict__ coords,
                           float* __restrict__ out, int64_t pixels,
                           unsigned tiles, int height, int width) {
  extern __shared__ __align__(16) unsigned char window_bytes[];
  T* window = reinterpret_cast<T*>(window_bytes);
  __shared__ int box[4][kWarps];

  const int64_t n = blockIdx.x / tiles;
  const int64_t p = (int64_t)(blockIdx.x % tiles) * kThreads + threadIdx.x;
  // No thread leaves before the barriers: threads past the end of the list
  // and threads with an invalid sample stay, and stay out of the min/max.
  const bool in_range = p < pixels;
  const int64_t i = n * pixels + p;
  Sample s = {false, 0, 0, 0.f, 0.f};
  if (in_range) s = prepare(coords[i], height, width);

  int xmin = s.valid ? s.x0 : INT_MAX;
  int xmax = s.valid ? s.x0 : INT_MIN;
  int ymin = s.valid ? s.y0 : INT_MAX;
  int ymax = s.valid ? s.y0 : INT_MIN;
  for (int off = 16; off > 0; off >>= 1) {
    xmin = min(xmin, __shfl_xor_sync(0xffffffffu, xmin, off));
    xmax = max(xmax, __shfl_xor_sync(0xffffffffu, xmax, off));
    ymin = min(ymin, __shfl_xor_sync(0xffffffffu, ymin, off));
    ymax = max(ymax, __shfl_xor_sync(0xffffffffu, ymax, off));
  }
  if ((threadIdx.x & 31) == 0) {
    const int w = threadIdx.x >> 5;
    box[0][w] = xmin;
    box[1][w] = xmax;
    box[2][w] = ymin;
    box[3][w] = ymax;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    xmin = min(xmin, box[0][w]);
    xmax = max(xmax, box[1][w]);
    ymin = min(ymin, box[2][w]);
    ymax = max(ymax, box[3][w]);
  }

  // From here on every condition but `s.valid` is the same for the whole
  // block.
  if (xmin > xmax) {  // no valid sample: nothing to stage
    if (in_range) out[i] = 0.f;
    return;
  }
  // The box holds the floor cells and their +1 taps: x0 <= W-2, so column
  // x0+1 exists even for a coordinate in (W-2, W-1).
  const int box_w = xmax - xmin + 2;
  const int box_h = ymax - ymin + 2;
  const T* image = images + n * (int64_t)height * width;
  float v = 0.f;
  if (box_w <= kWinCols && box_h <= kWinRows) {
    const T* src = image + (int64_t)ymin * width + xmin;
    const int count = box_w * box_h;
    for (int e = threadIdx.x; e < count; e += kThreads) {
      const int r = e / box_w;
      const int c = e - r * box_w;
      window[e] = __ldg(src + (int64_t)r * width + c);
    }
    __syncthreads();
    if (s.valid) {
      const T* t = window + (s.y0 - ymin) * box_w + (s.x0 - xmin);
      v = lerp4((float)t[0], (float)t[1], (float)t[box_w],
                (float)t[box_w + 1], s.wx, s.wy);
    }
  } else if (s.valid) {
    v = sample_global(image, width, s);
  }
  if (in_range) out[i] = v;
}

template <typename T>
int launch(bool windowed, const void* images, const void* coords, void* out,
           long long n_images, long long pixels, int height, int width,
           void* stream) {
  if (n_images <= 0 || pixels <= 0) return (int)cudaGetLastError();
  const long long tiles = (pixels + kThreads - 1) / kThreads;
  if (tiles > INT_MAX || n_images * tiles > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)(n_images * tiles);
  const cudaStream_t s = (cudaStream_t)stream;
  if (windowed) {
    const size_t window = (size_t)kWinRows * kWinCols * sizeof(T);
    if (window + sizeof(int) * 4 * kWarps > 48 * 1024) {
      // more than the 48 KB a block gets without asking
      const cudaError_t e = cudaFuncSetAttribute(
          warp_image_windowed_kernel<T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)window);
      if (e != cudaSuccess) return (int)e;
    }
    warp_image_windowed_kernel<T><<<grid, kThreads, window, s>>>(
        (const T*)images, (const float2*)coords, (float*)out, pixels,
        (unsigned)tiles, height, width);
  } else {
    warp_image_full_kernel<T><<<grid, kThreads, 0, s>>>(
        (const T*)images, (const float2*)coords, (float*)out, pixels,
        (unsigned)tiles, height, width);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int warp_image_window_rows() { return kWinRows; }
extern "C" int warp_image_window_cols() { return kWinCols; }

// image_is_float: 0 for uint8 images, 1 for float32.  Both return
// cudaGetLastError() after the launch (0 on success).
extern "C" int warp_image_full_launch(const void* images, int image_is_float,
                                      const void* coords, void* out,
                                      long long n_images, long long pixels,
                                      int height, int width, void* stream) {
  return image_is_float
             ? launch<float>(false, images, coords, out, n_images, pixels,
                             height, width, stream)
             : launch<uint8_t>(false, images, coords, out, n_images, pixels,
                               height, width, stream);
}

extern "C" int warp_image_windowed_launch(const void* images,
                                          int image_is_float,
                                          const void* coords, void* out,
                                          long long n_images,
                                          long long pixels, int height,
                                          int width, void* stream) {
  return image_is_float
             ? launch<float>(true, images, coords, out, n_images, pixels,
                             height, width, stream)
             : launch<uint8_t>(true, images, coords, out, n_images, pixels,
                               height, width, stream);
}
