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
// * full: no assumption about where samples land.  One thread per sample of
//   a flat list, the four taps read in place from global memory; the cost
//   does not depend on the coordinates.
// * windowed: uses the spatial coherence of warp grids.  It is the tiled
//   kernel of warp_common.cuh with crop n sampling image n: a block takes a
//   2-D tile of one coordinate field, reduces the min/max floor cell of its
//   VALID samples, and when that box plus the +1 taps fits the shared-memory
//   window it copies the box there asynchronously (16-byte cp.async
//   chunks) and samples from shared memory.  A block whose box does not fit
//   reads its taps in place like the full kernel; a block with no valid
//   sample stages nothing.  Images that cannot be staged at all (base or
//   row pitch off a 16-byte boundary) take the unstaged form of the same
//   kernel.  The output is bit-identical either way and to the full kernel:
//   every path ends in the same `lerp4`.
//
// Bound on the H100 (3.35 TB/s, ~17 f32 operations per sample): bytes.
// Each pixel reads 8 B of coordinates and writes 4 B of output, plus the
// source bytes its taps touch.  Offsets are 64-bit: N * H * W passes 2^31
// at 6991 images of 480 x 640.

#include "warp_common.cuh"

struct warp_image_windowed_kernel {};  // names the instantiations in a profile

namespace {

using warp::Sample;
using warp::prepare;
using warp::sample_global;

constexpr int kThreads = 256;

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
int launch_full(const void* images, const void* coords, void* out,
                long long n_images, long long pixels, int height, int width,
                void* stream) {
  if (n_images <= 0 || pixels <= 0) return (int)cudaGetLastError();
  const long long tiles = (pixels + kThreads - 1) / kThreads;
  if (tiles > INT_MAX || n_images * tiles > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  warp_image_full_kernel<T>
      <<<(unsigned)(n_images * tiles), kThreads, 0, (cudaStream_t)stream>>>(
          (const T*)images, (const float2*)coords, (float*)out, pixels,
          (unsigned)tiles, height, width);
  return (int)cudaGetLastError();
}

}  // namespace

// The header's constants by index (warp::constant), for the wrapper's check
// at load.
extern "C" int warp_image_constant(int which) { return warp::constant(which); }

// image_is_float: 0 for uint8 images, 1 for float32.  Both launchers return
// cudaGetLastError() after the launch (0 on success).
extern "C" int warp_image_full_launch(const void* images, int image_is_float,
                                      const void* coords, void* out,
                                      long long n_images, long long pixels,
                                      int height, int width, void* stream) {
  return image_is_float ? launch_full<float>(images, coords, out, n_images,
                                             pixels, height, width, stream)
                        : launch_full<uint8_t>(images, coords, out, n_images,
                                               pixels, height, width, stream);
}

// Image n is sampled at the crop_h x crop_w field coords[n].  staged: 1 a
// block copies its box into the shared-memory window when it fits, 0 every
// tap is read in place.
extern "C" int warp_image_windowed_launch(const void* images,
                                          int image_is_float,
                                          const void* coords, void* out,
                                          long long n_images, int crop_h,
                                          int crop_w, int height, int width,
                                          int vector, int staged, int threads,
                                          int log2_tx, void* stream) {
  using Tag = warp_image_windowed_kernel;
  const warp::TileLaunch l = {images, coords, nullptr, out,     n_images,
                              crop_h, crop_w, height,  width,   vector,
                              threads, log2_tx, stream};
  if (image_is_float) {
    return staged ? warp::launch_tiles<Tag, float, true>(l)
                  : warp::launch_tiles<Tag, float, false>(l);
  }
  return staged ? warp::launch_tiles<Tag, uint8_t, true>(l)
                : warp::launch_tiles<Tag, uint8_t, false>(l);
}
