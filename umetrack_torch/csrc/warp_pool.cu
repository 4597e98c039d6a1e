// Image-pool bilinear warp for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `pallas_bilinear_sample_pool` / `_warp_kernel_pool`
// in umetrack_tpu/ops/pallas_resample.py (body :243-295, wrapper :298-419).
// Same function: out[k, p] = bilinear sample of pool[src_idx[k]] at
// coords[k, p] = (x, y), with f32 lerp weights; a sample is valid only if
// x >= 0, x < W-1, y >= 0 and y < H-1 and is 0 otherwise (NaN is invalid).
// Coordinates are clamped to [0, W-2] x [0, H-2] before the floor, exactly
// as `_sample_prep` does, so the weights follow the clamped value.
//
// Design.  One thread per output pixel; the grid is (warp, pixel tile) and
// each block reads its warp's source index itself.  The four uint8 (or f32)
// taps are read in place from the pool: no per-warp image copy and no
// transpose/pad pass over the pool, which the TPU form needed only to feed
// its one-hot matmuls.  The image offset src * H * W is taken in 64 bits
// (M * H * W passes 2^31 at 128 sequences x 16 frames x 4 cameras of
// 480 x 640).
//
// Bound on the H100 (3.35 TB/s, no arithmetic to speak of): bytes.  Each
// pixel reads 8 B of coordinates and writes 4 B of output, plus the source
// bytes its taps touch; at the tracker's bench shape (4096 warps of 96 x 96)
// that is 302 MB + 151 MB + the touched taps, >= 0.14 ms.  The kernel does
// nothing about the taps' locality beyond what L2 gives it: rows of a crop
// map to nearby source rows, so neighbouring threads hit the same lines.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_pool_kernel(const T* __restrict__ pool,
                 const float2* __restrict__ coords,
                 const int32_t* __restrict__ src_idx,
                 float* __restrict__ out,
                 int64_t pixels, int height, int width) {
  const int64_t warp = blockIdx.x;
  const int64_t p = (int64_t)blockIdx.y * kThreads + threadIdx.x;
  if (p >= pixels) return;
  const int64_t i = warp * pixels + p;
  const float2 c = coords[i];
  // Comparisons are false for NaN, so a NaN coordinate is invalid and never
  // reaches the clamp below.
  const bool valid = (c.x >= 0.f) && (c.x < (float)(width - 1)) &&
                     (c.y >= 0.f) && (c.y < (float)(height - 1));
  if (!valid) {
    out[i] = 0.f;
    return;
  }
  const float x = fminf(c.x, (float)(width - 2));
  const float y = fminf(c.y, (float)(height - 2));
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float wx = x - x0f;
  const float wy = y - y0f;
  const int64_t image = (int64_t)src_idx[warp] * height * width;
  const T* row0 = pool + image + (int64_t)y0f * width + (int64_t)x0f;
  const T* row1 = row0 + width;
  const float f00 = (float)__ldg(row0);
  const float f10 = (float)__ldg(row0 + 1);
  const float f01 = (float)__ldg(row1);
  const float f11 = (float)__ldg(row1 + 1);
  out[i] = f00 * (1.f - wx) * (1.f - wy) + f10 * wx * (1.f - wy) +
           f01 * (1.f - wx) * wy + f11 * wx * wy;
}

}  // namespace

// pool_is_float: 0 for a uint8 pool, 1 for float32.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int warp_pool_launch(const void* pool, int pool_is_float,
                                const void* coords, const void* src_idx,
                                void* out, long long n_warps,
                                long long pixels, int height, int width,
                                void* stream) {
  if (n_warps <= 0 || pixels <= 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)n_warps,
                  (unsigned)((pixels + kThreads - 1) / kThreads));
  const cudaStream_t s = (cudaStream_t)stream;
  if (pool_is_float) {
    warp_pool_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)pool, (const float2*)coords, (const int32_t*)src_idx,
        (float*)out, pixels, height, width);
  } else {
    warp_pool_kernel<uint8_t><<<grid, kThreads, 0, s>>>(
        (const uint8_t*)pool, (const float2*)coords, (const int32_t*)src_idx,
        (float*)out, pixels, height, width);
  }
  return (int)cudaGetLastError();
}
