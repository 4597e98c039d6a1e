// Image-pool bilinear warp for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel `pallas_bilinear_sample_pool` / `_warp_kernel_pool`
// in umetrack_tpu/ops/pallas_resample.py (body :243-295, wrapper :298-419).
// Same function: out[k, p] = bilinear sample of pool[src_idx[k]] at
// coords[k, p] = (x, y), with f32 lerp weights; a sample is valid only if
// x >= 0, x < W-1, y >= 0 and y < H-1 and is 0 otherwise (NaN is invalid).
// Coordinates are clamped to [0, W-2] x [0, H-2] before the floor, exactly
// as `_sample_prep` does, so the weights follow the clamped value.  The
// taps are read in place from the uint8 (or f32) pool: no per-warp image
// copy and no transpose/pad pass over the pool, which the TPU form needed
// only to feed its one-hot matmuls.  The image offset src * H * W is taken
// in 64 bits (M * H * W passes 2^31 at 128 sequences x 16 frames x 4
// cameras of 480 x 640).
//
// Bound on the H100 (3.35 TB/s, ~17 f32 operations per sample): bytes.
// Each pixel reads 8 B of coordinates and writes 4 B of output, plus the
// source bytes its taps touch; at the tracker's bench shape (4096 warps of
// 96 x 96) that is 302 MB + 151 MB of streaming against 53 MB of taps, so
// the kernel is a streaming pass with a gather beside it.
//
// Design: the unstaged form of the tiled kernel of warp_common.cuh with the
// warp's pool index read once per block.  2-D tiles keep a block's taps in
// a compact source footprint, each thread moves four pixels with 16-byte
// streaming loads and stores that leave L1 to the taps, and the lerp is the
// explicitly rounded `lerp4`, so the result equals the plain PyTorch version
// and the single-image kernels bit for bit.  A source window staged in
// shared memory was built and timed too and did not beat the taps read in
// place (PERF.md), so this source does not instantiate it.  Vector or
// scalar I/O and the tile's shape are the caller's choice by rules on the
// shape (ops/_tiles.py); the launcher refuses a choice the arguments do not
// allow.

#include "warp_common.cuh"

struct warp_pool_kernel {};  // names the instantiations in a profile

// The header's constants by index (warp::constant), for the wrapper's check
// at load.
extern "C" int warp_pool_constant(int which) { return warp::constant(which); }

// pool_is_float: 0 for a uint8 pool, 1 for float32.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int warp_pool_launch(const void* pool, int pool_is_float,
                                const void* coords, const void* src_idx,
                                void* out, long long n_warps, int crop_h,
                                int crop_w, int height, int width, int vector,
                                int threads, int log2_tx, void* stream) {
  const warp::TileLaunch l = {pool,   coords, src_idx, out,     n_warps,
                              crop_h, crop_w, height,  width,   vector,
                              threads, log2_tx, stream};
  return pool_is_float
             ? warp::launch_tiles<warp_pool_kernel, float, false>(l)
             : warp::launch_tiles<warp_pool_kernel, uint8_t, false>(l);
}
