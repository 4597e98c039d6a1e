// One pass from an eval-mode BatchNorm's input to the next convolution's
// input, for Hopper (sm_90a), plain C interface for ctypes:
//
//   out = ReLU(BN(x [+ conv_bias]) [+ residual | + BN_r(residual)])
//   out = maxpool_2x2/2(ReLU(BN(x [+ conv_bias])))             (pool form)
//
// on tensors of float32 or bfloat16 in one of two layouts: NCHW, whose
// samples are contiguous [C, H, W] blocks, or NHWC (PyTorch's channels_last),
// whose pixels each hold their C channels side by side at a fixed distance
// from the next pixel (in either, a slice of channels of a larger tensor is
// one); BN being the running statistics' normalisation,
// out[n, c] = x[n, c] * s[c] + t[c] with s = weight / sqrt(var + eps) and
// t = bias - mean * s.  The output is dense in the input's layout.
//
// Replaces no TPU kernel: the JAX package leaves BatchNorm, the residual
// add, ReLU and the max-pool to XLA, which fuses them into the convolutions'
// neighbours on the TPU.  Without this pass the port ran each of them (and
// a convolution's bias add) as its own PyTorch or cuDNN kernel, each a full
// read and write of an activation.
//
// Bound on the H100: bytes.  A form does 2-8 f32 operations per element and
// moves 8-12 bytes per f32 element (x, residual, out), far below the ~20
// operations per byte the card's f32 rate would need to be the limit.  The
// least traffic is one read of each operand and one write of the result,
// which is what this pass moves: BN's scale and shift are computed in f32
// from the running statistics here (4 floats a channel, read through L1),
// so no extra launch and no folded copy of the weights is needed; the pool
// form reduces its 2x2 windows in registers and stores only the pooled
// quarter.
//
// Design: one thread per 16 bytes of output (4 floats or 8 bfloat16), with
// 16-byte loads and stores; threads run over the flattened [N, C*H*W]
// elements (pool form: [N, C*H/2*W/2] outputs), so a block spans several
// (n, c) planes where the planes are small (6 x 6, 12 x 12) and the card
// fills whatever the plane size.  A thread finds its channel by one
// division, and steps to the next channel inside its vector where a plane
// ends there.  Shapes whose rows or samples do not split into 16-byte
// vectors, or unaligned pointers, take the same code one element per
// thread (the caller's choice, checked by the launcher).
//
// NHWC: the same 16 bytes a vector, along the channels of one pixel (C and
// the pixel strides must split into vectors), so a vector's V elements are
// V channels, whose constants would cost V square roots and divisions for
// every vector.  Instead each block computes the constants of the C
// channels once into shared memory (a thread a channel, while its own
// loads are in flight), and every thread reads its V from there, 16 bytes
// at a time; a float32 thread moves two vectors, loaded together.  The
// pool form reads the four pixels of its 2 x 2 window as four vectors of
// the same channels and stores one.
//
// Rounding follows the PyTorch ops it replaces (ops/bn_act.py's
// batch_norm_act_plain): the conv bias is added in the compute dtype, BN is
// computed in f32 and rounded once to the compute dtype, the residual (BN'd
// and rounded, for the downsample branch) is added in the compute dtype,
// ReLU keeps NaN, and the max-pool propagates NaN.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace bn_act {

constexpr int kThreads = 256;

// An element type: its storage and its float conversions.
struct F32 {
  using S = float;
  static __device__ __forceinline__ float get(S v) { return v; }
  static __device__ __forceinline__ S put(float v) { return v; }
};
struct BF16 {
  using S = unsigned short;
  static __device__ __forceinline__ float get(S v) {
    return __uint_as_float(static_cast<unsigned>(v) << 16);
  }
  static __device__ __forceinline__ S put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// v rounded to the element type and back (a no-op for float32).
template <class E>
__device__ __forceinline__ float rounded(float v) {
  return E::get(E::put(v));
}

struct Norm {
  const float* mean;
  const float* var;
  const float* weight;
  const float* bias;
  float eps;
};

struct Args {
  const void* x;
  void* out;
  const void* residual;    // null: no residual
  const float* conv_bias;  // null: no conv bias
  Norm norm, rnorm;        // rnorm.mean null: the residual is added as it is
  unsigned threads;        // threads with work: n * per_sample
  unsigned per_sample;     // vectors of output per sample
  long long x_stride;      // elements from one sample of x to the next
  long long r_stride;      // the same for the residual
  long long x_pixel;       // NHWC: elements from one pixel of x to the next
  long long r_pixel;       // the same for the residual
  int c, h, w;
};

struct Affine {
  float scale, shift;
};

__device__ __forceinline__ Affine affine(const Norm& n, int c) {
  const float scale = __ldg(n.weight + c) * (1.0f / sqrtf(__ldg(n.var + c) + n.eps));
  return {scale, __ldg(n.bias + c) - __ldg(n.mean + c) * scale};
}

// The channel's constants: BN's, the residual BN's and the conv bias (in
// the element type).
template <class E, int RES>
struct Channel {
  Affine bn, rbn;
  float bias;
  __device__ __forceinline__ void load(const Args& a, int c) {
    bn = affine(a.norm, c);
    if (RES == 2) rbn = affine(a.rnorm, c);
    bias = a.conv_bias ? rounded<E>(__ldg(a.conv_bias + c)) : 0.0f;
  }
  // BN(x [+ bias]) rounded, with the residual r added and ReLU applied.
  __device__ __forceinline__ float apply(const Args& a, float x, float r) const {
    if (a.conv_bias) x = rounded<E>(x + bias);
    float y = rounded<E>(__fmaf_rn(x, bn.scale, bn.shift));
    if (RES == 1) y = rounded<E>(y + r);
    if (RES == 2) y = rounded<E>(y + rounded<E>(__fmaf_rn(r, rbn.scale, rbn.shift)));
    return y <= 0.0f ? 0.0f : y;  // F.relu: NaN stays NaN
  }
};

// V elements of S, moved as one 16-byte load or store when they fill one.
template <class S, int V>
struct Pack {
  S v[V];
};

template <class S, int V>
__device__ __forceinline__ Pack<S, V> load(const S* p) {
  Pack<S, V> r;
  if constexpr (sizeof(S) * V == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) r.v[j] = p[j];
  }
  return r;
}

template <class S, int V>
__device__ __forceinline__ void store(S* p, const Pack<S, V>& r) {
  if constexpr (sizeof(S) * V == 16) {
    uint4 u;
    memcpy(&u, &r, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = r.v[j];
  }
}

// RES: 0 none, 1 the residual as it is, 2 BN_r(residual).  V: elements a
// thread moves (16 bytes' worth, or 1).
template <class E, int RES, int V>
__global__ void __launch_bounds__(kThreads) batch_norm_act_kernel(const Args a) {
  using S = typename E::S;
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= a.threads) return;
  const int hw = a.h * a.w;
  const unsigned n = g / a.per_sample;
  const int r0 = static_cast<int>(g - n * a.per_sample) * V;
  int c = r0 / hw, o = r0 - c * hw;

  const Pack<S, V> in = load<S, V>(static_cast<const S*>(a.x) + n * a.x_stride + r0);
  Pack<S, V> res{};
  if (RES) res = load<S, V>(static_cast<const S*>(a.residual) + n * a.r_stride + r0);
  Channel<E, RES> ch;
  ch.load(a, c);
  Pack<S, V> out;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (o == hw) {  // the vector crosses into the next plane
      o = 0;
      c = c + 1 == a.c ? 0 : c + 1;
      ch.load(a, c);
    }
    out.v[j] = E::put(ch.apply(a, E::get(in.v[j]), RES ? E::get(res.v[j]) : 0.0f));
    ++o;
  }
  store<S, V>(static_cast<S*>(a.out) + static_cast<size_t>(n) * a.c * hw + r0, out);
}

__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || v != v) ? v : m;  // F.max_pool2d: NaN propagates
}

// The pool form: V outputs of one output row per thread (V = 16 bytes'
// worth needs W % (2 V) == 0), each the max of a 2 x 2
// window of ReLU(BN(x + bias)); odd last rows and columns are dropped, as
// F.max_pool2d(2, 2) drops them.
template <class E, int V>
__global__ void __launch_bounds__(kThreads) batch_norm_act_pool_kernel(const Args a) {
  using S = typename E::S;
  const unsigned g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= a.threads) return;
  const int ho_n = a.h / 2, wo_n = a.w / 2, plane = ho_n * wo_n;
  const unsigned n = g / a.per_sample;
  const int r0 = static_cast<int>(g - n * a.per_sample) * V;
  const int c = r0 / plane, q = r0 - c * plane;
  const int ho = q / wo_n, wo = q - ho * wo_n;

  const S* row0 = static_cast<const S*>(a.x) + n * a.x_stride +
                  (static_cast<size_t>(c) * a.h + 2 * ho) * a.w + 2 * wo;
  const S* row1 = row0 + a.w;
  const Pack<S, V> t0 = load<S, V>(row0), t1 = load<S, V>(row0 + V);
  const Pack<S, V> b0 = load<S, V>(row1), b1 = load<S, V>(row1 + V);
  Channel<E, 0> ch;
  ch.load(a, c);
  Pack<S, V> out;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    // window j covers elements 2j and 2j + 1 of the 2V loaded per row
    const S x00 = 2 * j < V ? t0.v[2 * j] : t1.v[2 * j - V];
    const S x01 = 2 * j + 1 < V ? t0.v[2 * j + 1] : t1.v[2 * j + 1 - V];
    const S x10 = 2 * j < V ? b0.v[2 * j] : b1.v[2 * j - V];
    const S x11 = 2 * j + 1 < V ? b0.v[2 * j + 1] : b1.v[2 * j + 1 - V];
    float m = ch.apply(a, E::get(x00), 0.0f);
    m = max_nan(m, ch.apply(a, E::get(x01), 0.0f));
    m = max_nan(m, ch.apply(a, E::get(x10), 0.0f));
    m = max_nan(m, ch.apply(a, E::get(x11), 0.0f));
    out.v[j] = E::put(m);
  }
  store<S, V>(static_cast<S*>(a.out) + (static_cast<size_t>(n) * a.c + c) * plane + q, out);
}

// ---- NHWC ------------------------------------------------------------------

constexpr int kMaxChannels = 2048;  // 5 arrays of C floats in 40 KiB of shared memory

// A vector's place in an NHWC output: sample n, output pixel p of the
// sample, and for the pool form p's row and column.
struct Cursor {
  int n, p, ho, wo;
};

// The place of vector g (of V elements) of the launch.
template <int V, bool POOL>
__device__ __forceinline__ Cursor place(const Args& a, unsigned g, int& c0) {
  Cursor k;
  k.n = static_cast<int>(g / a.per_sample);
  const int r0 = static_cast<int>(g - static_cast<unsigned>(k.n) * a.per_sample) * V;  // in [pixels, C]
  k.p = r0 / a.c;
  c0 = r0 - k.p * a.c;
  if (POOL) {
    const int wo_n = a.w / 2;
    k.ho = k.p / wo_n;
    k.wo = k.p - k.ho * wo_n;
  }
  return k;
}

// The block's per-channel constants in shared memory: [BN scale | BN shift |
// residual BN scale | residual BN shift | conv bias], C floats each, the
// same numbers Channel::load computes.
template <class E, int RES>
__device__ __forceinline__ void load_channels(const Args& a, float* s) {
  for (int c = threadIdx.x; c < a.c; c += kThreads) {
    const Affine bn = affine(a.norm, c);
    s[c] = bn.scale;
    s[a.c + c] = bn.shift;
    if (RES == 2) {
      const Affine r = affine(a.rnorm, c);
      s[2 * a.c + c] = r.scale;
      s[3 * a.c + c] = r.shift;
    }
    if (a.conv_bias) s[4 * a.c + c] = rounded<E>(__ldg(a.conv_bias + c));
  }
  __syncthreads();
}

// V consecutive floats of shared memory from p, 16 bytes at a time where V
// allows (p is then 16-byte aligned: C and the channel are multiples of V).
template <int V>
__device__ __forceinline__ void read_shared(const float* p, float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 f = reinterpret_cast<const float4*>(p)[k];
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = p[j];
  }
}

// The constants of channels c0 .. c0 + V - 1, from shared memory.
template <class E, int RES, int V>
struct Channels {
  Channel<E, RES> ch[V];
  __device__ __forceinline__ Channels(const Args& a, const float* s, int c0) {
    float scale[V], shift[V], rscale[V], rshift[V], bias[V];
    read_shared<V>(s + c0, scale);
    read_shared<V>(s + a.c + c0, shift);
    if (RES == 2) {
      read_shared<V>(s + 2 * a.c + c0, rscale);
      read_shared<V>(s + 3 * a.c + c0, rshift);
    }
    if (a.conv_bias) read_shared<V>(s + 4 * a.c + c0, bias);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      ch[j].bn = {scale[j], shift[j]};
      if (RES == 2) ch[j].rbn = {rscale[j], rshift[j]};
      ch[j].bias = a.conv_bias ? bias[j] : 0.0f;
    }
  }
};

// One vector of V channels of one output pixel: its operands, loaded, then
// the result, computed and stored.
template <class E, int RES, int V, bool POOL>
struct NhwcItem {
  using S = typename E::S;
  Pack<S, V> in[POOL ? 4 : 1], res;

  __device__ __forceinline__ void load_operands(const Args& a, const Cursor& k, int c0) {
    const S* x = static_cast<const S*>(a.x) + k.n * a.x_stride + c0;
    if constexpr (POOL) {
      const S* p = x + static_cast<long long>(2 * k.ho * a.w + 2 * k.wo) * a.x_pixel;
      in[0] = load<S, V>(p);
      in[1] = load<S, V>(p + a.x_pixel);
      in[2] = load<S, V>(p + a.w * a.x_pixel);
      in[3] = load<S, V>(p + (a.w + 1) * a.x_pixel);
    } else {
      in[0] = load<S, V>(x + k.p * a.x_pixel);
      if (RES) {
        res = load<S, V>(static_cast<const S*>(a.residual) + k.n * a.r_stride + k.p * a.r_pixel + c0);
      }
    }
  }

  __device__ __forceinline__ void store_result(const Args& a, const Cursor& k, int c0,
                                               const Channel<E, RES> (&ch)[V]) const {
    Pack<S, V> out;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if constexpr (POOL) {  // F.max_pool2d's order: (0, 0), (0, 1), (1, 0), (1, 1)
        float m = ch[j].apply(a, E::get(in[0].v[j]), 0.0f);
#pragma unroll
        for (int t = 1; t < 4; ++t) m = max_nan(m, ch[j].apply(a, E::get(in[t].v[j]), 0.0f));
        out.v[j] = E::put(m);
      } else {
        out.v[j] = E::put(ch[j].apply(a, E::get(in[0].v[j]), RES ? E::get(res.v[j]) : 0.0f));
      }
    }
    store<S, V>(static_cast<S*>(a.out) + (static_cast<size_t>(k.n) * a.per_sample * V +
                                          static_cast<size_t>(k.p) * a.c + c0), out);
  }
};

// Vectors a thread of the NHWC kernel moves: two float32 ones, one of
// bfloat16, whose eight channels' constants fill the registers a second
// would need.
template <class E>
constexpr int kItems = sizeof(typename E::S) == 4 ? 2 : 1;

// RES and V as in batch_norm_act_kernel; POOL: the pool form.  A block
// moves kItems x kThreads vectors, each V channels of one pixel, a
// thread's kThreads apart, all loaded before the block's constants are
// computed.
template <class E, int RES, int V, bool POOL>
__global__ void __launch_bounds__(kThreads) batch_norm_act_nhwc_kernel(const Args a) {
  extern __shared__ float consts[];
  constexpr int I = kItems<E>;
  bool live[I];
  int c0[I];
  Cursor k[I];
  NhwcItem<E, RES, V, POOL> item[I];
#pragma unroll
  for (int i = 0; i < I; ++i) {
    const unsigned g = (blockIdx.x * I + i) * kThreads + threadIdx.x;
    live[i] = g < a.threads;  // every thread reaches load_channels' barrier
    if (live[i]) {
      k[i] = place<V, POOL>(a, g, c0[i]);
      item[i].load_operands(a, k[i], c0[i]);
    }
  }
  load_channels<E, RES>(a, consts);
#pragma unroll
  for (int i = 0; i < I; ++i) {
    if (live[i]) item[i].store_result(a, k[i], c0[i], Channels<E, RES, V>(a, consts, c0[i]).ch);
  }
}

template <class E, int V>
cudaError_t launch_nhwc_form(const Args& a, int res, int pool, cudaStream_t stream) {
  const unsigned per_block = kItems<E> * kThreads;
  const unsigned blocks = (a.threads + per_block - 1) / per_block;
  const size_t shared = 5 * static_cast<size_t>(a.c) * sizeof(float);
  if (pool) {
    batch_norm_act_nhwc_kernel<E, 0, V, true><<<blocks, kThreads, shared, stream>>>(a);
  } else if (res == 0) {
    batch_norm_act_nhwc_kernel<E, 0, V, false><<<blocks, kThreads, shared, stream>>>(a);
  } else if (res == 1) {
    batch_norm_act_nhwc_kernel<E, 1, V, false><<<blocks, kThreads, shared, stream>>>(a);
  } else {
    batch_norm_act_nhwc_kernel<E, 2, V, false><<<blocks, kThreads, shared, stream>>>(a);
  }
  return cudaGetLastError();
}

// ---- launch ----------------------------------------------------------------

template <class E, int V>
cudaError_t launch_form(const Args& a, int res, int pool, cudaStream_t stream) {
  const unsigned blocks = (a.threads + kThreads - 1) / kThreads;
  if (pool) {
    batch_norm_act_pool_kernel<E, V><<<blocks, kThreads, 0, stream>>>(a);
  } else if (res == 0) {
    batch_norm_act_kernel<E, 0, V><<<blocks, kThreads, 0, stream>>>(a);
  } else if (res == 1) {
    batch_norm_act_kernel<E, 1, V><<<blocks, kThreads, 0, stream>>>(a);
  } else {
    batch_norm_act_kernel<E, 2, V><<<blocks, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <class E>
cudaError_t launch_type(const Args& a, int res, int pool, int nhwc, int vector, cudaStream_t stream) {
  constexpr int kVector = 16 / sizeof(typename E::S);
  if (nhwc) {
    return vector ? launch_nhwc_form<E, kVector>(a, res, pool, stream)
                  : launch_nhwc_form<E, 1>(a, res, pool, stream);
  }
  return vector ? launch_form<E, kVector>(a, res, pool, stream)
                : launch_form<E, 1>(a, res, pool, stream);
}

}  // namespace bn_act

// x, out (and residual) [n, c, h, w] of float32 (bf16 == 0) or bfloat16.
// nhwc == 0: each sample of x (of the residual) a contiguous [c, h, w]
// block, x_stride (r_stride) elements after the last, out contiguous.
// nhwc == 1: each pixel's c channels adjacent, x_pixel (r_pixel) elements
// after the last pixel's in row-major order, each sample x_stride
// (r_stride) elements after the last, out a dense channels_last tensor.
// out [n, c, h / 2, w / 2] with pool.  The statistics, weights and conv
// bias are float32 [c].  residual null: none; r_mean null: the residual is
// added as it is.  vector: 16-byte vectors (the wrapper checks that shapes
// and pointers allow them).  Returns cudaGetLastError() after the launch
// (0 on success); 1 for arguments out of range.
extern "C" int bn_act_launch(const void* x, void* out, const void* residual,
                             const float* conv_bias, const float* mean,
                             const float* var, const float* weight,
                             const float* bias, float eps, const float* r_mean,
                             const float* r_var, const float* r_weight,
                             const float* r_bias, float r_eps, long long n,
                             int c, int h, int w, long long x_stride,
                             long long r_stride, long long x_pixel,
                             long long r_pixel, int nhwc, int bf16, int pool,
                             int vector, void* stream) {
  const int v = vector ? 16 / (bf16 ? 2 : 4) : 1;
  const long long outputs = pool ? static_cast<long long>(c) * (h / 2) * (w / 2)
                                 : static_cast<long long>(c) * h * w;
  if (n < 1 || outputs < 1 || outputs > INT32_MAX || outputs % v != 0 ||
      n * (outputs / v) > INT32_MAX) {
    return 1;
  }
  if (pool && (residual || h < 2 || w < 2)) return 1;
  if (x_stride % v != 0 || r_stride % v != 0) return 1;
  if (nhwc) {
    if (c > bn_act::kMaxChannels || c % v != 0 || x_pixel % v != 0 || r_pixel % v != 0) return 1;
  } else if (pool && vector && w % (2 * v) != 0) {
    return 1;
  }
  bn_act::Args a;
  a.x = x;
  a.out = out;
  a.residual = residual;
  a.conv_bias = conv_bias;
  a.norm = {mean, var, weight, bias, eps};
  a.rnorm = {r_mean, r_var, r_weight, r_bias, r_eps};
  a.per_sample = static_cast<unsigned>(outputs / v);
  a.threads = static_cast<unsigned>(n * (outputs / v));
  a.x_stride = x_stride;
  a.r_stride = r_stride;
  a.x_pixel = x_pixel;
  a.r_pixel = r_pixel;
  a.c = c;
  a.h = h;
  a.w = w;
  const int res = residual == nullptr ? 0 : (r_mean == nullptr ? 1 : 2);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? bn_act::launch_type<bn_act::BF16>(a, res, pool, nhwc, vector, s)
              : bn_act::launch_type<bn_act::F32>(a, res, pool, nhwc, vector, s);
}
