// Max pools over the length axis of 1D signals, forward and gradient, on
// (B, L, C) memory (a (B, C, 1, L) channels_last tensor):
//
// - the 1D pyramid: [maxpool(x, 2**l) for l in 1..levels], window =
//   stride = 2**l along L, VALID floor truncation (level l has L >> l
//   positions), a subset of the levels stored;
// - the 1D pool gradient: dx = g routed to one element of each window of
//   F = 2**m positions (m = 1..4).
//
// The forward replaces, for rank-1 inputs, the Pallas TPU kernel
// `_pyramid_tpu` / `_kernel` in tf_1d_2d_segmentation_end2endpipelines_tpu/
// ops/pallas/pyramid.py (its rank-2 counterparts are in pyramid.cu); the
// gradient replaces XLA's select_and_scatter under the VJP of the JAX
// package's `downsample_pool` (ops/blocks.py), as pool_backward.cu does
// for rank 2.
//
// Bound: device-memory bandwidth, as for the 2D kernels: a few compares an
// element.  Every kernel below reads each input element once and writes
// each output element once.
//
// - pool1d_kernel<T, V, L>: one thread owns one group of V channels of a
//   span of 2^L positions: it reads the span a level-1 cell (two
//   positions) at a time, folds the levels in registers and stores each
//   wanted cell as soon as it is complete.  Neighbouring threads take
//   neighbouring channel groups of the same span, so a warp's loads are
//   contiguous runs of (B, L, C) memory.  V = 16 / sizeof(T) (16-byte
//   loads and stores) when C is a multiple of 16 bytes and every pointer
//   is 16-byte aligned (the UNet encoder pools: 32 .. 256 channels);
//   otherwise V = 1 (the MultiRes pools, 31 * 2^k channels, and the
//   deep-supervision masks, C = 1).
// - pool1d_backward_kernel<T, V, F>: one thread owns one window and one
//   group of V channels: it walks the window's F positions in order,
//   keeping a selected element and moving to the next element e whenever
//   !(selected >= e) -- select_and_scatter's rule with the max pool's
//   `ge` select: the first maximum for finite values, and a NaN is passed
//   over by the next element -- then writes all F positions, the gradient
//   at the chosen one and zeros elsewhere, so dx needs no memset.  The
//   threads of the window just past the pooled region write zeros to the
//   positions that the floor cut off.
//
// The launcher picks V from C and the pointers' alignment
// (tpuseg_maxpool1d_*_route name the kernel); nothing falls back at run
// time.  Max propagates NaN, as XLA's max and torch.amax do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels1d = 4;

struct OutPtrs1d {
  void* p[kMaxLevels1d];
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: v is one of the inputs (or 0)
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Vec<T, V> q = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = to_f(q.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Vec<T, V> q;
#pragma unroll
  for (int k = 0; k < V; ++k) q.v[k] = from_f<T>(in[k]);
  *reinterpret_cast<Vec<T, V>*>(p) = q;
}

// grid: x over (batch, span, channel group) triples, flattened.
template <typename T, int V, int L>
__global__ void pool1d_kernel(const T* __restrict__ x, OutPtrs1d outs,
                              int64_t B, int Len, int C, int spans) {
  constexpr int half = 1 << (L - 1);  // level-1 cells a span
  const int groups = C / V;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_b = (int64_t)spans * groups;
  if (t >= B * per_b) return;
  const int64_t b = t / per_b;
  const int r = (int)(t - b * per_b);
  const int grp = r % groups;
  const int s = r / groups;
  const int c0 = grp * V;
  // acc[l][k]: running max of the level-l cells of the level-(l+1) cell
  // being folded; every index is a constant after unrolling
  float acc[L + 1][V];
#pragma unroll
  for (int l = 0; l <= L; ++l)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[l][k] = -INFINITY;
  const int len1 = Len >> 1;
#pragma unroll
  for (int i = 0; i < half; ++i) {
    const int p1 = s * half + i;  // level-1 cell
    if (p1 < len1) {
      float a[V], c[V];
      const T* p = x + (b * Len + 2 * p1) * C + c0;
      load<T, V>(p, a);
      load<T, V>(p + C, c);
#pragma unroll
      for (int k = 0; k < V; ++k) a[k] = max_nan(a[k], c[k]);
      T* o = static_cast<T*>(outs.p[0]);
      if (o) store<T, V>(o + (b * len1 + p1) * C + c0, a);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[1][k] = max_nan(acc[1][k], a[k]);
    }
#pragma unroll
    for (int l = 2; l <= L; ++l) {
      if ((i + 1) % (1 << (l - 1))) continue;  // the level-l cell is open
      const int pl = p1 >> (l - 1);
      const int lenl = Len >> l;
      if (pl < lenl) {
        T* o = static_cast<T*>(outs.p[l - 1]);
        if (o) store<T, V>(o + (b * lenl + pl) * C + c0, acc[l - 1]);
        if (l < L) {
#pragma unroll
          for (int k = 0; k < V; ++k)
            acc[l][k] = max_nan(acc[l][k], acc[l - 1][k]);
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) acc[l - 1][k] = -INFINITY;
    }
  }
}

// grid: x over (batch, window, channel group) triples, flattened; the
// windows include the ragged one past the pooled region.
template <typename T, int V, int F>
__global__ void pool1d_backward_kernel(const T* __restrict__ x,
                                       const T* __restrict__ g,
                                       T* __restrict__ dx, int64_t B,
                                       int Len, int C, int windows) {
  const int groups = C / V;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_b = (int64_t)windows * groups;
  if (t >= B * per_b) return;
  const int64_t b = t / per_b;
  const int r = (int)(t - b * per_b);
  const int grp = r % groups;
  const int w = r / groups;
  const int c0 = grp * V;
  const int lf = Len / F;
  const int64_t base = (b * Len + (int64_t)w * F) * C + c0;
  float zero[V];
#pragma unroll
  for (int k = 0; k < V; ++k) zero[k] = 0.0f;
  if (w >= lf) {  // the ragged tail: zeros where positions exist
    for (int j = 0; j < F && w * F + j < Len; ++j)
      store<T, V>(dx + base + (int64_t)j * C, zero);
    return;
  }
  float sel_val[V];
  int sel[V];
  load<T, V>(x + base, sel_val);
#pragma unroll
  for (int k = 0; k < V; ++k) sel[k] = 0;
#pragma unroll
  for (int j = 1; j < F; ++j) {
    float e[V];
    load<T, V>(x + base + (int64_t)j * C, e);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if (!(sel_val[k] >= e[k])) {
        sel_val[k] = e[k];
        sel[k] = j;
      }
    }
  }
  float gv[V];
  load<T, V>(g + (b * lf + w) * C + c0, gv);
#pragma unroll
  for (int j = 0; j < F; ++j) {
    float o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = sel[k] == j ? gv[k] : 0.0f;
    store<T, V>(dx + base + (int64_t)j * C, o);
  }
}

bool aligned16(const void* p) {
  return !(reinterpret_cast<uintptr_t>(p) & 15);
}

int blocks_for(int64_t n, int threads) {
  return (int)((n + threads - 1) / threads);
}

// ---------------------------------------------------------------- forward

enum Route1d { kNone1d, kVec1d, kScalar1d };

const char* const kPyramid1dNames[] = {"none", "pool1d_kernel<V=16B>",
                                       "pool1d_kernel<V=1>"};
const char* const kBackward1dNames[] = {"none",
                                        "pool1d_backward_kernel<V=16B>",
                                        "pool1d_backward_kernel<V=1>"};

template <typename T>
Route1d pyramid_route(const void* x, const OutPtrs1d& outs, int64_t B,
                      int Len, int C, int L) {
  if (B == 0 || (Len >> 1) == 0) return kNone1d;
  bool vec = C % (16 / (int)sizeof(T)) == 0 && aligned16(x);
  for (int l = 0; l < L; ++l)
    if (outs.p[l] && !aligned16(outs.p[l])) vec = false;
  return vec ? kVec1d : kScalar1d;
}

template <typename T, int V>
void launch_pyramid_v(const T* x, const OutPtrs1d& outs, int64_t B, int Len,
                      int C, int L, int spans, cudaStream_t s) {
  const int threads = 256;
  const int grid = blocks_for(B * spans * (C / V), threads);
  switch (L) {
    case 1:
      pool1d_kernel<T, V, 1><<<grid, threads, 0, s>>>(x, outs, B, Len, C,
                                                      spans);
      break;
    case 2:
      pool1d_kernel<T, V, 2><<<grid, threads, 0, s>>>(x, outs, B, Len, C,
                                                      spans);
      break;
    case 3:
      pool1d_kernel<T, V, 3><<<grid, threads, 0, s>>>(x, outs, B, Len, C,
                                                      spans);
      break;
    default:
      pool1d_kernel<T, V, 4><<<grid, threads, 0, s>>>(x, outs, B, Len, C,
                                                      spans);
  }
}

// The arguments checked, and the route they take; returns a CUDA error
// code (0 if they are valid).
int prepare_pyramid(const void* x, const void* out_ptrs, int dtype, int64_t B,
                    int Len, int C, int L, OutPtrs1d* outs, int* spans,
                    Route1d* r) {
  if (L < 1 || L > kMaxLevels1d || B < 0 || Len < 0 || C < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const uint64_t* ptrs = static_cast<const uint64_t*>(out_ptrs);
  for (int l = 0; l < kMaxLevels1d; ++l)
    outs->p[l] = l < L ? reinterpret_cast<void*>(ptrs[l]) : nullptr;
  const int half = 1 << (L - 1);
  *spans = ((Len >> 1) + half - 1) / half;
  if ((int64_t)*spans * C > 0x7fffffffLL ||
      B * (int64_t)*spans * C > 0x7fffffffLL * 256)
    return (int)cudaErrorInvalidConfiguration;
  *r = dtype == 0 ? pyramid_route<float>(x, *outs, B, Len, C, L)
                  : pyramid_route<__nv_bfloat16>(x, *outs, B, Len, C, L);
  return (int)cudaSuccess;
}

template <typename T>
void launch_pyramid(Route1d r, const void* x, const OutPtrs1d& outs,
                    int64_t B, int Len, int C, int L, int spans,
                    cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (r == kVec1d)
    launch_pyramid_v<T, 16 / sizeof(T)>(xt, outs, B, Len, C, L, spans, s);
  else if (r == kScalar1d)
    launch_pyramid_v<T, 1>(xt, outs, B, Len, C, L, spans, s);
}

// --------------------------------------------------------------- backward

template <typename T>
Route1d backward_route(const void* x, const void* g, const void* dx,
                       int64_t B, int Len, int C) {
  if (B == 0 || Len == 0) return kNone1d;
  const bool vec = C % (16 / (int)sizeof(T)) == 0 && aligned16(x) &&
                   aligned16(g) && aligned16(dx);
  return vec ? kVec1d : kScalar1d;
}

template <typename T, int V>
void launch_backward_v(const T* x, const T* g, T* dx, int64_t B, int Len,
                       int C, int F, cudaStream_t s) {
  const int threads = 256;
  const int windows = (Len + F - 1) / F;
  const int grid = blocks_for(B * windows * (C / V), threads);
  switch (F) {
    case 2:
      pool1d_backward_kernel<T, V, 2><<<grid, threads, 0, s>>>(
          x, g, dx, B, Len, C, windows);
      break;
    case 4:
      pool1d_backward_kernel<T, V, 4><<<grid, threads, 0, s>>>(
          x, g, dx, B, Len, C, windows);
      break;
    case 8:
      pool1d_backward_kernel<T, V, 8><<<grid, threads, 0, s>>>(
          x, g, dx, B, Len, C, windows);
      break;
    default:
      pool1d_backward_kernel<T, V, 16><<<grid, threads, 0, s>>>(
          x, g, dx, B, Len, C, windows);
  }
}

template <typename T>
void launch_backward(Route1d r, const void* x, const void* g, void* dx,
                     int64_t B, int Len, int C, int F, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  if (r == kVec1d)
    launch_backward_v<T, 16 / sizeof(T)>(xt, gt, dt, B, Len, C, F, s);
  else if (r == kScalar1d)
    launch_backward_v<T, 1>(xt, gt, dt, B, Len, C, F, s);
}

int prepare_backward(const void* x, const void* g, const void* dx, int dtype,
                     int64_t B, int Len, int C, int factor, Route1d* r) {
  if (B < 0 || Len < 0 || C < 1 || (dtype != 0 && dtype != 1) ||
      (factor != 2 && factor != 4 && factor != 8 && factor != 16))
    return (int)cudaErrorInvalidValue;
  const int64_t per_b = (int64_t)((Len + factor - 1) / factor) * C;
  if (per_b > 0x7fffffffLL || B * per_b > 0x7fffffffLL * 256)
    return (int)cudaErrorInvalidConfiguration;
  *r = dtype == 0 ? backward_route<float>(x, g, dx, B, Len, C)
                  : backward_route<__nv_bfloat16>(x, g, dx, B, Len, C);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x: (B, Len, C) memory.  out_ptrs:
// host array of L (1..4) device pointers, level 1 first, each a (B,
// Len >> l, C) buffer, or null for a level the caller does not want.
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// launches nothing when there is nothing to pool.  Sets *launched to the
// name of the kernel it launched ("none" if it launched nothing).
int tpuseg_maxpool1d_pyramid(const void* x, const void* out_ptrs, int dtype,
                             int64_t B, int Len, int C, int L,
                             const char** launched, void* stream) {
  OutPtrs1d outs;
  int spans;
  Route1d r;
  *launched = kPyramid1dNames[kNone1d];
  const int err =
      prepare_pyramid(x, out_ptrs, dtype, B, Len, C, L, &outs, &spans, &r);
  if (err) return err;
  if (r == kNone1d) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_pyramid<float>(r, x, outs, B, Len, C, L, spans, s);
  else
    launch_pyramid<__nv_bfloat16>(r, x, outs, B, Len, C, L, spans, s);
  *launched = kPyramid1dNames[r];
  return (int)cudaGetLastError();
}

// The kernel tpuseg_maxpool1d_pyramid launches for the same arguments
// ("none" if it launches nothing), or null if it refuses them.
const char* tpuseg_maxpool1d_pyramid_route(const void* x,
                                           const void* out_ptrs, int dtype,
                                           int64_t B, int Len, int C, int L) {
  OutPtrs1d outs;
  int spans;
  Route1d r;
  if (prepare_pyramid(x, out_ptrs, dtype, B, Len, C, L, &outs, &spans, &r))
    return nullptr;
  return kPyramid1dNames[r];
}

// dtype: 0 = float32, 1 = bfloat16; factor: 2, 4, 8 or 16.  x and dx:
// (B, Len, C) memory; g: (B, Len / factor, C).  Launches on `stream` and
// returns cudaGetLastError() (0 on success); sets *launched to the name
// of the kernel it launched ("none" if it launched nothing).
int tpuseg_maxpool1d_backward(const void* x, const void* g, void* dx,
                              int dtype, int64_t B, int Len, int C,
                              int factor, const char** launched,
                              void* stream) {
  Route1d r;
  *launched = kBackward1dNames[kNone1d];
  const int err = prepare_backward(x, g, dx, dtype, B, Len, C, factor, &r);
  if (err) return err;
  if (r == kNone1d) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_backward<float>(r, x, g, dx, B, Len, C, factor, s);
  else
    launch_backward<__nv_bfloat16>(r, x, g, dx, B, Len, C, factor, s);
  *launched = kBackward1dNames[r];
  return (int)cudaGetLastError();
}

// The kernel tpuseg_maxpool1d_backward launches for the same arguments
// ("none" if it launches nothing), or null if it refuses them.
const char* tpuseg_maxpool1d_backward_route(const void* x, const void* g,
                                            const void* dx, int dtype,
                                            int64_t B, int Len, int C,
                                            int factor) {
  Route1d r;
  if (prepare_backward(x, g, dx, dtype, B, Len, C, factor, &r))
    return nullptr;
  return kBackward1dNames[r];
}

}  // extern "C"
