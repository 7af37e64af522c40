// Gradient of the max pool with window = stride = F = 2^m (m = 1..4),
// VALID floor truncation, on NHWC memory (a channels_last NCHW tensor):
// dx = the output gradient g routed to one element of each F x F window.
//
// Replaces XLA's select_and_scatter, which is what the VJP of the JAX
// package's pool (lax.reduce_window max, tf_1d_2d_segmentation_
// end2endpipelines_tpu/ops/blocks.py, `downsample_pool`) lowers to.  That
// is not a Pallas kernel: the port needs this kernel because its forward
// pool is the hand-written pyramid kernel (pyramid.cu), which has no
// gradient of its own.
//
// Routing rule, select_and_scatter's with the `ge` select of the max
// pool's VJP: walk the WHOLE F x F window in row-major order keeping a
// selected element, and move to the next element e whenever
// !(selected >= e).  For finite values that is the FIRST maximum in
// row-major order (ties are common after a ReLU, where plateaus are
// exactly 0); a NaN is passed over by the next element, exactly as XLA
// does it.  A 4x4 window is therefore not two nested 2x2 pools: zeros
// with ones at (0,2) and (1,0) route to (0,2), where the nested 2x2
// walks would pick (1,0).  Rows and columns that the floor cuts off get
// a zero gradient.
//
// Bound: device-memory bandwidth.  The kernel reads x and g once and
// writes dx once, about (2 + 1/F^2)x the bytes of x, with one compare per
// element.  Design: one thread per window and 16-byte group of channels
// (8 bf16 or 4 f32): it walks the window once, one 16-byte load of x per
// element, keeping each channel's selected value and index in registers,
// then writes every element of the window, zeros included, one 16-byte
// store each, so dx needs no memset.  The choice is recomputed from x; y
// is not read.  The window's rows are unrolled 4 at a time (all of them
// for F <= 4): fully unrolled 16x16 windows took nvcc half a minute.  A C
// that is not a multiple of 16 bytes (or a misaligned pointer) takes the
// same kernel with one channel per thread.  The ragged
// last rows and columns are covered by threads of the windows just past
// the pooled region, which write zeros to the elements that exist.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  return __float2bfloat16(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V, int F>
__global__ void pool_backward_kernel(const T* __restrict__ x,
                                     const T* __restrict__ g,
                                     T* __restrict__ dx, int H, int W,
                                     int C) {
  using P = Pack<T, V>;
  const int groups = C / V;
  const int wc = (W + F - 1) / F;  // window columns, the ragged one included
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= wc * groups) return;
  const int grp = t % groups;
  const int xw = t / groups;
  const int yw = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int hf = H / F, wf = W / F;
  const int64_t c0 = (int64_t)grp * V;
  const int64_t row = (int64_t)W * C;
  const int64_t base = ((b * H + (int64_t)F * yw) * W + (int64_t)F * xw) * C + c0;

  P zero;
#pragma unroll
  for (int k = 0; k < V; ++k) zero.v[k] = from_f<T>(0.0f);
  if (yw < hf && xw < wf) {
    // pass 1: the row-major walk, per channel
    float s[V];
    int sel[V];
    {
      const P q = *reinterpret_cast<const P*>(x + base);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s[k] = to_f(q.v[k]);
        sel[k] = 0;
      }
    }
#pragma unroll 4
    for (int i = 0; i < F; ++i) {
#pragma unroll
      for (int j = 0; j < F; ++j) {
        if (i == 0 && j == 0) continue;
        const P q =
            *reinterpret_cast<const P*>(x + base + i * row + (int64_t)j * C);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float e = to_f(q.v[k]);
          if (!(s[k] >= e)) {
            s[k] = e;
            sel[k] = i * F + j;
          }
        }
      }
    }
    const P gv =
        *reinterpret_cast<const P*>(g + ((b * hf + yw) * wf + xw) * C + c0);
    // pass 2: every element of the window, the gradient where selected
#pragma unroll 4
    for (int i = 0; i < F; ++i) {
#pragma unroll
      for (int j = 0; j < F; ++j) {
        P out;
#pragma unroll
        for (int k = 0; k < V; ++k)
          out.v[k] = sel[k] == i * F + j ? gv.v[k] : zero.v[k];
        *reinterpret_cast<P*>(dx + base + i * row + (int64_t)j * C) = out;
      }
    }
  } else {
    // a window the floor cut off: zero the elements that exist
    const int rows = min(F, H - F * yw), cols = min(F, W - F * xw);
    for (int i = 0; i < rows; ++i)
      for (int j = 0; j < cols; ++j)
        *reinterpret_cast<P*>(dx + base + i * row + (int64_t)j * C) = zero;
  }
}

template <typename T, int V>
void launch_f(int F, dim3 grid, int threads, cudaStream_t s, const T* x,
              const T* g, T* dx, int H, int W, int C) {
  switch (F) {
    case 2:
      pool_backward_kernel<T, V, 2><<<grid, threads, 0, s>>>(x, g, dx, H, W, C);
      break;
    case 4:
      pool_backward_kernel<T, V, 4><<<grid, threads, 0, s>>>(x, g, dx, H, W, C);
      break;
    case 8:
      pool_backward_kernel<T, V, 8><<<grid, threads, 0, s>>>(x, g, dx, H, W, C);
      break;
    default:
      pool_backward_kernel<T, V, 16><<<grid, threads, 0, s>>>(x, g, dx, H, W,
                                                              C);
  }
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int64_t B, int H, int W,
           int C, int F, cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T);
  const bool vec = C % V16 == 0 && !(reinterpret_cast<uintptr_t>(x) & 15) &&
                   !(reinterpret_cast<uintptr_t>(g) & 15) &&
                   !(reinterpret_cast<uintptr_t>(dx) & 15);
  const int V = vec ? V16 : 1;
  const int64_t n = (int64_t)((W + F - 1) / F) * (C / V);
  const int hc = (H + F - 1) / F;
  if (n > 0x7fffffffLL || hc > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)hc,
                  (unsigned)B);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  if (vec)
    launch_f<T, V16>(F, grid, threads, s, xt, gt, dt, H, W, C);
  else
    launch_f<T, 1>(F, grid, threads, s, xt, gt, dt, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; factor: 2, 4, 8 or 16.  x and dx: NHWC
// (B, H, W, C); g: NHWC (B, H / factor, W / factor, C).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); launches
// nothing for an empty x.
int tpuseg_maxpool_backward(const void* x, const void* g, void* dx, int dtype,
                            int64_t B, int H, int W, int C, int factor,
                            void* stream) {
  if (B < 0 || H < 0 || W < 0 || C < 1 || (dtype != 0 && dtype != 1) ||
      (factor != 2 && factor != 4 && factor != 8 && factor != 16))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, g, dx, B, H, W, C, factor, s)
                    : launch<__nv_bfloat16>(x, g, dx, B, H, W, C, factor, s);
}

}  // extern "C"
