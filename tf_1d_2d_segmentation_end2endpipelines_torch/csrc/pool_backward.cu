// Gradient of the 2x2 max pool (window = stride = 2, VALID floor
// truncation) on NHWC memory (a channels_last NCHW tensor):
// dx = the output gradient g routed to one element of each window.
//
// Replaces XLA's select_and_scatter, which is what the VJP of the JAX
// package's pool (lax.reduce_window max, tf_1d_2d_segmentation_
// end2endpipelines_tpu/ops/blocks.py, `downsample_pool`) lowers to.  That
// is not a Pallas kernel: the port needs this kernel because its forward
// pool is the hand-written pyramid kernel (pyramid.cu), which has no
// gradient of its own.
//
// Routing rule, select_and_scatter's with the `ge` select of the max
// pool's VJP: walk the window in row-major order keeping a selected
// element, and move to the next element e whenever !(selected >= e).
// For finite values that is the FIRST maximum (ties are common after a
// ReLU, where plateaus are exactly 0); a NaN is passed over by the next
// element, exactly as XLA does it.  Rows and columns that the floor cuts
// off get a zero gradient.
//
// Bound: device-memory bandwidth.  The kernel reads x and g once and
// writes dx once, about 2.25x the bytes of x, with a few compares per
// element.  Design: one thread per 2x2 window and 16-byte group of
// channels (8 bf16 or 4 f32), as the forward's vector kernel: four
// 16-byte loads of x, one of g, four 16-byte stores of dx, zeros
// included, so dx needs no memset.  The thread recomputes the window's
// choice from x; y is not read (it is one of the four values exactly).
// A C that is not a multiple of 16 bytes (or a misaligned pointer) takes
// the same kernel with one channel per thread.  The ragged last row and
// column are covered by threads of the windows just past the pooled
// region, which write zeros to the elements that exist.

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

template <typename T, int V>
__global__ void pool2x2_backward_kernel(const T* __restrict__ x,
                                        const T* __restrict__ g,
                                        T* __restrict__ dx, int H, int W,
                                        int C) {
  using P = Pack<T, V>;
  const int groups = C / V;
  const int wc = (W + 1) >> 1;  // window columns, the ragged one included
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= wc * groups) return;
  const int grp = t % groups;
  const int x1 = t / groups;
  const int y1 = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int h1 = H >> 1, w1 = W >> 1;
  const int64_t c0 = (int64_t)grp * V;
  const int64_t row = (int64_t)W * C;
  const int64_t base = ((b * H + 2 * y1) * W + 2 * x1) * C + c0;
  // the window's four elements in row-major order
  const int64_t off[4] = {0, C, row, row + C};

  P out[4], zero;
#pragma unroll
  for (int k = 0; k < V; ++k) zero.v[k] = from_f<T>(0.0f);
  if (y1 < h1 && x1 < w1) {
    P q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      q[j] = *reinterpret_cast<const P*>(x + base + off[j]);
    const P gv =
        *reinterpret_cast<const P*>(g + ((b * h1 + y1) * w1 + x1) * C + c0);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      int sel = 0;
      float s = to_f(q[0].v[k]);
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const float e = to_f(q[j].v[k]);
        if (!(s >= e)) {
          s = e;
          sel = j;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[j].v[k] = sel == j ? gv.v[k] : zero.v[k];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<P*>(dx + base + off[j]) = out[j];
  } else {
    // a window the floor cut off: zero the elements that exist
    const bool has_row1 = 2 * y1 + 1 < H, has_col1 = 2 * x1 + 1 < W;
    *reinterpret_cast<P*>(dx + base) = zero;
    if (has_col1) *reinterpret_cast<P*>(dx + base + off[1]) = zero;
    if (has_row1) *reinterpret_cast<P*>(dx + base + off[2]) = zero;
    if (has_row1 && has_col1) *reinterpret_cast<P*>(dx + base + off[3]) = zero;
  }
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int64_t B, int H, int W,
           int C, cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T);
  const bool vec = C % V16 == 0 && !(reinterpret_cast<uintptr_t>(x) & 15) &&
                   !(reinterpret_cast<uintptr_t>(g) & 15) &&
                   !(reinterpret_cast<uintptr_t>(dx) & 15);
  const int V = vec ? V16 : 1;
  const int64_t n = (int64_t)((W + 1) >> 1) * (C / V);
  const int hc = (H + 1) >> 1;
  if (n > 0x7fffffffLL || hc > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int threads = 256;
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)hc,
                  (unsigned)B);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  if (vec)
    pool2x2_backward_kernel<T, V16><<<grid, threads, 0, s>>>(xt, gt, dt, H, W,
                                                             C);
  else
    pool2x2_backward_kernel<T, 1><<<grid, threads, 0, s>>>(xt, gt, dt, H, W,
                                                           C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x and dx: NHWC (B, H, W, C); g: NHWC
// (B, H >> 1, W >> 1, C).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); launches nothing for an empty x.
int tpuseg_maxpool2x2_backward(const void* x, const void* g, void* dx,
                               int dtype, int64_t B, int H, int W, int C,
                               void* stream) {
  if (B < 0 || H < 0 || W < 0 || C < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || W == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, g, dx, B, H, W, C, s)
                    : launch<__nv_bfloat16>(x, g, dx, B, H, W, C, s);
}

}  // extern "C"
