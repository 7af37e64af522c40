// Gradient of the max pool with window = stride = F = 2^m (m = 1..5),
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
// Splitting the walk: rows A then B of a window, each walked on its own
// (A's selected value A.val and index, and whether B held a NaN), give the
// whole walk's choice by
//   B  if B holds a NaN, or if !(A.val >= B.val) (A.val a NaN included),
//   A  otherwise.
// A NaN resets the walk (the next element always takes over from it), so
// after B's NaN both walks agree; with no NaN in B the walk from A moves
// only to a value above A.val and then to B's first maximum.  The rule is
// associative, so rows may be joined in row order one by one or as a
// tree.
//
// Bound: device-memory bandwidth.  The kernels read x and g once and
// write dx once, about (2 + 1/F^2)x the bytes of x, with one compare per
// element.  Both write every element of a window, zeros included, one
// 16-byte store each, so dx needs no memset, and recompute the choice
// from x (y is not read).  Both move 16 bytes of channels (8 bf16 or 4
// f32) a thread; a C that is not a multiple of 16 bytes (or a misaligned
// pointer) takes the same kernel with one channel per thread.
// - pool_backward_kernel, F = 2: one thread per window and channel group
//   walks the window (4 loads) and writes it (4 stores).
// - pool_backward_rows_kernel, F = 4 .. 32: one thread per window, channel
//   group and window row.  A thread for the whole window left few threads
//   (16,384 for a (16,256,256,32) input at F = 16: 64 blocks on 132 SMs)
//   each with F^2 dependent compare steps (41% of the bound at F = 16).
//   Here the F threads of a window (threadIdx.y) walk their rows side by
//   side, each also reading g before the barriers, put each row's summary
//   in shared memory, thread i joins the F summaries of channels i, i + F,
//   ... in row order by the rule above and shares the choice, and each
//   thread writes its own row.  Neighbouring lanes read neighbouring
//   16-byte groups (or pixels) of a row.  Measured against the whole-window
//   walk this design wins at F = 8 and 16 and gives back a few percent at
//   F = 4 on the smaller inputs, where a thread's 4 loads pay for the
//   barriers; the window's rows as lanes of one warp, joined by shuffles
//   with no barrier, were slower at every F (PERF.md).  At F = 32 (the
//   pool by 32 of a dense-input encoder at depth 5) a block is 8 windows
//   of 32 rows, a thread walks its row 16 pixels at a time (16 loads in
//   flight, as at F = 16, registers bounded), and the window's choice,
//   up to 1023, takes 16 bits.
// The ragged last rows and columns are covered by threads of the windows
// just past the pooled region, which write zeros to the elements that
// exist.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// F = 2: one thread per window and channel group.
template <typename T, int V>
__global__ void pool_backward_kernel(const T* __restrict__ x,
                                     const T* __restrict__ g,
                                     T* __restrict__ dx, int H, int W,
                                     int C) {
  constexpr int F = 2;
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
#pragma unroll
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
#pragma unroll
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

// F >= 4.  Block: X (window, channel group) columns by F window rows.
template <typename T, int V, int F>
__global__ void __launch_bounds__(256)
    pool_backward_rows_kernel(const T* __restrict__ x,
                              const T* __restrict__ g, T* __restrict__ dx,
                              int H, int W, int C) {
  using P = Pack<T, V>;
  using Sel = typename std::conditional<(F * F > 256), unsigned short,
                                        unsigned char>::type;
  constexpr int X = 256 / F;
  constexpr int G = F < 16 ? F : 16;  // pixels of a row loaded together
  // row i's summary per channel: the walk's value, and its column with
  // bit 7 set if the row held a NaN; then the window's choice, i * F + j
  __shared__ float sval[F][V][X];
  __shared__ unsigned char scode[F][V][X];
  __shared__ Sel ssel[V][X];
  const int groups = C / V;
  const int wc = (W + F - 1) / F;  // window columns, the ragged one included
  const int tx = threadIdx.x, i = threadIdx.y;
  const int t = blockIdx.x * X + tx;
  const bool live = t < wc * groups;
  const int grp = live ? t % groups : 0;
  const int xw = live ? t / groups : 0;
  const int yw = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int hf = H / F, wf = W / F;
  const bool full = live && yw < hf && xw < wf;
  const int64_t c0 = (int64_t)grp * V;
  const int64_t base =
      ((b * H + (int64_t)F * yw + i) * W + (int64_t)F * xw) * C + c0;

  P gv;  // read before the barriers, so that its latency hides behind them
  if (full) {  // the row's walk, per channel, G pixels at a time
    float s[V];
    int sel[V];
    bool nan[V];
    gv = *reinterpret_cast<const P*>(g + ((b * hf + yw) * wf + xw) * C + c0);
#pragma unroll
    for (int j0 = 0; j0 < F; j0 += G) {
      P q[G];
#pragma unroll
      for (int j = 0; j < G; ++j)
        q[j] = *reinterpret_cast<const P*>(x + base + (int64_t)(j0 + j) * C);
#pragma unroll
      for (int k = 0; k < V; ++k) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          const float e = to_f(q[j].v[k]);
          if (j0 + j == 0) {
            s[k] = e;
            sel[k] = 0;
            nan[k] = e != e;
            continue;
          }
          nan[k] = nan[k] || e != e;
          if (!(s[k] >= e)) {
            s[k] = e;
            sel[k] = j0 + j;
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sval[i][k][tx] = s[k];
      scode[i][k][tx] = (unsigned char)(sel[k] | (nan[k] ? 0x80 : 0));
    }
  }
  __syncthreads();
  if (full) {  // join the rows in row order, channel k by thread k % F
    for (int k = i; k < V; k += F) {
      float a = sval[0][k][tx];
      int sel = scode[0][k][tx] & 0x7f;
#pragma unroll
      for (int r = 1; r < F; ++r) {
        const float v = sval[r][k][tx];
        const int code = scode[r][k][tx];
        if ((code & 0x80) || !(a >= v)) {
          a = v;
          sel = r * F + (code & 0x7f);
        }
      }
      ssel[k][tx] = (Sel)sel;
    }
  }
  __syncthreads();
  P zero;
#pragma unroll
  for (int k = 0; k < V; ++k) zero.v[k] = from_f<T>(0.0f);
  if (full) {  // this row of the window, the gradient where selected
    int sel[V];
#pragma unroll
    for (int k = 0; k < V; ++k) sel[k] = ssel[k][tx] - i * F;
#pragma unroll
    for (int j = 0; j < F; ++j) {
      P out;
#pragma unroll
      for (int k = 0; k < V; ++k) out.v[k] = sel[k] == j ? gv.v[k] : zero.v[k];
      *reinterpret_cast<P*>(dx + base + (int64_t)j * C) = out;
    }
  } else if (live && F * yw + i < H) {
    // a window the floor cut off: zero this row's elements that exist
    const int cols = min(F, W - F * xw);
    for (int j = 0; j < cols; ++j)
      *reinterpret_cast<P*>(dx + base + (int64_t)j * C) = zero;
  }
}

// The kernel the launcher picks for a call.
enum Route { kNone, kWindow, kRows };

const char* const kRouteNames[] = {"none", "pool_backward_kernel",
                                   "pool_backward_rows_kernel"};

Route route(int64_t B, int H, int W, int F) {
  if (B == 0 || H == 0 || W == 0) return kNone;
  return F == 2 ? kWindow : kRows;
}

// 16-byte channel groups when C and every pointer allow them.
template <typename T>
bool vector_path(const void* x, const void* g, const void* dx, int C) {
  constexpr int V16 = 16 / sizeof(T);
  return C % V16 == 0 && !(reinterpret_cast<uintptr_t>(x) & 15) &&
         !(reinterpret_cast<uintptr_t>(g) & 15) &&
         !(reinterpret_cast<uintptr_t>(dx) & 15);
}

template <typename T, int V, int F>
void launch_rows(int64_t B, int H, int W, int C, cudaStream_t s, const T* x,
                 const T* g, T* dx) {
  constexpr int X = 256 / F;
  const int64_t n = (int64_t)((W + F - 1) / F) * (C / V);
  const dim3 grid((unsigned)((n + X - 1) / X), (unsigned)((H + F - 1) / F),
                  (unsigned)B);
  pool_backward_rows_kernel<T, V, F><<<grid, dim3(X, F), 0, s>>>(x, g, dx, H,
                                                                 W, C);
}

template <typename T, int V>
void launch_v(int64_t B, int H, int W, int C, int F, cudaStream_t s,
              const T* x, const T* g, T* dx) {
  switch (F) {
    case 2: {
      const int threads = 256;
      const int64_t n = (int64_t)((W + 1) / 2) * (C / V);
      const dim3 grid((unsigned)((n + threads - 1) / threads),
                      (unsigned)((H + 1) / 2), (unsigned)B);
      pool_backward_kernel<T, V><<<grid, threads, 0, s>>>(x, g, dx, H, W, C);
      break;
    }
    case 4:
      launch_rows<T, V, 4>(B, H, W, C, s, x, g, dx);
      break;
    case 8:
      launch_rows<T, V, 8>(B, H, W, C, s, x, g, dx);
      break;
    case 16:
      launch_rows<T, V, 16>(B, H, W, C, s, x, g, dx);
      break;
    default:
      launch_rows<T, V, 32>(B, H, W, C, s, x, g, dx);
  }
}

template <typename T>
int launch(const void* x, const void* g, void* dx, int64_t B, int H, int W,
           int C, int F, cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T);
  const bool vec = vector_path<T>(x, g, dx, C);
  const int64_t n = (int64_t)((W + F - 1) / F) * (C / (vec ? V16 : 1));
  if (n > 0x7fffffffLL || (H + F - 1) / F > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  if (vec)
    launch_v<T, V16>(B, H, W, C, F, s, xt, gt, dt);
  else
    launch_v<T, 1>(B, H, W, C, F, s, xt, gt, dt);
  return (int)cudaGetLastError();
}

bool valid(int64_t B, int H, int W, int C, int dtype, int factor) {
  return !(B < 0 || H < 0 || W < 0 || C < 1 || (dtype != 0 && dtype != 1) ||
           (factor != 2 && factor != 4 && factor != 8 && factor != 16 &&
            factor != 32));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; factor: 2, 4, 8, 16 or 32.  x and dx: NHWC
// (B, H, W, C); g: NHWC (B, H / factor, W / factor, C).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); launches
// nothing for an empty x.
int tpuseg_maxpool_backward(const void* x, const void* g, void* dx, int dtype,
                            int64_t B, int H, int W, int C, int factor,
                            void* stream) {
  if (!valid(B, H, W, C, dtype, factor)) return (int)cudaErrorInvalidValue;
  if (route(B, H, W, factor) == kNone) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(x, g, dx, B, H, W, C, factor, s)
                    : launch<__nv_bfloat16>(x, g, dx, B, H, W, C, factor, s);
}

// The kernel tpuseg_maxpool_backward launches for the same arguments
// ("none" if it launches nothing), with "<V=1>" where it takes one
// channel a thread; null if it refuses them.
const char* tpuseg_maxpool_backward_route(const void* x, const void* g,
                                          const void* dx, int dtype,
                                          int64_t B, int H, int W, int C,
                                          int factor) {
  static const char* const kScalarNames[] = {
      "none", "pool_backward_kernel<V=1>", "pool_backward_rows_kernel<V=1>"};
  if (!valid(B, H, W, C, dtype, factor)) return nullptr;
  const Route r = route(B, H, W, factor);
  const bool vec = dtype == 0 ? vector_path<float>(x, g, dx, C)
                              : vector_path<__nv_bfloat16>(x, g, dx, C);
  return (vec ? kRouteNames : kScalarNames)[r];
}

}  // extern "C"
