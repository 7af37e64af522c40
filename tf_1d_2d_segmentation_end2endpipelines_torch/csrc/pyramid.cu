// Max-pool pyramid: [maxpool(x, 2**l) for l in 1..L], window = stride,
// VALID floor truncation, on NHWC memory (a channels_last NCHW tensor).
//
// Replaces the Pallas TPU kernel `_pyramid_tpu` / `_kernel` in
// tf_1d_2d_segmentation_end2endpipelines_tpu/ops/pallas/pyramid.py.
//
// Bound: device-memory bandwidth.  There is no arithmetic to speak of
// (three compares per output element), so the floor is one read of the
// input plus the writes of every level, about 1/4 + 1/16 + ... < 1/3 of
// the read.  Two kernels, chosen by the launcher from the call's shape:
//
// - pool_vec_kernel, level L alone (L == 1, or every level below L
//   null) for L <= 4, with C a multiple of 16 bytes of channels (every
//   encoder pool of the UNet family, and UNet3+'s pools by 4 and 8): one
//   thread per output pixel and 16-byte channel group, one 16-byte load
//   per pixel of its 2^L x 2^L window and one 16-byte store.  This is the
//   serving path's kernel.
// - pyramid_kernel, any L, any C: one thread owns one 2^L x 2^L patch of
//   one channel, reads it once, folds every level from the level below it
//   in registers (Morton order), and writes each level as soon as a cell
//   of it is complete.  Neighbouring threads take neighbouring channels,
//   so a warp's accesses are contiguous runs of NHWC memory.
//
// Both read every input element exactly once.  The TPU kernel's in-VMEM
// transposes have no counterpart: a thread addresses its pixels directly.
//
// Ragged edges: level l has H >> l rows (floor(floor(H/2)/2) == H >> 2,
// so one pass gives the reduce_window chain's answer).  The thread grid
// covers ceil((H >> 1) / 2^(L-1)) patch rows, which reaches every cell of
// every level; a cell inside its level's bounds has all four children
// inside theirs, so a cell is written only when it is in bounds and only
// in-bounds cells are folded into their parents.
//
// A caller that wants only some levels passes a null pointer for the
// others, and their stores are skipped (a pool by 8 writes level 3
// only).
//
// Max propagates NaN, as XLA's max and torch.amax do (fmaxf drops it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;

struct OutPtrs {
  void* p[kMaxLevels];
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // exact: v is one of the inputs
}

template <typename T>
__global__ void pyramid_kernel(const T* __restrict__ x, OutPtrs outs, int H,
                               int W, int C, int L, int tiles_w) {
  // grid: x over (patch column, channel) pairs of one patch row, y over
  // patch rows, z over the batch; one 32-bit division per thread
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= tiles_w * C) return;
  const int c = t % C;
  const int tx = t / C;
  const int ty = blockIdx.y;
  const int64_t b = blockIdx.z;

  const int side1 = 1 << (L - 1);  // level-1 cells per patch side
  const int h1 = H >> 1, w1 = W >> 1;
  // acc[l]: running max of the level-l cells of the level-(l+1) cell being
  // folded.  Every index below is a constant after unrolling, so the
  // accumulators live in registers.
  float acc[kMaxLevels + 1];
#pragma unroll
  for (int l = 0; l <= kMaxLevels; ++l) acc[l] = -INFINITY;

  const int64_t row = (int64_t)W * C;
  const int cells = side1 * side1;
  for (int k = 0; k < cells; ++k) {
    // Morton order: every 4^(l-1) consecutive k complete one level-l cell
    int i = 0, j = 0;
#pragma unroll
    for (int bit = 0; bit < kMaxLevels - 1; ++bit) {
      if (bit >= L - 1) break;
      j |= ((k >> (2 * bit)) & 1) << bit;
      i |= ((k >> (2 * bit + 1)) & 1) << bit;
    }
    const int y1 = ty * side1 + i, x1 = tx * side1 + j;
    if (y1 < h1 && x1 < w1) {
      const T* p = x + ((b * H + 2 * y1) * W + 2 * x1) * C + c;
      const float v = max_nan(max_nan(load_f(p), load_f(p + C)),
                              max_nan(load_f(p + row), load_f(p + row + C)));
      T* o = static_cast<T*>(outs.p[0]);
      if (o) store_f(o + ((b * h1 + y1) * w1 + x1) * C + c, v);
      acc[1] = max_nan(acc[1], v);
    }
#pragma unroll
    for (int l = 2; l <= kMaxLevels; ++l) {
      if (l > L || ((k + 1) & ((1 << (2 * (l - 1))) - 1))) break;
      const int hl = H >> l, wl = W >> l;
      const int yl = y1 >> (l - 1), xl = x1 >> (l - 1);
      const float m = acc[l - 1];
      acc[l - 1] = -INFINITY;
      if (yl < hl && xl < wl) {
        T* o = static_cast<T*>(outs.p[l - 1]);
        if (o) store_f(o + ((b * hl + yl) * wl + xl) * C + c, m);
        if (l < L) acc[l] = max_nan(acc[l], m);
      }
    }
  }
}

template <typename T, int V>
struct alignas(16) Pack {
  T v[V];
};

// Level L alone with C a multiple of V = 16 / sizeof(T): each thread owns
// V channels of one output pixel, an F x F window (F = 2^L), and moves
// them as one 16-byte load per input pixel and one 16-byte store, the
// widest access a thread has.  The window's rows are unrolled 4 at a time.
template <typename T, int V, int F>
__global__ void pool_vec_kernel(const T* __restrict__ x, T* __restrict__ out,
                                int H, int W, int C) {
  using P = Pack<T, V>;
  const int groups = C / V;
  const int wf = W / F;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= wf * groups) return;
  const int g = t % groups;
  const int xo = t / groups;
  const int yo = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row = (int64_t)W * C;
  const T* p = x + ((b * H + (int64_t)F * yo) * W + (int64_t)F * xo) * C +
               (int64_t)g * V;
  float m[V];
#pragma unroll
  for (int k = 0; k < V; ++k) m[k] = -INFINITY;
#pragma unroll 4
  for (int i = 0; i < F; ++i) {
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const P q = *reinterpret_cast<const P*>(p + i * row + (int64_t)j * C);
#pragma unroll
      for (int k = 0; k < V; ++k) m[k] = max_nan(m[k], load_f(&q.v[k]));
    }
  }
  P r;
#pragma unroll
  for (int k = 0; k < V; ++k) store_f(&r.v[k], m[k]);
  *reinterpret_cast<P*>(out + ((b * (H / F) + yo) * wf + xo) * C +
                        (int64_t)g * V) = r;
}

// Launches pool_vec_kernel for level L into `out` when the shape allows
// (L <= 4, C a multiple of 16 bytes, 16-byte aligned pointers); false if
// it does not.
template <typename T>
bool launch_vec(const void* x, void* out, int64_t B, int H, int W, int C,
                int L, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (L > 4 || C % V || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return false;
  if ((H >> L) == 0 || (W >> L) == 0) return true;  // nothing to store
  const int threads = 256;
  const int64_t n = (int64_t)(W >> L) * (C / V);
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)(H >> L),
                  (unsigned)B);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (L) {
    case 1:
      pool_vec_kernel<T, V, 2><<<grid, threads, 0, s>>>(xt, ot, H, W, C);
      break;
    case 2:
      pool_vec_kernel<T, V, 4><<<grid, threads, 0, s>>>(xt, ot, H, W, C);
      break;
    case 3:
      pool_vec_kernel<T, V, 8><<<grid, threads, 0, s>>>(xt, ot, H, W, C);
      break;
    default:
      pool_vec_kernel<T, V, 16><<<grid, threads, 0, s>>>(xt, ot, H, W, C);
  }
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  out_ptrs: host array of L device
// pointers, level 1 first, each an NHWC buffer of (B, H>>l, W>>l, C), or
// null for a level below L the caller does not want.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int tpuseg_maxpool_pyramid(const void* x, const void* out_ptrs, int dtype,
                           int64_t B, int H, int W, int C, int L,
                           void* stream) {
  if (L < 1 || L > kMaxLevels || B < 0 || H < 0 || W < 0 || C < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  OutPtrs outs = {};
  const uint64_t* ptrs = static_cast<const uint64_t*>(out_ptrs);
  for (int l = 0; l < L; ++l) outs.p[l] = reinterpret_cast<void*>(ptrs[l]);
  const int side1 = 1 << (L - 1);
  const int tiles_h = ((H >> 1) + side1 - 1) / side1;
  const int tiles_w = ((W >> 1) + side1 - 1) / side1;
  if (B == 0 || tiles_h == 0 || tiles_w == 0) return (int)cudaSuccess;
  if ((int64_t)tiles_w * C > 0x7fffffffLL || tiles_h > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const int threads = 256;
  const dim3 grid((unsigned)(((int64_t)tiles_w * C + threads - 1) / threads),
                  (unsigned)tiles_h, (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool last_only = outs.p[L - 1] != nullptr;
  for (int l = 0; l < L - 1; ++l) last_only = last_only && !outs.p[l];
  if (last_only) {
    void* out = outs.p[L - 1];
    const bool done =
        dtype == 0 ? launch_vec<float>(x, out, B, H, W, C, L, s)
                   : launch_vec<__nv_bfloat16>(x, out, B, H, W, C, L, s);
    if (done) return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    pyramid_kernel<float><<<grid, threads, 0, s>>>(
        static_cast<const float*>(x), outs, H, W, C, L, tiles_w);
  } else {
    pyramid_kernel<__nv_bfloat16><<<grid, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), outs, H, W, C, L, tiles_w);
  }
  return (int)cudaGetLastError();
}

const char* tpuseg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
