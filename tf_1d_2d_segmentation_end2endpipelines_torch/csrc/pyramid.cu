// Max-pool pyramid: [maxpool(x, 2**l) for l in 1..L], window = stride,
// VALID floor truncation, on NHWC memory (a channels_last NCHW tensor).
//
// Replaces the Pallas TPU kernel `_pyramid_tpu` / `_kernel` in
// tf_1d_2d_segmentation_end2endpipelines_tpu/ops/pallas/pyramid.py.
//
// Bound: device-memory bandwidth.  There is no arithmetic to speak of
// (three compares per output element), so the floor is one read of the
// input plus the writes of every level, about 1/4 + 1/16 + ... < 1/3 of
// the read.  Every kernel below reads each input element exactly once.
// The TPU kernel's in-VMEM transposes have no counterpart: a thread
// addresses its pixels directly.  Four kernels, chosen by the launcher
// from the call's shape:
//
// - pyramid_c1_kernel, C = 1 (the deep-supervision mask, the TPU kernel's
//   own case), L <= 5: a block owns a band of 2^L rows of one image and a
//   thread 16 bytes of each row (4 f32 or 8 bf16 columns), so a warp
//   reads 512 contiguous bytes of a row and a thread has up to 16
//   independent 16-byte loads in flight.  The thread folds its rows in
//   registers, the levels whose cells fit in its 16 bytes across its own
//   vector, and the wider ones across lanes with __shfl_xor_sync.  A row
//   whose start is not 16-byte aligned (W * sizeof(T) not a multiple of
//   16, or an offset base pointer), and the ragged last vector of a row,
//   are read element by element in the same kernel.
// - pool_vec_kernel, level L alone (L == 1, or every level below L
//   null) for L <= 4, with C a multiple of 16 bytes of channels (every
//   encoder pool of the UNet family): one thread per output pixel and
//   16-byte channel group, one 16-byte load per pixel of its 2^L x 2^L
//   window and one 16-byte store.  This is the serving path's kernel.
// - pyramid_vec_kernel, several levels stored, C a multiple of 16 bytes,
//   2 <= L <= 4 (UNet3+'s decoder pools each skip to every level it
//   needs in one launch): one thread owns one 16-byte channel group of a
//   2^L x 2^L patch, reads it a level-2 cell (4 x 4 pixels, 16 loads) at
//   a time, folds the levels in registers in Morton order, V channels
//   wide, and writes each stored cell with one 16-byte store.
// - pyramid_kernel, any L, any C (the rest): one thread owns one 2^L x
//   2^L patch of one channel, reads it once, folds every level from the
//   level below it in registers (Morton order), and writes each level as
//   soon as a cell of it is complete.  Neighbouring threads take
//   neighbouring channels, so a warp's accesses are contiguous runs of
//   NHWC memory.
//
// Ragged edges: level l has H >> l rows (floor(floor(H/2)/2) == H >> 2,
// so one pass gives the reduce_window chain's answer).  The grids cover
// every cell of every level; a cell inside its level's bounds has all
// four children inside theirs, so a cell is written only when it is in
// bounds and only in-bounds cells are folded into their parents.
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
__device__ __forceinline__ T neg_inf() {
  T v;
  store_f(&v, -INFINITY);
  return v;
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

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return !(reinterpret_cast<uintptr_t>(p) & 15);
}

// C = 1, L <= 5 (2^L <= 32 V, so a top-level cell's columns lie in one
// warp).  Grid: x over groups of 16-byte column vectors of a row, y over
// bands of F = 2^L rows, z over the batch.  Every lane of a warp runs the
// shuffles, so no thread returns early: a lane past the row's end folds
// -inf and stores nothing.
template <typename T, int L>
__global__ void pyramid_c1_kernel(const T* __restrict__ x, OutPtrs outs,
                                  int H, int W) {
  constexpr int V = 16 / sizeof(T);  // columns a thread owns
  constexpr int F = 1 << L;          // rows of a band
  constexpr int G = F < 16 ? F : 16;  // rows loaded together
  using P = Pack<T, V>;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int x0 = t * V;  // first column this thread owns
  const int y0 = blockIdx.y * F;
  const int64_t b = blockIdx.z;
  // acc[l] (l = 2..L): running max, over the level-(l-1) rows folded so
  // far, of the level-(l-1) values this thread holds: V >> (l-1) cells,
  // or, once a cell is wider than V columns, one value that every lane of
  // the cell holds.  Every index is a constant after unrolling.
  float acc[L + 1][V / 2];
#pragma unroll
  for (int l = 0; l <= L; ++l)
#pragma unroll
    for (int k = 0; k < V / 2; ++k) acc[l][k] = -INFINITY;

#pragma unroll 1
  for (int g = 0; g < F; g += G) {
    // all G loads first, then the folds.  A branch between two loads
    // makes the compiler wait for the first at the join, so when every
    // row of the group is inside the image and starts on 16 bytes (each
    // row checked), the G 16-byte loads go out with no branch between
    // them; otherwise each row is read as it allows.
    P q[G];
    const T* p0 = x + ((b * H + y0 + g) * (int64_t)W + x0);  // read if in
    bool fast = x0 + V <= W && y0 + g + G <= H;
#pragma unroll
    for (int i = 0; i < G; ++i)
      fast = fast && aligned16(p0 + (int64_t)i * W);
    if (fast) {
#pragma unroll
      for (int i = 0; i < G; ++i)
        q[i] = *reinterpret_cast<const P*>(p0 + (int64_t)i * W);
    } else {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int y = y0 + g + i;
        const T* p = p0 + (int64_t)i * W;
        if (y < H && x0 + V <= W && aligned16(p)) {
          q[i] = *reinterpret_cast<const P*>(p);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k)
            q[i].v[k] = (y < H && x0 + k < W) ? p[k] : neg_inf<T>();
        }
      }
    }
#pragma unroll
    for (int i = 0; i < G; i += 2) {
      const int r = g + i;  // this level-1 row's first input row, in band
      float cur[V / 2];
#pragma unroll
      for (int k = 0; k < V / 2; ++k)
        cur[k] = max_nan(
            max_nan(load_f(&q[i].v[2 * k]), load_f(&q[i].v[2 * k + 1])),
            max_nan(load_f(&q[i + 1].v[2 * k]),
                    load_f(&q[i + 1].v[2 * k + 1])));
      {
        const int y1 = (y0 + r) >> 1, h1 = H >> 1, w1 = W >> 1;
        T* o = static_cast<T*>(outs.p[0]);
        if (o && y1 < h1) {
#pragma unroll
          for (int k = 0; k < V / 2; ++k) {
            const int x1 = (x0 >> 1) + k;
            if (x1 < w1) store_f(o + (b * h1 + y1) * w1 + x1, cur[k]);
          }
        }
      }
#pragma unroll
      for (int l = 2; l <= L; ++l) {
        // level-(l-1) values held: n (in this thread), or 1 shared by
        // the 2^(l-1) / V lanes of a cell
        const int n = (V >> (l - 1)) > 0 ? (V >> (l - 1)) : 1;
#pragma unroll
        for (int k = 0; k < V / 2; ++k)
          if (k < n) acc[l][k] = max_nan(acc[l][k], cur[k]);
        if ((r + 2) & ((1 << l) - 1)) break;  // level-l row not complete
        // fold pairs of columns: in the thread, or with the lane that
        // holds the neighbouring level-(l-1) cell
        if (n >= 2) {
#pragma unroll
          for (int k = 0; k < V / 4; ++k)
            if (2 * k < n) cur[k] = max_nan(acc[l][2 * k], acc[l][2 * k + 1]);
        } else {
          const int s = (1 << (l - 1)) / V;
          cur[0] = max_nan(acc[l][0],
                           __shfl_xor_sync(0xffffffffu, acc[l][0], s));
        }
#pragma unroll
        for (int k = 0; k < V / 2; ++k) acc[l][k] = -INFINITY;
        const int hl = H >> l, wl = W >> l, yl = (y0 + r) >> l;
        T* o = static_cast<T*>(outs.p[l - 1]);
        if (!o || yl >= hl) continue;
        if ((V >> l) > 0) {  // V >> l cells of level l in this thread
#pragma unroll
          for (int k = 0; k < V / 4; ++k) {
            const int xl = (x0 >> l) + k;
            if (k < (V >> l) && xl < wl)
              store_f(o + (b * hl + yl) * wl + xl, cur[k]);
          }
        } else if ((lane & (((1 << l) / V) - 1)) == 0) {  // first lane
          const int xl = x0 >> l;
          if (xl < wl) store_f(o + (b * hl + yl) * wl + xl, cur[0]);
        }
      }
    }
  }
}

// The 2 x 2 pixels of level-1 cell c (row-major) of level-2 cell (y2,
// x2), 16 bytes of channels each.
template <typename T, int V>
__device__ __forceinline__ void load_cell(const T* __restrict__ x, int64_t b,
                                          int H, int W, int C, int64_t row,
                                          int64_t cg, int y2, int x2, int c,
                                          Pack<T, V> (&q)[4]) {
  using P = Pack<T, V>;
  const int y1 = 2 * y2 + (c >> 1), x1 = 2 * x2 + (c & 1);
  const T* p = x + ((b * H + 2 * y1) * W + 2 * x1) * C + cg;
  q[0] = *reinterpret_cast<const P*>(p);
  q[1] = *reinterpret_cast<const P*>(p + C);
  q[2] = *reinterpret_cast<const P*>(p + row);
  q[3] = *reinterpret_cast<const P*>(p + row + C);
}

// Several levels of a C that is a multiple of V = 16 / sizeof(T), 2 <= L
// <= 4: grid as pyramid_kernel's, a thread per (patch, channel group).
template <typename T, int V, int L>
__global__ void pyramid_vec_kernel(const T* __restrict__ x, OutPtrs outs,
                                   int H, int W, int C, int tiles_w) {
  using P = Pack<T, V>;
  constexpr int S = 1 << (L - 2);  // level-2 cells per patch side
  const int groups = C / V;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= tiles_w * groups) return;
  const int64_t cg = (int64_t)(t % groups) * V;
  const int tx = t / groups;
  const int ty = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t row = (int64_t)W * C;
  const int h1 = H >> 1, w1 = W >> 1, h2 = H >> 2, w2 = W >> 2;
  // acc[l] (l = 2..L-1): running max of the level-l cells of the
  // level-(l+1) cell being folded, V channels
  float acc[L + 1][V];
#pragma unroll
  for (int l = 0; l <= L; ++l)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[l][k] = -INFINITY;

#pragma unroll 1
  for (int k2 = 0; k2 < S * S; ++k2) {
    // Morton order: every 4^(l-2) consecutive k2 complete a level-l cell
    int i = 0, j = 0;
#pragma unroll
    for (int bit = 0; bit < L - 2; ++bit) {
      j |= ((k2 >> (2 * bit)) & 1) << bit;
      i |= ((k2 >> (2 * bit + 1)) & 1) << bit;
    }
    const int y2 = ty * S + i, x2 = tx * S + j;
    // the level-2 cell's four level-1 cells (row-major), 2 x 2 pixels
    // each: all 16 loads first, with no branch between them when the
    // level-2 cell (and so each of its children) is in bounds
    P q[4][4];
    bool in[4];
    const bool all_in = y2 < h2 && x2 < w2;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int y1 = 2 * y2 + (c >> 1), x1 = 2 * x2 + (c & 1);
      in[c] = all_in || (y1 < h1 && x1 < w1);
    }
    if (all_in) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        load_cell(x, b, H, W, C, row, cg, y2, x2, c, q[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (in[c]) load_cell(x, b, H, W, C, row, cg, y2, x2, c, q[c]);
    }
    float m2[V];
#pragma unroll
    for (int k = 0; k < V; ++k) m2[k] = -INFINITY;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!in[c]) continue;
      P r;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float v =
            max_nan(max_nan(load_f(&q[c][0].v[k]), load_f(&q[c][1].v[k])),
                    max_nan(load_f(&q[c][2].v[k]), load_f(&q[c][3].v[k])));
        store_f(&r.v[k], v);
        m2[k] = max_nan(m2[k], v);
      }
      T* o = static_cast<T*>(outs.p[0]);
      const int y1 = 2 * y2 + (c >> 1), x1 = 2 * x2 + (c & 1);
      if (o) *reinterpret_cast<P*>(o + ((b * h1 + y1) * w1 + x1) * C + cg) = r;
    }
    if (all_in) {
      T* o = static_cast<T*>(outs.p[1]);
      if (o) {
        P r;
#pragma unroll
        for (int k = 0; k < V; ++k) store_f(&r.v[k], m2[k]);
        *reinterpret_cast<P*>(o + ((b * h2 + y2) * w2 + x2) * C + cg) = r;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) acc[2][k] = max_nan(acc[2][k], m2[k]);
    }
#pragma unroll
    for (int l = 3; l <= L; ++l) {
      if ((k2 + 1) & ((1 << (2 * (l - 2))) - 1)) break;
      const int hl = H >> l, wl = W >> l;
      const int yl = y2 >> (l - 2), xl = x2 >> (l - 2);
      float m[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        m[k] = acc[l - 1][k];
        acc[l - 1][k] = -INFINITY;
      }
      if (yl < hl && xl < wl) {
        T* o = static_cast<T*>(outs.p[l - 1]);
        if (o) {
          P r;
#pragma unroll
          for (int k = 0; k < V; ++k) store_f(&r.v[k], m[k]);
          *reinterpret_cast<P*>(o + ((b * hl + yl) * wl + xl) * C + cg) = r;
        }
        if (l < L)
#pragma unroll
          for (int k = 0; k < V; ++k) acc[l][k] = max_nan(acc[l][k], m[k]);
      }
    }
  }
}

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

// Threads for n work items in blocks of at most 256: whole warps, no more
// than the items need.
int block_for(int64_t n) {
  return n >= 256 ? 256 : (int)((n + 31) / 32 * 32);
}

// Launches pool_vec_kernel for level L into `out` when the shape allows
// (L <= 4, C a multiple of 16 bytes, 16-byte aligned pointers); false if
// it does not.
template <typename T>
bool launch_vec(const void* x, void* out, int64_t B, int H, int W, int C,
                int L, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (L > 4 || C % V || !aligned16(x) || !aligned16(out)) return false;
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

// Launches pyramid_c1_kernel (C == 1) when L <= 5; false if L is larger.
template <typename T>
bool launch_c1(const void* x, const OutPtrs& outs, int64_t B, int H, int W,
               int L, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (L > 5) return false;
  // vectors that cover the columns level 1 reads, 2 * (W >> 1)
  const int64_t n = ((int64_t)(W >> 1) * 2 + V - 1) / V;
  const int threads = block_for(n);
  const dim3 grid((unsigned)((n + threads - 1) / threads),
                  (unsigned)(((H >> 1) + (1 << (L - 1)) - 1) >> (L - 1)),
                  (unsigned)B);
  const T* xt = static_cast<const T*>(x);
  switch (L) {
    case 1:
      pyramid_c1_kernel<T, 1><<<grid, threads, 0, s>>>(xt, outs, H, W);
      break;
    case 2:
      pyramid_c1_kernel<T, 2><<<grid, threads, 0, s>>>(xt, outs, H, W);
      break;
    case 3:
      pyramid_c1_kernel<T, 3><<<grid, threads, 0, s>>>(xt, outs, H, W);
      break;
    case 4:
      pyramid_c1_kernel<T, 4><<<grid, threads, 0, s>>>(xt, outs, H, W);
      break;
    default:
      pyramid_c1_kernel<T, 5><<<grid, threads, 0, s>>>(xt, outs, H, W);
  }
  return true;
}

// Launches pyramid_vec_kernel when 2 <= L <= 4, C is a multiple of 16
// bytes and every pointer is 16-byte aligned; false if not.
template <typename T>
bool launch_vec_pyramid(const void* x, const OutPtrs& outs, int64_t B, int H,
                        int W, int C, int L, int tiles_h, int tiles_w,
                        cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (L < 2 || L > 4 || C % V || !aligned16(x)) return false;
  for (int l = 0; l < L; ++l)
    if (!aligned16(outs.p[l])) return false;
  const int64_t n = (int64_t)tiles_w * (C / V);
  const int threads = block_for(n);
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)tiles_h,
                  (unsigned)B);
  const T* xt = static_cast<const T*>(x);
  switch (L) {
    case 2:
      pyramid_vec_kernel<T, V, 2><<<grid, threads, 0, s>>>(xt, outs, H, W, C,
                                                           tiles_w);
      break;
    case 3:
      pyramid_vec_kernel<T, V, 3><<<grid, threads, 0, s>>>(xt, outs, H, W, C,
                                                           tiles_w);
      break;
    default:
      pyramid_vec_kernel<T, V, 4><<<grid, threads, 0, s>>>(xt, outs, H, W, C,
                                                           tiles_w);
  }
  return true;
}

template <typename T>
void launch(const void* x, const OutPtrs& outs, int64_t B, int H, int W,
            int C, int L, int tiles_h, int tiles_w, cudaStream_t s) {
  int stored = 0;
  for (int l = 0; l < L; ++l) stored += outs.p[l] != nullptr;
  const bool last_only = stored == 1 && outs.p[L - 1];
  if (C == 1) {
    if (launch_c1<T>(x, outs, B, H, W, L, s)) return;
  } else if (last_only) {
    if (launch_vec<T>(x, outs.p[L - 1], B, H, W, C, L, s)) return;
  } else if (launch_vec_pyramid<T>(x, outs, B, H, W, C, L, tiles_h, tiles_w,
                                   s)) {
    return;
  }
  const int threads = 256;
  const dim3 grid((unsigned)(((int64_t)tiles_w * C + threads - 1) / threads),
                  (unsigned)tiles_h, (unsigned)B);
  pyramid_kernel<T><<<grid, threads, 0, s>>>(static_cast<const T*>(x), outs,
                                             H, W, C, L, tiles_w);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  out_ptrs: host array of L device
// pointers, level 1 first, each an NHWC buffer of (B, H>>l, W>>l, C), or
// null for a level the caller does not want.
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(x, outs, B, H, W, C, L, tiles_h, tiles_w, s);
  else
    launch<__nv_bfloat16>(x, outs, B, H, W, C, L, tiles_h, tiles_w, s);
  return (int)cudaGetLastError();
}

const char* tpuseg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
