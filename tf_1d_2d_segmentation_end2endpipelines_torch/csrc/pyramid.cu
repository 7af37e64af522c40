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
// addresses its pixels directly.  Five kernels, chosen by the launcher
// from the call's shape:
//
// - pyramid_c1_kernel, C = 1 (the deep-supervision mask, the TPU kernel's
//   own case), L <= 7 (2^L <= 32 V: a top cell's columns lie in one warp;
//   levels 6-7 are the targets of a full-scale decoder with deep
//   supervision at depth 6-7): a block owns a band of 2^L rows of one
//   image and a thread 16 bytes of each row (4 f32 or 8 bf16 columns), so
//   a warp
//   reads 512 contiguous bytes of a row and a thread has up to 16
//   independent 16-byte loads in flight.  The thread folds its rows in
//   registers, the levels whose cells fit in its 16 bytes across its own
//   vector, and the wider ones across lanes with __shfl_xor_sync.  A row
//   whose start is not 16-byte aligned (W * sizeof(T) not a multiple of
//   16, or an offset base pointer), and the ragged last vector of a row,
//   are read element by element in the same kernel.
// - pool_vec_kernel, level 1 alone, with C a multiple of 16 bytes of
//   channels (every encoder pool of the UNet family): one thread per
//   output pixel and 16-byte channel group, one 16-byte load per pixel of
//   its 2 x 2 window and one 16-byte store.  This is the serving path's
//   kernel.  It took levels 2-4 alone too, where a thread walks its whole
//   2^L x 2^L window one 16-byte load at a time and a warp's load touches
//   8 windows 2^L pixels apart: at L = 4 on a (16, 256, 256, 32) bf16
//   input that is 16,384 threads of 256 loads each; at L = 5 it took
//   0.2087 ms against a bound of 0.0201 (NVIDIA H100 80GB HBM3, 700 W;
//   PERF.md).  It stays the route for a C so wide that one output pixel's
//   folded band row passes pool_rows_kernel's shared memory.
// - pool_rows_kernel, level L alone, on the contiguous NHWC rows: a block
//   reads the band of 2^L input rows of one output row over a span of
//   whole output pixels and all their channels (about 32 KB of input)
//   with 16-byte loads, neighbouring threads on neighbouring 16-byte
//   vectors (a warp's load is 512 contiguous bytes), 8 loads in flight a
//   thread; it folds the band's rows in registers (bf16 pairs by
//   __hmax2_nan) into shared memory, then the columns.  Its floor is one
//   read of the input and one write of the output.  Two variants:
//   * <V=16B>, L = 2..4 with C a multiple of 16 bytes (AHNet's ResPaths
//     pool each encoder tap by 2^(i-k), its tap projectors on a backbone
//     likewise): the columns fold whole 16-byte vectors, and each output
//     vector leaves with one 16-byte store.  Four blocks of 256 threads
//     share an SM, up to 128 KB of loads in flight there.
//   * the element fold, L <= 5 with C not a multiple of 16 bytes (the
//     MultiRes encoder pools: 31 .. 255 and 51 .. 426 channels) when
//     every input and output row starts on 16 bytes (W * C and (W >> L)
//     * C elements multiples of 16 bytes, aligned pointers): the columns
//     fold element by element into a second shared buffer, and the span
//     leaves 16 bytes of consecutive output elements a thread, one
//     division per 16 bytes.  pyramid_kernel took these calls before,
//     one 2-byte load per thread and instruction with a 32-bit division
//     each, and was bound by its load and store instructions, not by
//     bytes (20% of the bound, slower than F.max_pool2d).
// - pyramid_vec_kernel, several levels stored, C a multiple of 16 bytes,
//   2 <= L <= 6 (UNet3+'s decoder pools each skip to every level it
//   needs in one launch; the dense-input encoders pool each tap to every
//   level a deeper block reads, 1 .. 6 at depth 6): one thread owns one
//   16-byte channel group of a 2^L x 2^L patch, reads it a level-2 cell
//   (4 x 4 pixels, 16 loads) at a time, folds the levels in registers in
//   Morton order, V channels wide, and writes each stored cell with one
//   16-byte store.  At L = 5 a patch is 64 such cells, and a thread a
//   patch left 4,096 threads for a (16, 256, 256, 32) bf16 input, each
//   with 64 rounds of loads in turn; there the 16 lanes of a warp share a
//   patch, each folds an 8 x 8 quarter of a quarter (levels 1-3, four
//   rounds), and levels 4 and 5 are folded across the lanes with
//   __shfl_xor_sync (65,536 threads).  At L = 6 (the KSSNet and UNet4P
//   encoders' tap 0 at depth 6, a full-scale decoder's skip 0 at depth 7,
//   which stores level 6 alone) a patch has 64 lanes: each 16-lane
//   quarter folds a 32 x 32 quarter as at L = 5, and level 6 joins the
//   four quarters through shared memory (65,536 threads, 4 rounds of 16
//   loads each, for a (16, 256, 256, 32) bf16 input, where pyramid_kernel
//   gave 8,192 threads 4,096 loads each in turn).  It takes levels 5 and
//   6 alone too.
// - pyramid_kernel, any L, any C (the rest: several levels stored at a C
//   that is not a multiple of 16 bytes, rows that do not start on 16
//   bytes, L > 6; a one-channel mask at L > 7): one thread owns one
//   2^L x 2^L patch of one channel, reads it once, folds every level from the level below it in
//   registers (Morton order), and writes each level as soon as a cell of
//   it is complete.  Neighbouring threads take neighbouring channels, so
//   a warp's accesses are contiguous runs of NHWC memory.
//
// The launcher picks one from the shape, the levels stored and the
// pointers' alignment (`route`; tpuseg_maxpool_pyramid_route names it,
// and tpuseg_maxpool_pyramid reports the one it launched); nothing falls
// back at run time.
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
// Which of +0.0 and -0.0 comes out of a window holding both depends on
// the order of the comparisons, here as in torch.amax; every other
// output is exact.
//
// Checks: the CPU tests run the plain versions against the JAX package
// (`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py`); on a card,
// `python3 chip_smoke.py` builds this file, holds every call of every path
// and the edge cases to the plain version bit for bit (their inputs hold
// no -0.0), names the kernel each takes and times it (phase 3), and
// `python3 -m pytest --noconftest -q tests/test_torch_cuda.py` runs the
// `cuda`-marked tests.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

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

// C = 1, L <= 7 (2^L <= 32 V, so a top-level cell's columns lie in one
// warp: f32 holds 4 columns a lane, 128 a warp).  Grid: x over groups of
// 16-byte column vectors of a row, y over bands of F = 2^L rows, z over
// the batch.  Every lane of a warp runs the
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
// <= 6: grid as pyramid_kernel's, (1 << 2Q) consecutive threads per
// (patch, channel group).  With Q = 0 a thread folds its whole patch.
// With Q > 0 the patch is split into 4^Q sub-patches of side 2^(L - Q),
// one a lane, numbered in Morton order by the lane's low 2Q bits; each
// lane folds levels 1 .. L - Q of its own, and the last Q levels are
// folded across the lanes (xor 1 and 2 give level L - Q + 1, xor 4 and 8
// the next), the lane whose low bits are 0 storing the cell.  At Q = 3
// (L = 6) the last level joins four quarters of 16 lanes through shared
// memory.  There a warp holds the same quarter of two neighbouring
// channel groups' patches where the groups are even in number (lanes 16
// apart take neighbouring 16-byte groups, so a warp's loads and stores
// cover whole 32-byte sectors, as at L = 5: 128 threads a pair of
// groups), else two quarters of one group's patch (64 threads a patch);
// the block is a multiple of either.  No thread returns early there: every
// lane of a patch runs the shuffles and the barrier, and a lane past the
// grid's patches folds -inf and stores nothing.
template <typename T, int V, int L, int Q>
__global__ void pyramid_vec_kernel(const T* __restrict__ x, OutPtrs outs,
                                   int H, int W, int C, int tiles_w) {
  using P = Pack<T, V>;
  constexpr int LT = L - Q;         // levels a lane folds on its own
  constexpr int S = 1 << (LT - 2);  // level-2 cells per sub-patch side
  const int groups = C / V;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  // Q = 3: the stride between a patch's quarters of 16 lanes
  const int qs = groups % 2 == 0 ? 32 : 16;
  int sub, patch;  // the lane's sub-patch (Morton), (patch, group) index
  if (Q == 3 && qs == 32) {
    const int pair = t >> 7;  // (patch column, pair of groups)
    sub = (t & 15) | (((t >> 5) & 3) << 4);
    patch = (pair / (groups / 2)) * groups + (pair % (groups / 2)) * 2 +
            ((t >> 4) & 1);
  } else {
    sub = t & ((1 << (2 * Q)) - 1);
    patch = t >> (2 * Q);
  }
  const bool live = patch < tiles_w * groups;
  if (Q == 0 && !live) return;
  const int64_t cg = (int64_t)(patch % groups) * V;
  const int tx = patch / groups;
  const int ty = blockIdx.y;
  int sy = 0, sx = 0;  // the sub-patch in the patch (Morton order)
#pragma unroll
  for (int bit = 0; bit < Q; ++bit) {
    sx |= ((sub >> (2 * bit)) & 1) << bit;
    sy |= ((sub >> (2 * bit + 1)) & 1) << bit;
  }
  const int py = (ty << Q) + sy, px = (tx << Q) + sx;  // level-LT cell
  const int64_t b = blockIdx.z;
  const int64_t row = (int64_t)W * C;
  const int h1 = H >> 1, w1 = W >> 1, h2 = H >> 2, w2 = W >> 2;
  // acc[l] (l = 2..LT-1): running max of the level-l cells of the
  // level-(l+1) cell being folded, V channels; top: the level-LT cell
  float acc[LT + 1][V];
  float top[V];
#pragma unroll
  for (int l = 0; l <= LT; ++l)
#pragma unroll
    for (int k = 0; k < V; ++k) acc[l][k] = -INFINITY;
#pragma unroll
  for (int k = 0; k < V; ++k) top[k] = -INFINITY;

#pragma unroll 1
  for (int k2 = 0; k2 < S * S; ++k2) {
    // Morton order: every 4^(l-2) consecutive k2 complete a level-l cell
    int i = 0, j = 0;
#pragma unroll
    for (int bit = 0; bit < LT - 2; ++bit) {
      j |= ((k2 >> (2 * bit)) & 1) << bit;
      i |= ((k2 >> (2 * bit + 1)) & 1) << bit;
    }
    const int y2 = py * S + i, x2 = px * S + j;
    // the level-2 cell's four level-1 cells (row-major), 2 x 2 pixels
    // each: all 16 loads first, with no branch between them when the
    // level-2 cell (and so each of its children) is in bounds
    P q[4][4];
    bool in[4];
    const bool all_in = live && y2 < h2 && x2 < w2;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int y1 = 2 * y2 + (c >> 1), x1 = 2 * x2 + (c & 1);
      in[c] = all_in || (live && y1 < h1 && x1 < w1);
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
      if (LT == 2)
#pragma unroll
        for (int k = 0; k < V; ++k) top[k] = m2[k];
    }
#pragma unroll
    for (int l = 3; l <= LT; ++l) {
      if ((k2 + 1) & ((1 << (2 * (l - 2))) - 1)) break;
      const int hl = H >> l, wl = W >> l;
      const int yl = y2 >> (l - 2), xl = x2 >> (l - 2);
      float m[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        m[k] = acc[l - 1][k];
        acc[l - 1][k] = -INFINITY;
      }
      if (live && yl < hl && xl < wl) {
        T* o = static_cast<T*>(outs.p[l - 1]);
        if (o) {
          P r;
#pragma unroll
          for (int k = 0; k < V; ++k) store_f(&r.v[k], m[k]);
          *reinterpret_cast<P*>(o + ((b * hl + yl) * wl + xl) * C + cg) = r;
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
          if (l < LT) acc[l][k] = max_nan(acc[l][k], m[k]);
          else top[k] = m[k];
        }
      }
    }
  }
  // levels LT + 1 .. L across the lanes of the patch
  __shared__ float xchg[Q == 3 ? 256 : 1][V];  // Q = 3: the quarters' tops
#pragma unroll
  for (int q = 1; q <= Q; ++q) {
    const int l = LT + q;
    if (q < 3) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        top[k] = max_nan(
            top[k], __shfl_xor_sync(0xffffffffu, top[k], 1 << (2 * q - 2)));
        top[k] = max_nan(
            top[k], __shfl_xor_sync(0xffffffffu, top[k], 1 << (2 * q - 1)));
      }
    } else {  // the quarter-0 lane folds the other three quarters' tops
#pragma unroll
      for (int k = 0; k < V; ++k) xchg[threadIdx.x][k] = top[k];
      __syncthreads();
      if ((sub >> 4) == 0)
#pragma unroll
        for (int j = 1; j < 4; ++j)
#pragma unroll
          for (int k = 0; k < V; ++k)
            top[k] = max_nan(top[k], xchg[threadIdx.x + j * qs][k]);
    }
    const int hl = H >> l, wl = W >> l, yl = py >> q, xl = px >> q;
    if (!(live && yl < hl && xl < wl)) {
#pragma unroll
      for (int k = 0; k < V; ++k) top[k] = -INFINITY;
      continue;
    }
    T* o = static_cast<T*>(outs.p[l - 1]);
    if (o && (sub & ((1 << (2 * q)) - 1)) == 0) {
      P r;
#pragma unroll
      for (int k = 0; k < V; ++k) store_f(&r.v[k], top[k]);
      *reinterpret_cast<P*>(o + ((b * hl + yl) * wl + xl) * C + cg) = r;
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

// Max of two values of T in T, NaN first: bf16 natively (HMNMX2), no
// conversion to float and back.
__device__ __forceinline__ float vmax(float a, float b) {
  return max_nan(a, b);
}
__device__ __forceinline__ __nv_bfloat16 vmax(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return __hmax_nan(a, b);
}

// r = max(r, q), 16 bytes element by element (bf16 two at a time).
__device__ __forceinline__ void vmax16(Pack<float, 4>& r,
                                       const Pack<float, 4>& q) {
#pragma unroll
  for (int k = 0; k < 4; ++k) r.v[k] = max_nan(r.v[k], q.v[k]);
}
__device__ __forceinline__ void vmax16(Pack<__nv_bfloat16, 8>& r,
                                       const Pack<__nv_bfloat16, 8>& q) {
  __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(r.v);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(q.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = __hmax2_nan(a[k], b[k]);
}

// Level L alone (F = 2^L) with every input and output row starting on
// 16 bytes (W * C and (W / F) * C elements multiples of 16 bytes, both
// pointers aligned).  A row of NHWC memory is one contiguous run of W * C
// elements whatever C is, so the kernel works on rows, not channels.  A
// block owns one band of F input rows of one image over a span of `span`
// output pixels (rows_span), in two or three steps with a barrier after
// the first and second:
// 1. vertical fold: each thread reads 16 bytes of the span in each of the
//    F rows (8 16-byte loads in flight a thread, F rows of one vector or
//    8 rows of F / 8 vectors, so registers stay under 64 and four blocks
//    share an SM), folds them in registers and writes the folded row to
//    shared memory;
// 2. horizontal fold, VEC (C a multiple of V = 16 / sizeof(T), G = C / V
//    vectors a pixel): output vector o (pixel o / G, group o % G) is the
//    max of the F folded vectors (F * (o / G) + j) * G + o % G, j < F,
//    read 16 bytes a lane, and leaves with one 16-byte store;
//    otherwise (the span a multiple of 8 pixels, so every span, and the
//    last one cut by the row's end, starts and ends on 16 bytes): output
//    element e (pixel px = e / C, channel c) is the max over j < F of
//    row[e + (F - 1) * px * C + j * C].  Neighbouring lanes take
//    neighbouring elements, so their shared-memory reads fall on
//    neighbouring 2- or 4-byte words (no bank conflicts); a thread steps
//    (px, c) by whole blocks with no division in the loop.  The results go
//    to a second buffer in shared memory;
// 3. (element fold only) the span's output leaves with one 16-byte store
//    a thread.
// Max stays in T (bf16's own max instructions): converting each element
// to float and back made an earlier version of this kernel bound by its
// conversion instructions, not by bytes.  The order of comparisons (rows,
// then columns) is not the plain version's: no NaN-free maximum changes,
// NaN still wins, and only which of +0.0 and -0.0 comes out of a window
// holding both may.
template <typename T, int F, bool VEC>
__global__ void __launch_bounds__(256, 4)
    pool_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int H,
                     int W, int C, int span) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = F < 8 ? F : 8;  // rows loaded together
  constexpr int U = 8 / R;          // 16-byte columns folded together
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int wo = W / F;
  const int x0 = blockIdx.x * span;  // the span's first output pixel
  const int n = min(span, wo - x0);
  const int yo = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t in_row = (int64_t)W * C;
  const T* src = x + ((b * H + (int64_t)F * yo) * W + (int64_t)F * x0) * C;
  T* dst = out + ((b * (H / F) + yo) * wo + x0) * (int64_t)C;
  T* row = reinterpret_cast<T*>(smem);  // the band folded over its rows
  const int n_out = n * C;
  const int nv_in = F * n_out / V;      // 16-byte columns of the band
  const int step = blockDim.x;
  for (int v0 = threadIdx.x; v0 < nv_in; v0 += U * step) {
    P r[U];
#pragma unroll
    for (int g = 0; g < F; g += R) {
      P q[U][R];
      const T* p0 = src + (int64_t)g * in_row + (int64_t)v0 * V;
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (v0 + u * step < nv_in)
#pragma unroll
          for (int i = 0; i < R; ++i)
            q[u][i] = *reinterpret_cast<const P*>(p0 + i * in_row +
                                                  (int64_t)u * step * V);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (g == 0) r[u] = q[u][0];
#pragma unroll
        for (int i = g == 0 ? 1 : 0; i < R; ++i) vmax16(r[u], q[u][i]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v0 + u * step < nv_in)
        *reinterpret_cast<P*>(row + (v0 + u * step) * V) = r[u];
  }
  __syncthreads();
  if (VEC) {
    const int G = C / V;
    const P* folded = reinterpret_cast<const P*>(row);
    P* to = reinterpret_cast<P*>(dst);
    for (int o = threadIdx.x; o < n * G; o += step) {
      const int px = o / G;
      const P* p = folded + (F * px * G + (o - px * G));
      P m = p[0];
#pragma unroll
      for (int j = 1; j < F; ++j) vmax16(m, p[j * G]);
      to[o] = m;
    }
    return;
  }
  T* folded = row + F * n_out;  // the span's output (16-byte start)
  int px = threadIdx.x / C, c = threadIdx.x - px * C;
  const int dpx = step / C, dc = step - dpx * C;
  for (int e = threadIdx.x; e < n_out; e += step) {
    const T* p = row + e + (F - 1) * px * C;
    T m = p[0];
#pragma unroll
    for (int j = 1; j < F; ++j) m = vmax(m, p[j * C]);
    folded[e] = m;
    px += dpx;
    c += dc;
    if (c >= C) {
      c -= C;
      ++px;
    }
  }
  __syncthreads();
  for (int ov = threadIdx.x; ov < n_out / V; ov += step)
    *reinterpret_cast<P*>(dst + ov * V) =
        *reinterpret_cast<const P*>(folded + ov * V);
}

// Shared memory pool_rows_kernel may give one span, and the input a block
// aims at.  Blocks of 256 threads with 32 KB of input measured as fast as
// 64 KB on AHNet's large single-level calls and faster on the small ones,
// and faster than blocks cut to the threads the band's vectors keep busy
// (at L = 4 on 32 bf16 channels, 128 of the 256) (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md).  At L = 1 this aim gives the MultiRes pools' spans
// (about 128 pixels at 31 channels) as before.
constexpr int kRowsSmemMax = 48 * 1024;
constexpr int kRowsInAim = 32 * 1024;

// Output pixels of one pool_rows_kernel span: about kRowsInAim bytes of
// input a block, the row cut into spans of equal widths (not 88 + 40
// pixels, which leave the second block half idle), a multiple of 8
// pixels where C is not a multiple of 16 bytes; 0 if the least span's
// shared memory (the folded row, and for the element fold the output)
// passes kRowsSmemMax.
template <typename T>
int rows_span(int W, int C, int L) {
  const bool vec = C % (16 / sizeof(T)) == 0;
  const int q = vec ? 1 : 8;  // the span's granule
  const int64_t px_in = ((int64_t)C << (2 * L)) * sizeof(T);
  const int64_t px_smem = (((int64_t)C << L) + (vec ? 0 : C)) * sizeof(T);
  if (q * px_smem > kRowsSmemMax) return 0;
  int64_t most = kRowsInAim / px_in;
  if (most > kRowsSmemMax / px_smem) most = kRowsSmemMax / px_smem;
  most = most / q * q;
  if (most < q) most = q;
  const int wo = W >> L;
  const int64_t spans = (wo + most - 1) / most;
  return (int)(((wo + spans - 1) / spans + q - 1) / q * q);
}

// Threads for n work items in blocks of at most 256: whole warps, no more
// than the items need.
int block_for(int64_t n) {
  return n >= 256 ? 256 : (int)((n + 31) / 32 * 32);
}

// The kernel the launcher picks for a call.
enum Route {
  kNone,        // nothing to store: no launch
  kC1,          // pyramid_c1_kernel
  kVec,         // pool_vec_kernel
  kRowsVec,     // pool_rows_kernel, VEC
  kRows,        // pool_rows_kernel, the element fold
  kVecPyramid,  // pyramid_vec_kernel
  kScalar,      // pyramid_kernel
};

const char* const kRouteNames[] = {
    "none",           "pyramid_c1_kernel", "pool_vec_kernel",
    "pool_rows_kernel<V=16B>", "pool_rows_kernel", "pyramid_vec_kernel",
    "pyramid_kernel"};

// The launcher's choice, from the shape, the levels stored and the
// pointers' alignment; tiles_h and tiles_w cover level 1.
template <typename T>
Route route(const void* x, const OutPtrs& outs, int64_t B, int H, int W,
            int C, int L, int tiles_h, int tiles_w) {
  constexpr int V = 16 / sizeof(T);
  if (B == 0 || tiles_h == 0 || tiles_w == 0) return kNone;
  int stored = 0;
  for (int l = 0; l < L; ++l) stored += outs.p[l] != nullptr;
  if (C == 1) return L <= 7 ? kC1 : kScalar;
  if (stored == 1 && outs.p[L - 1]) {  // level L alone
    if ((H >> L) == 0 || (W >> L) == 0) return kNone;
    if (L > 6 || !aligned16(x) || !aligned16(outs.p[L - 1])) return kScalar;
    if (C % V == 0) {
      if (L >= 5) return kVecPyramid;
      return L >= 2 && rows_span<T>(W, C, L) > 0 ? kRowsVec : kVec;
    }
    if (L > 5) return kScalar;
    const int64_t row_in = (int64_t)W * C * sizeof(T);
    const int64_t row_out = (int64_t)(W >> L) * C * sizeof(T);
    if (row_in % 16 == 0 && row_out % 16 == 0 && rows_span<T>(W, C, L) > 0)
      return kRows;
    return kScalar;
  }
  if (L < 2 || L > 6 || C % V || !aligned16(x)) return kScalar;
  for (int l = 0; l < L; ++l)
    if (!aligned16(outs.p[l])) return kScalar;
  return kVecPyramid;
}

// pool_rows_kernel for level L into `out`: VEC at L = 2..4 only.
template <typename T, bool VEC>
void launch_rows(const void* x, void* out, int64_t B, int H, int W, int C,
                 int L, cudaStream_t s) {
  const int span = rows_span<T>(W, C, L);
  const int64_t folded = (int64_t)span * C << L;
  const int smem = (int)((VEC ? folded : folded + (int64_t)span * C) *
                         sizeof(T));
  const dim3 grid((unsigned)(((W >> L) + span - 1) / span),
                  (unsigned)(H >> L), (unsigned)B);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  switch (L) {
    case 2:
      pool_rows_kernel<T, 4, VEC><<<grid, 256, smem, s>>>(xt, ot, H, W, C,
                                                          span);
      break;
    case 3:
      pool_rows_kernel<T, 8, VEC><<<grid, 256, smem, s>>>(xt, ot, H, W, C,
                                                          span);
      break;
    case 4:
      pool_rows_kernel<T, 16, VEC><<<grid, 256, smem, s>>>(xt, ot, H, W, C,
                                                           span);
      break;
    default:
      if constexpr (!VEC) {
        if (L == 1)
          pool_rows_kernel<T, 2, false><<<grid, 256, smem, s>>>(xt, ot, H, W,
                                                                C, span);
        else
          pool_rows_kernel<T, 32, false><<<grid, 256, smem, s>>>(xt, ot, H,
                                                                 W, C, span);
      }
  }
}

// pool_vec_kernel for level L into `out`.
template <typename T>
void launch_vec(const void* x, void* out, int64_t B, int H, int W, int C,
                int L, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
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
}

// pyramid_c1_kernel (C == 1, L <= 7).
template <typename T>
void launch_c1(const void* x, const OutPtrs& outs, int64_t B, int H, int W,
               int L, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
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
    case 5:
      pyramid_c1_kernel<T, 5><<<grid, threads, 0, s>>>(xt, outs, H, W);
      break;
    case 6:
      pyramid_c1_kernel<T, 6><<<grid, threads, 0, s>>>(xt, outs, H, W);
      break;
    default:
      pyramid_c1_kernel<T, 7><<<grid, threads, 0, s>>>(xt, outs, H, W);
  }
}

// Lanes a pyramid_vec_kernel patch: 16 at L = 5, 64 at L = 6, else 1.
int vec_lanes(int L) { return L == 5 ? 16 : L == 6 ? 64 : 1; }

// pyramid_vec_kernel (2 <= L <= 6, C a multiple of 16 bytes, every
// pointer 16-byte aligned); at L = 5, 16 lanes a patch, at L = 6, 64.
template <typename T>
void launch_vec_pyramid(const void* x, const OutPtrs& outs, int64_t B, int H,
                        int W, int C, int L, int tiles_h, int tiles_w,
                        cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int lanes = vec_lanes(L);
  const int64_t n = (int64_t)tiles_w * (C / V) * lanes;
  const int threads = block_for(n);
  const dim3 grid((unsigned)((n + threads - 1) / threads), (unsigned)tiles_h,
                  (unsigned)B);
  const T* xt = static_cast<const T*>(x);
  switch (L) {
    case 2:
      pyramid_vec_kernel<T, V, 2, 0><<<grid, threads, 0, s>>>(xt, outs, H, W,
                                                              C, tiles_w);
      break;
    case 3:
      pyramid_vec_kernel<T, V, 3, 0><<<grid, threads, 0, s>>>(xt, outs, H, W,
                                                              C, tiles_w);
      break;
    case 4:
      pyramid_vec_kernel<T, V, 4, 0><<<grid, threads, 0, s>>>(xt, outs, H, W,
                                                              C, tiles_w);
      break;
    case 5:
      pyramid_vec_kernel<T, V, 5, 2><<<grid, threads, 0, s>>>(xt, outs, H, W,
                                                              C, tiles_w);
      break;
    default:
      pyramid_vec_kernel<T, V, 6, 3><<<grid, threads, 0, s>>>(xt, outs, H, W,
                                                              C, tiles_w);
  }
}

template <typename T>
void launch(Route r, const void* x, const OutPtrs& outs, int64_t B, int H,
            int W, int C, int L, int tiles_h, int tiles_w, cudaStream_t s) {
  switch (r) {
    case kNone:
      return;
    case kC1:
      launch_c1<T>(x, outs, B, H, W, L, s);
      return;
    case kVec:
      launch_vec<T>(x, outs.p[L - 1], B, H, W, C, L, s);
      return;
    case kRowsVec:
      launch_rows<T, true>(x, outs.p[L - 1], B, H, W, C, L, s);
      return;
    case kRows:
      launch_rows<T, false>(x, outs.p[L - 1], B, H, W, C, L, s);
      return;
    case kVecPyramid:
      launch_vec_pyramid<T>(x, outs, B, H, W, C, L, tiles_h, tiles_w, s);
      return;
    case kScalar: {
      const int threads = 256;
      const dim3 grid(
          (unsigned)(((int64_t)tiles_w * C + threads - 1) / threads),
          (unsigned)tiles_h, (unsigned)B);
      pyramid_kernel<T><<<grid, threads, 0, s>>>(static_cast<const T*>(x),
                                                 outs, H, W, C, L, tiles_w);
    }
  }
}

// The arguments of tpuseg_maxpool_pyramid, checked, and the route they
// take; returns a CUDA error code (0 if they are valid).
struct Call {
  OutPtrs outs = {};
  int tiles_h = 0, tiles_w = 0;
  Route route = kNone;
};

// `force`, if not null, must name pyramid_kernel: that kernel in place of
// the launcher's choice, so that the card's checks time a call's kernel
// beside the one its calls took before.
int prepare(const void* x, const void* out_ptrs, int dtype, int64_t B, int H,
            int W, int C, int L, const char* force, Call* call) {
  if (L < 1 || L > kMaxLevels || B < 0 || H < 0 || W < 0 || C < 1 ||
      (dtype != 0 && dtype != 1) ||
      (force && strcmp(force, kRouteNames[kScalar])))
    return (int)cudaErrorInvalidValue;
  const uint64_t* ptrs = static_cast<const uint64_t*>(out_ptrs);
  for (int l = 0; l < L; ++l)
    call->outs.p[l] = reinterpret_cast<void*>(ptrs[l]);
  const int side1 = 1 << (L - 1);
  call->tiles_h = ((H >> 1) + side1 - 1) / side1;
  call->tiles_w = ((W >> 1) + side1 - 1) / side1;
  // threads along x: a patch and channel a thread, 16 at L = 5, 64 at 6
  if ((int64_t)call->tiles_w * C * vec_lanes(L) > 0x7fffffffLL ||
      call->tiles_h > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  call->route = dtype == 0
      ? route<float>(x, call->outs, B, H, W, C, L, call->tiles_h,
                     call->tiles_w)
      : route<__nv_bfloat16>(x, call->outs, B, H, W, C, L, call->tiles_h,
                             call->tiles_w);
  if (force && call->route != kNone) call->route = kScalar;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  out_ptrs: host array of L device
// pointers, level 1 first, each an NHWC buffer of (B, H>>l, W>>l, C), or
// null for a level the caller does not want.  force: null, or
// "pyramid_kernel" to launch that kernel in the launcher's place (to time
// it beside the launcher's choice).  Launches on `stream`, sets *launched
// to the name of the kernel it launched ("none" if it launched nothing)
// and returns cudaGetLastError() (0 on success).
int tpuseg_maxpool_pyramid(const void* x, const void* out_ptrs, int dtype,
                           int64_t B, int H, int W, int C, int L,
                           const char* force, const char** launched,
                           void* stream) {
  Call c;
  *launched = kRouteNames[kNone];
  const int err = prepare(x, out_ptrs, dtype, B, H, W, C, L, force, &c);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch<float>(c.route, x, c.outs, B, H, W, C, L, c.tiles_h, c.tiles_w, s);
  else
    launch<__nv_bfloat16>(c.route, x, c.outs, B, H, W, C, L, c.tiles_h,
                          c.tiles_w, s);
  *launched = kRouteNames[c.route];
  return (int)cudaGetLastError();
}

// The kernel tpuseg_maxpool_pyramid launches for the same arguments
// ("none" if it launches nothing), or null if it refuses them.
const char* tpuseg_maxpool_pyramid_route(const void* x, const void* out_ptrs,
                                         int dtype, int64_t B, int H, int W,
                                         int C, int L) {
  Call c;
  if (prepare(x, out_ptrs, dtype, B, H, W, C, L, nullptr, &c)) return nullptr;
  return kRouteNames[c.route];
}

const char* tpuseg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
