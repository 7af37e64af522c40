// Gradient of the max pool with window = stride = F = 2^m (m = 1..6),
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
// element.  Each kernel writes every element of a window, zeros included,
// one 16-byte store each, so dx needs no memset, and recomputes the
// choice from x (y is not read).  Each moves 16 bytes of channels (8 bf16
// or 4 f32) a thread; a C that is not a multiple of 16 bytes (or a
// misaligned pointer) takes the same kernel with one channel per thread.
// The launcher (`route`; tpuseg_maxpool_backward_route names it, and
// tpuseg_maxpool_backward reports the one it launched) takes
// pool_backward_kernel at F = 2, pool_backward_rows_kernel at F = 4 .. 16,
// pool_backward_block_kernel at F = 32 and pool_backward_wide_kernel at
// F = 64.
// - pool_backward_kernel, F = 2: one thread per window and channel group
//   walks the window (4 loads) and writes it (4 stores).
// - pool_backward_rows_kernel, F = 4 .. 16: one thread per window, channel
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
//   with no barrier, were slower at every F (PERF.md).  It took F = 32
//   too (a block of 8 windows of 32 rows, 16 loads in flight a thread):
//   there a warp's load touches 8 windows 2 KB apart, and 8 of a window's
//   32 threads join its 32 row summaries serially while the other 24 wait
//   (0.0894 ms against a bound of 0.0401 at (16, 256, 256, 32) bf16 on an
//   NVIDIA H100 80GB HBM3 at 700 W; PERF.md).
// - pool_backward_block_kernel, F = 32 (the pool by 32 of a dense-input
//   encoder or a full-scale decoder at depth 5): one block of 256 threads
//   per window and chunk of up to 32 channels.  The chunk's 32 x 32
//   pixels (64 KB at 32 bf16 channels) come into shared memory by
//   cp.async, neighbouring threads on neighbouring 16-byte vectors (a
//   warp copies 512 contiguous bytes of a row), every copy of the block
//   in flight at once; three blocks share an SM.  Then warp w walks
//   window rows 4w .. 4w + 3 and lane c channel c, the four rows side by
//   side (four independent chains, conflict-free 2- or 4-byte reads); the
//   thread joins its four row summaries in row order by the rule above,
//   and lane c of warp 0 the 8 warps' in warp order.  It reads g, marks
//   the chosen pixel in a bitmap of the window, and every thread then
//   writes its vectors with 16-byte stores: zeros, or the gradient where
//   the bitmap marks a choice.  Designs with no shared-memory stage were
//   slower at (16, 256, 256, 32) bf16: a thread holding 16 pixels of one
//   channel group in registers and choosing by order-free maxima of
//   (value, index) keys, and the same folding its keys as the loads
//   arrived (PERF.md).
// - pool_backward_wide_kernel, F = 64 (the pool by 64 of a dense-input
//   encoder's tap 0 at depth 6, a full-scale decoder's skip 0 at depth
//   7): a 64 x 64 window of 32 bf16 channels is 256 KB, past the 227 KB
//   of shared memory a block may have, so nothing is staged.  dx is zero
//   but at one element of each window and channel, so a thread writes
//   zeros over each vector it reads as it reads it, and only the choice
//   needs the whole window: one block of 256 threads per window and
//   chunk of GB <= 16 channel groups (the next power of two of the
//   groups, so one chunk for up to 16 groups), thread t owning group
//   t % GB and the run t / GB of R = 16 GB consecutive pixels of the
//   window in row-major order (a row of 64 pixels at 32 bf16 channels),
//   read 16 loads at a time.  The runs' summaries (the walk's value and
//   index, and whether the run held a NaN) join in run order by the rule
//   above, by __shfl_xor_sync within a warp and through shared memory
//   across the 8 warps; then one thread a channel writes the gradient at
//   the chosen pixel over its zero (the barrier orders the two stores).
//   The block reads the window once and writes it once, with a few
//   2- or 4-byte stores more.
// The ragged last rows and columns are covered by threads of the windows
// just past the pooled region, which write zeros to the elements that
// exist.
//
// Checks: the CPU tests run the plain versions against the JAX package
// (`JAX_PLATFORMS=cpu python -m pytest tests/test_torch_*.py`); on a card,
// `python3 chip_smoke.py` builds this file, holds every call of every path
// and the edge cases to the plain version bit for bit, names the kernel
// each takes and times it (phase 3), and `python3 -m pytest --noconftest
// -q tests/test_torch_cuda.py` runs the `cuda`-marked tests.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

// cp.async of 16 bytes from global into shared memory, and the wait for
// every such copy of the thread.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The walk's summary of a run of elements: the selected value and index,
// and whether the run held a NaN.  join(a, b) is the walk over a then b
// (the rule above).
struct Walk {
  float val;
  int idx;
  bool nan;
};
__device__ __forceinline__ Walk join(const Walk& a, const Walk& b) {
  const bool take = b.nan || !(a.val >= b.val);
  return {take ? b.val : a.val, take ? b.idx : a.idx, a.nan || b.nan};
}

// F = 32: a block per window and chunk of up to 32 channels (grid: x over
// (window column, chunk), the ragged window column included; y over window
// rows, the ragged one included; z over the batch), 256 threads, the
// chunk's 1,024 pixels staged in shared memory as [pixel][32 channels].
// Warp w walks rows 4w .. 4w + 3, lane c channel c, the four rows side by
// side; the row summaries join in row order in the thread, the 8 warps'
// in warp order in lane c of warp 0.
template <typename T, int V>
__global__ void __launch_bounds__(256)
    pool_backward_block_kernel(const T* __restrict__ x,
                               const T* __restrict__ g, T* __restrict__ dx,
                               int H, int W, int C) {
  constexpr int F = 32, CB = 32;  // window side, channels of a chunk
  using P = Pack<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                     // [F * F][CB]
  float* sval = reinterpret_cast<float*>(xs + F * F * CB);  // [8][CB]
  int* sidx = reinterpret_cast<int*>(sval + 8 * CB);      // [8][CB]
  int* snan = sidx + 8 * CB;                              // [8][CB]
  int* sel = snan + 8 * CB;                               // [CB]
  unsigned* hit = reinterpret_cast<unsigned*>(sel + CB);  // [F * F]
  T* gsel = reinterpret_cast<T*>(hit + F * F);            // [CB]
  const int chunks = (C + CB - 1) / CB;
  const int chunk = blockIdx.x % chunks;
  const int cb = min(CB, C - chunk * CB);  // channels of this chunk
  const int xw = blockIdx.x / chunks, yw = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int hf = H / F, wf = W / F;
  const int64_t base = ((b * H + (int64_t)F * yw) * W + (int64_t)F * xw) * C +
                       (int64_t)chunk * CB;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int vpp = cb / V;  // vectors of a pixel in the chunk
  // (pixel, vector) of vector t and the step of a 256-vector stride
  const int px0 = t / vpp, vi0 = t - px0 * vpp;
  const int dpx = 256 / vpp, dvi = 256 - dpx * vpp;
  P zero;
#pragma unroll
  for (int k = 0; k < V; ++k) zero.v[k] = from_f<T>(0.0f);
  if (yw >= hf || xw >= wf) {
    // a window the floor cut off: zero the elements that exist
    for (int v = t, px = px0, vi = vi0; v < F * F * vpp; v += 256) {
      const int i = px / F, j = px % F;
      if (F * yw + i < H && F * xw + j < W)
        *reinterpret_cast<P*>(dx + base + ((int64_t)i * W + j) * C + vi * V) =
            zero;
      px += dpx;
      vi += dvi;
      if (vi >= vpp) {
        vi -= vpp;
        ++px;
      }
    }
    return;
  }
  // the chunk's window into shared memory, every copy in flight at once
  for (int v = t, px = px0, vi = vi0; v < F * F * vpp; v += 256) {
    const T* src = x + base + ((int64_t)(px / F) * W + px % F) * C + vi * V;
    T* dst = xs + px * CB + vi * V;
    if (V * sizeof(T) == 16)
      cp_async16(dst, src);
    else
      *reinterpret_cast<P*>(dst) = *reinterpret_cast<const P*>(src);
    px += dpx;
    vi += dvi;
    if (vi >= vpp) {
      vi -= vpp;
      ++px;
    }
  }
  for (int px = t; px < F * F; px += 256) hit[px] = 0;
  cp_async_wait_all();
  __syncthreads();
  if (lane < cb) {
    Walk r[4];
    const T* col = xs + lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float e = to_f(col[(4 * warp + q) * F * CB]);
      r[q] = {e, (4 * warp + q) * F, e != e};
    }
#pragma unroll 4
    for (int j = 1; j < F; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = (4 * warp + q) * F + j;
        const float e = to_f(col[p * CB]);
        r[q].nan = r[q].nan || e != e;
        if (!(r[q].val >= e)) {
          r[q].val = e;
          r[q].idx = p;
        }
      }
    const Walk w = join(join(r[0], r[1]), join(r[2], r[3]));
    sval[warp * CB + lane] = w.val;
    sidx[warp * CB + lane] = w.idx;
    snan[warp * CB + lane] = w.nan;
  }
  __syncthreads();
  if (warp == 0 && lane < cb) {
    Walk w = {sval[lane], sidx[lane], snan[lane] != 0};
#pragma unroll
    for (int k = 1; k < 8; ++k)
      w = join(w, {sval[k * CB + lane], sidx[k * CB + lane],
                   snan[k * CB + lane] != 0});
    sel[lane] = w.idx;
    gsel[lane] = g[((b * hf + yw) * wf + xw) * C + chunk * CB + lane];
    atomicOr(&hit[w.idx], 1u << (lane / V));
  }
  __syncthreads();
  // every element of the window: the gradient where chosen, else zero
  for (int v = t, px = px0, vi = vi0; v < F * F * vpp; v += 256) {
    P out = zero;
    if (hit[px] & (1u << vi))
#pragma unroll
      for (int k = 0; k < V; ++k)
        if (sel[vi * V + k] == px) out.v[k] = gsel[vi * V + k];
    *reinterpret_cast<P*>(dx + base + ((int64_t)(px / F) * W + px % F) * C +
                          vi * V) = out;
    px += dpx;
    vi += dvi;
    if (vi >= vpp) {
      vi -= vpp;
      ++px;
    }
  }
}

// F = 64: a block per window and chunk of GB channel groups (grid: x over
// (window column, chunk), the ragged window column included; y over
// window rows, the ragged one included; z over the batch), 256 threads.
// GB is a power of two, at most 16; lanes whose group is past C (the last
// chunk's) read the chunk's first group, join, and store nothing.
template <typename T, int V>
__global__ void __launch_bounds__(256)
    pool_backward_wide_kernel(const T* __restrict__ x,
                              const T* __restrict__ g, T* __restrict__ dx,
                              int H, int W, int C, int GB) {
  constexpr int F = 64, U = 16;  // window side, loads in flight a thread
  using P = Pack<T, V>;
  __shared__ float sval[8][16][V];  // [warp][group in chunk][channel]
  __shared__ int sidx[8][16][V];
  __shared__ unsigned char snan[8][16][V];
  const int groups = C / V;
  const int chunks = (groups + GB - 1) / GB;
  const int chunk = blockIdx.x % chunks;
  const int xw = blockIdx.x / chunks, yw = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int gl = t & (GB - 1), run = t / GB;
  const int grp = chunk * GB + gl;
  const bool live = grp < groups;
  const int R = 16 * GB;  // pixels of a run: F * F * GB / 256
  const int hf = H / F, wf = W / F;
  const T* xs = x + ((b * H + (int64_t)F * yw) * W + (int64_t)F * xw) * C +
                (int64_t)(live ? grp : chunk * GB) * V;
  T* ds = dx + (xs - x);
  P zero;
#pragma unroll
  for (int k = 0; k < V; ++k) zero.v[k] = from_f<T>(0.0f);
  if (yw >= hf || xw >= wf) {
    // a window the floor cut off: zero the elements that exist
    if (!live) return;
    for (int p = run * R; p < run * R + R; ++p) {
      const int i = p / F, j = p % F;
      if (F * yw + i < H && F * xw + j < W)
        *reinterpret_cast<P*>(ds + ((int64_t)i * W + j) * C) = zero;
    }
    return;
  }
  // the run's walk, per channel, from a value every element replaces
  Walk w[V];
#pragma unroll
  for (int k = 0; k < V; ++k) w[k] = {NAN, run * R, false};
#pragma unroll 1
  for (int p0 = run * R; p0 < run * R + R; p0 += U) {
    P q[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u;
      q[u] = *reinterpret_cast<const P*>(xs + ((int64_t)(p / F) * W + p % F) *
                                                  C);
    }
    if (live)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + u;
        *reinterpret_cast<P*>(ds + ((int64_t)(p / F) * W + p % F) * C) = zero;
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float e = to_f(q[u].v[k]);
        w[k].nan = w[k].nan || e != e;
        if (!(w[k].val >= e)) {
          w[k].val = e;
          w[k].idx = p0 + u;
        }
      }
  }
  // the warp's runs in run order: lanes d apart hold neighbouring blocks
  // of runs, the one whose bit d is clear the earlier
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    if (d < GB) continue;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const Walk o = {__shfl_xor_sync(0xffffffffu, w[k].val, d),
                      __shfl_xor_sync(0xffffffffu, w[k].idx, d),
                      __shfl_xor_sync(0xffffffffu, (int)w[k].nan, d) != 0};
      w[k] = (lane & d) ? join(o, w[k]) : join(w[k], o);
    }
  }
  if (lane < GB)
#pragma unroll
    for (int k = 0; k < V; ++k) {
      sval[warp][gl][k] = w[k].val;
      sidx[warp][gl][k] = w[k].idx;
      snan[warp][gl][k] = w[k].nan;
    }
  __syncthreads();
  // the 8 warps in warp order, one thread a channel of the chunk
  if (t < GB * V) {
    const int g2 = t / V, k = t % V;
    const int c = (chunk * GB + g2) * V + k;
    if (chunk * GB + g2 < groups) {
      Walk r = {sval[0][g2][k], sidx[0][g2][k], snan[0][g2][k] != 0};
#pragma unroll
      for (int wp = 1; wp < 8; ++wp)
        r = join(r, {sval[wp][g2][k], sidx[wp][g2][k], snan[wp][g2][k] != 0});
      const int i = r.idx / F, j = r.idx % F;
      dx[((b * H + (int64_t)F * yw + i) * W + (int64_t)F * xw + j) * C + c] =
          g[((b * hf + yw) * wf + xw) * C + c];
    }
  }
}

// Channel groups of a pool_backward_wide_kernel chunk: the next power of
// two of the groups, at most 16.
int wide_chunk(int groups) {
  int gb = 1;
  while (gb < groups && gb < 16) gb <<= 1;
  return gb;
}

// Shared memory of a pool_backward_block_kernel block.
template <typename T>
constexpr int block_smem() {
  return 32 * 32 * 32 * sizeof(T) + 3 * 8 * 32 * 4 + 32 * 4 + 32 * 32 * 4 +
         32 * sizeof(T);
}

// The kernel the launcher picks for a call.
enum Route { kNone, kWindow, kRows, kBlock, kWide };

const char* const kRouteNames[] = {
    "none", "pool_backward_kernel", "pool_backward_rows_kernel",
    "pool_backward_block_kernel", "pool_backward_wide_kernel"};

Route route(int64_t B, int H, int W, int F) {
  if (B == 0 || H == 0 || W == 0) return kNone;
  return F == 2 ? kWindow : F == 32 ? kBlock : F == 64 ? kWide : kRows;
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
int launch_block(int64_t B, int H, int W, int C, cudaStream_t s, const T* x,
                 const T* g, T* dx) {
  constexpr int smem = block_smem<T>();
  // the opt-in above 48 KB, a setting of the current device: every launch
  const cudaError_t err =
      cudaFuncSetAttribute(pool_backward_block_kernel<T, V>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((int64_t)((W + 31) / 32) * ((C + 31) / 32)),
                  (unsigned)((H + 31) / 32), (unsigned)B);
  pool_backward_block_kernel<T, V><<<grid, 256, smem, s>>>(x, g, dx, H, W, C);
  return (int)cudaSuccess;
}

template <typename T, int V>
void launch_wide(int64_t B, int H, int W, int C, cudaStream_t s, const T* x,
                 const T* g, T* dx) {
  const int groups = C / V, gb = wide_chunk(groups);
  const dim3 grid(
      (unsigned)((int64_t)((W + 63) / 64) * ((groups + gb - 1) / gb)),
      (unsigned)((H + 63) / 64), (unsigned)B);
  pool_backward_wide_kernel<T, V><<<grid, 256, 0, s>>>(x, g, dx, H, W, C, gb);
}

// The kernel of route r (kRows for F = 4 .. 16); returns a CUDA error code
// from before the launch (0 if there was none).
template <typename T, int V>
int launch_v(Route r, int64_t B, int H, int W, int C, int F, cudaStream_t s,
             const T* x, const T* g, T* dx) {
  if (r == kWindow) {
    const int threads = 256;
    const int64_t n = (int64_t)((W + 1) / 2) * (C / V);
    const dim3 grid((unsigned)((n + threads - 1) / threads),
                    (unsigned)((H + 1) / 2), (unsigned)B);
    pool_backward_kernel<T, V><<<grid, threads, 0, s>>>(x, g, dx, H, W, C);
  } else if (r == kBlock) {
    return launch_block<T, V>(B, H, W, C, s, x, g, dx);
  } else if (r == kWide) {
    launch_wide<T, V>(B, H, W, C, s, x, g, dx);
  } else {
    switch (F) {
      case 4:
        launch_rows<T, V, 4>(B, H, W, C, s, x, g, dx);
        break;
      case 8:
        launch_rows<T, V, 8>(B, H, W, C, s, x, g, dx);
        break;
      default:
        launch_rows<T, V, 16>(B, H, W, C, s, x, g, dx);
    }
  }
  return (int)cudaSuccess;
}

template <typename T>
int launch(Route r, const void* x, const void* g, void* dx, int64_t B, int H,
           int W, int C, int F, cudaStream_t s) {
  constexpr int V16 = 16 / sizeof(T);
  const bool vec = vector_path<T>(x, g, dx, C);
  const int64_t n = (int64_t)((W + F - 1) / F) * (C / (vec ? V16 : 1));
  if (n > 0x7fffffffLL || (H + F - 1) / F > 65535 || B > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  const int err = vec ? launch_v<T, V16>(r, B, H, W, C, F, s, xt, gt, dt)
                      : launch_v<T, 1>(r, B, H, W, C, F, s, xt, gt, dt);
  return err ? err : (int)cudaGetLastError();
}

bool valid(int64_t B, int H, int W, int C, int dtype, int factor) {
  return !(B < 0 || H < 0 || W < 0 || C < 1 || (dtype != 0 && dtype != 1) ||
           (factor != 2 && factor != 4 && factor != 8 && factor != 16 &&
            factor != 32 && factor != 64));
}

// The name of route r's kernel for these arguments, with "<V=1>" where it
// takes one channel a thread.
const char* route_name(Route r, const void* x, const void* g,
                       const void* dx, int dtype, int C) {
  static const char* const kScalarNames[] = {
      "none", "pool_backward_kernel<V=1>", "pool_backward_rows_kernel<V=1>",
      "pool_backward_block_kernel<V=1>", "pool_backward_wide_kernel<V=1>"};
  const bool vec = dtype == 0 ? vector_path<float>(x, g, dx, C)
                              : vector_path<__nv_bfloat16>(x, g, dx, C);
  return (vec ? kRouteNames : kScalarNames)[r];
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; factor: 2, 4, 8, 16, 32 or 64.  x and
// dx: NHWC
// (B, H, W, C); g: NHWC (B, H / factor, W / factor, C).  Launches on
// `stream`, sets *launched to the name of the
// kernel it launched ("none" for an empty x) and returns
// cudaGetLastError() (0 on success).
int tpuseg_maxpool_backward(const void* x, const void* g, void* dx, int dtype,
                            int64_t B, int H, int W, int C, int factor,
                            const char** launched, void* stream) {
  *launched = kRouteNames[kNone];
  if (!valid(B, H, W, C, dtype, factor)) return (int)cudaErrorInvalidValue;
  Route r = route(B, H, W, factor);
  if (r == kNone) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0
      ? launch<float>(r, x, g, dx, B, H, W, C, factor, s)
      : launch<__nv_bfloat16>(r, x, g, dx, B, H, W, C, factor, s);
  *launched = route_name(r, x, g, dx, dtype, C);
  return err;
}

// The kernel tpuseg_maxpool_backward launches for the same arguments
// ("none" if it launches nothing), with "<V=1>" where it takes
// one channel a thread; null if it refuses them.
const char* tpuseg_maxpool_backward_route(const void* x, const void* g,
                                          const void* dx, int dtype,
                                          int64_t B, int H, int W, int C,
                                          int factor) {
  if (!valid(B, H, W, C, dtype, factor)) return nullptr;
  return route_name(route(B, H, W, factor), x, g, dx, dtype, C);
}

}  // extern "C"
