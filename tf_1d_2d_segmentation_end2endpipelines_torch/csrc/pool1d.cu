// Max pools over the length axis of 1D signals, forward and gradient, on
// (B, L, C) memory (a (B, C, 1, L) channels_last tensor):
//
// - the 1D pyramid: [maxpool(x, 2**l) for l in 1..levels] (levels 1..6),
//   window = stride = 2**l along L, VALID floor truncation (level l has
//   L >> l positions), a subset of the levels stored;
// - the 1D pool gradient: dx = g routed to one element of each window of
//   F = 2**m positions (m = 1..6).
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
// - pool1d_flat_kernel<T, L, MODE>, the forward of every call whose
//   length is a multiple of 2^L and whose pointers start on 16 bytes
//   (every main-path call: 1024, 512, 256 .. 16 samples).  There output
//   row p of signal b at level L is the max of input rows 2^L p ..
//   2^L p + 2^L - 1, so the input of a run of output rows is one
//   contiguous run of memory whatever C is, and the batch drops out: the
//   call is B * (L_in >> L) top rows of 2^L input rows each.
//   * <V=16B>, C a multiple of 16 bytes (the encoder pools, 32 .. 1408
//     channels; UNet3+'s skip pyramids; MLMRSNet_V2's taps): a thread a
//     16-byte channel group of up to 8 rows of a top row (2, 4 or 8 lanes
//     a top row at L = 4, 5, 6), its loads issued together, the levels folded
//     in registers in T (bf16 pairs by __hmax2_nan), the levels above 3
//     across the lanes by __shfl_xor_sync, each stored cell written with
//     one 16-byte store; two 32-bit divisions a thread for its (row,
//     group).
//   * <C=1>, the deep-supervision mask: a thread owns max(2^L, V)
//     consecutive positions of the B * length run (16-byte loads: 4 f32
//     or 8 bf16 positions a vector; at L = 6, 16 f32 or 8 bf16 vectors),
//     folds every level in registers, within a vector and across them,
//     and stores each level's values
//     with the widest aligned stores they fill.
//   * the staged fold, any other C (the MultiRes pools, 31 * 2^k
//     channels; Dense_Inception_UNet's 33): a block owns a span of top
//     rows whose every level's output starts on 16 bytes (span * C *
//     sizeof(T) a multiple of 16), about 16 KB of input, read with 16-byte
//     loads (neighbouring threads on neighbouring vectors, 4 loads in
//     flight a thread) into shared memory; level l is folded element by
//     element from level l - 1 there (element e, cell q = e / C, channel
//     c: the max of elements e + q C and e + q C + C of the level below;
//     a thread steps (q, c) by the block's width with one division per
//     thread, none in the loop), and every stored level leaves with
//     16-byte stores.  The kernel it replaces, one channel a thread with
//     a 64-bit and two 32-bit divisions per 4 or 2 bytes, was bound by
//     its load and store instructions, not by bytes (35-58% of the bound
//     on the MultiRes calls; NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// - pool1d_kernel<T, V, L>: the rest (a length that 2^L does not divide,
//   a pointer off 16 bytes, a staged span past its shared memory, as the
//   staged fold of most odd C at L = 6, whose every level's output, 2^7 -
//   1 times a top row, passes 48 KB in the least span).  One thread owns
//   one group of V channels of a span of 2^L positions: it reads the span a
//   level-1 cell (two positions) at a time, folds the levels in registers
//   and stores each wanted cell as soon as it is complete.  Neighbouring
//   threads take neighbouring channel groups of the same span.  V = 16 /
//   sizeof(T) (16-byte loads and stores) when C is a multiple of 16 bytes
//   and every pointer is 16-byte aligned; otherwise V = 1.
// - pool1d_backward_kernel<T, V, F, S>: S lanes own one window and one
//   group of V channels, each a run of F / S positions: a lane walks its
//   run in order (F / S independent loads; 32 at F = 32 and 64, where S =
//   2 keeps an f32 lane's 16-byte loads at 128 registers), keeping a
//   selected element and
//   moving to the next element e whenever !(selected >= e) --
//   select_and_scatter's rule with the max pool's `ge` select: the first
//   maximum for finite values, and a NaN is passed over by the next
//   element -- and at S = 2 the two runs' summaries (the walk's value and
//   position, and whether the run held a NaN) join in run order across the
//   lane pair by __shfl_xor_sync (the later run's choice wins if it held a
//   NaN or its value is not <= the earlier's), then each lane writes its
//   run, the gradient at the chosen position and zeros elsewhere, so dx
//   needs no memset.  The threads of the
//   window just past the pooled region write zeros to the positions that
//   the floor cut off.
//
// The launcher picks the kernel from the length, C and the pointers'
// alignment (tpuseg_maxpool1d_*_route name it, and the launch entries
// report the one they launched); nothing falls back at run time.  Max
// propagates NaN, as XLA's max and torch.amax do.  The flat kernel folds
// in another order than the plain version: no NaN-free maximum changes,
// NaN still wins, and only which of +0.0 and -0.0 comes out of a window
// holding both may.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels1d = 6;

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

// Max of two values of T in T, NaN first: bf16 natively, no conversion
// to float and back.
__device__ __forceinline__ float vmax(float a, float b) {
  return max_nan(a, b);
}
__device__ __forceinline__ __nv_bfloat16 vmax(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return __hmax_nan(a, b);
}

// r = max(r, q), 16 bytes element by element (bf16 two at a time).
__device__ __forceinline__ void vmax16(Vec<float, 4>& r,
                                       const Vec<float, 4>& q) {
#pragma unroll
  for (int k = 0; k < 4; ++k) r.v[k] = max_nan(r.v[k], q.v[k]);
}
__device__ __forceinline__ void vmax16(Vec<__nv_bfloat16, 8>& r,
                                       const Vec<__nv_bfloat16, 8>& q) {
  __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(r.v);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(q.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = __hmax2_nan(a[k], b[k]);
}

// pool1d_flat_kernel, <V=16B>: a top row's 2^L input vectors of channel
// group g (G = C / V groups) are x[(r 2^L + j) G + g], j < 2^L.  Lane s of
// S = 2^L / K consecutive lanes (o = (r G + g) S + s) loads K = 2^min(L, 3)
// of them together, with no branch between the loads, folds levels
// 1 .. log2 K in registers (after level l, q[i], i < K >> l, holds its
// level-l cell i) and the levels above across the S lanes with
// __shfl_xor_sync: at L = 5 a thread per top row had 32 loads in turn and
// left 32,768 threads for a (128, 1024, 32) f32 call.
template <int V, typename T>
__device__ __forceinline__ Vec<T, V> shfl_xor16(const Vec<T, V>& a, int d) {
  static_assert(sizeof(Vec<T, V>) == 16, "16-byte vectors");
  Vec<T, V> b;
  const unsigned* ai = reinterpret_cast<const unsigned*>(a.v);
  unsigned* bi = reinterpret_cast<unsigned*>(b.v);
#pragma unroll
  for (int k = 0; k < 4; ++k) bi[k] = __shfl_xor_sync(0xffffffffu, ai[k], d);
  return b;
}

template <typename T, int L>
__device__ __forceinline__ void flat_vec(const T* __restrict__ x,
                                         const OutPtrs1d& outs, int C,
                                         int rows) {
  constexpr int V = 16 / sizeof(T);
  constexpr int F = 1 << L;
  constexpr int LK = L < 3 ? L : 3;
  constexpr int K = 1 << LK;
  constexpr int S = F / K;
  using P = Vec<T, V>;
  const int G = C / V;
  const int total = rows * G * S;
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  // a warp wholly past the end leaves; the others run every shuffle (a
  // lane's S - 1 partners are in range with it: total is a multiple of S)
  if (o - (int)(threadIdx.x & 31) >= total) return;
  const bool in = o < total;
  const int s = o % S;
  const int u = o / S;
  const int r = u / G;
  const int g = u - r * G;
  // a lane past the end reads the first top row's vectors (no branch
  // between the loads) and stores nothing
  const P* src = reinterpret_cast<const P*>(x) +
                 (in ? (r * F + s * K) * G + g : 0);
  P q[K];
#pragma unroll
  for (int i = 0; i < K; ++i) q[i] = src[i * G];
#pragma unroll
  for (int l = 1; l <= LK; ++l) {
#pragma unroll
    for (int i = 0; i < (K >> l); ++i) {
      P m = q[2 * i];
      vmax16(m, q[2 * i + 1]);
      q[i] = m;
    }
    P* out = static_cast<P*>(outs.p[l - 1]);
    if (out && in) {
#pragma unroll
      for (int i = 0; i < (K >> l); ++i)
        out[(r * (F >> l) + s * (K >> l) + i) * G + g] = q[i];
    }
  }
#pragma unroll
  for (int l = LK + 1; l <= L; ++l) {
    const int d = 1 << (l - LK - 1);  // the lane holding the other half
    vmax16(q[0], shfl_xor16<V>(q[0], d));
    P* out = static_cast<P*>(outs.p[l - 1]);
    if (out && in && (s & (2 * d - 1)) == 0)
      out[(r * (F >> l) + (s >> (l - LK))) * G + g] = q[0];
  }
}

// pool1d_flat_kernel<C=1>, the deep-supervision mask: the signals are one
// run of B * length positions, and thread t owns positions [t P, t P + P),
// P = max(2^L, V): it loads them as P / V 16-byte vectors, folds every
// level in registers, within a vector and across them, and stores its
// P >> l level-l values with the widest aligned stores they fill.
template <typename T, int N>
__device__ __forceinline__ void store_run(T* dst, const T* v) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (N <= V) {
    Vec<T, N> w;
#pragma unroll
    for (int k = 0; k < N; ++k) w.v[k] = v[k];
    *reinterpret_cast<Vec<T, N>*>(dst) = w;
  } else {
#pragma unroll
    for (int h = 0; h < N / V; ++h) store_run<T, V>(dst + h * V, v + h * V);
  }
}

// Levels l .. L of flat_c1 from a[], which holds P level-(l-1) values.
template <typename T, int P, int L, int l>
__device__ __forceinline__ void fold_c1(T (&a)[P], const OutPtrs1d& outs,
                                        int t) {
  if constexpr (l <= L) {
#pragma unroll
    for (int i = 0; i < (P >> l); ++i) a[i] = vmax(a[2 * i], a[2 * i + 1]);
    T* out = static_cast<T*>(outs.p[l - 1]);
    if (out) store_run<T, (P >> l)>(out + t * (P >> l), a);
    fold_c1<T, P, L, l + 1>(a, outs, t);
  }
}

template <typename T, int L>
__device__ __forceinline__ void flat_c1(const T* __restrict__ x,
                                        const OutPtrs1d& outs, int n) {
  constexpr int V = 16 / sizeof(T);
  constexpr int F = 1 << L;
  constexpr int P = F > V ? F : V;
  using Q = Vec<T, V>;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t * P >= n) return;
  T a[P];
#pragma unroll
  for (int h = 0; h < P / V; ++h) {
    const Q q = reinterpret_cast<const Q*>(x)[t * (P / V) + h];
#pragma unroll
    for (int k = 0; k < V; ++k) a[h * V + k] = q.v[k];
  }
  fold_c1<T, P, L, 1>(a, outs, t);
}

// pool1d_flat_kernel, the staged fold: block b owns top rows [b span,
// b span + n), n = min(span, rows - b span).  Shared memory holds the
// input run (level 0, span 2^L C elements) and then each level l (span
// 2^(L-l) C elements), every buffer starting on 16 bytes.
template <typename T, int L>
__device__ __forceinline__ void flat_staged(const T* __restrict__ x,
                                            const OutPtrs1d& outs, int C,
                                            int rows, int span) {
  constexpr int V = 16 / sizeof(T);
  constexpr int F = 1 << L;
  constexpr int U = 4;  // 16-byte loads in flight a thread
  using P = Vec<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf = reinterpret_cast<T*>(smem);
  const int r0 = blockIdx.x * span;
  const int n = min(span, rows - r0);
  const int tid = threadIdx.x, step = blockDim.x;
  const int m_in = n * F * C;
  const T* src = x + r0 * F * C;
  const int nv = m_in / V;  // whole vectors; only the last block has a tail
  for (int v = tid; v < nv; v += U * step) {
    P q[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v + u * step < nv)
        q[u] = reinterpret_cast<const P*>(src)[v + u * step];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (v + u * step < nv) reinterpret_cast<P*>(buf)[v + u * step] = q[u];
  }
  for (int e = nv * V + tid; e < m_in; e += step) buf[e] = src[e];
  __syncthreads();
  const int q0 = tid / C, c0 = tid - q0 * C;
  const int dq = step / C, dc = step - dq * C;
  const T* prev = buf;
  T* cur = buf + span * F * C;
#pragma unroll
  for (int l = 1; l <= L; ++l) {
    const int m = n * (F >> l) * C;
    int q = q0, c = c0;
    for (int e = tid; e < m; e += step) {
      const int i = e + q * C;
      cur[e] = vmax(prev[i], prev[i + C]);
      q += dq;
      c += dc;
      if (c >= C) {
        c -= C;
        ++q;
      }
    }
    __syncthreads();
    prev = cur;
    cur += span * (F >> l) * C;
  }
  const T* level = buf + span * F * C;
#pragma unroll
  for (int l = 1; l <= L; ++l) {
    T* out = static_cast<T*>(outs.p[l - 1]);
    if (out) {
      out += r0 * (F >> l) * C;
      const int m = n * (F >> l) * C;
      const int mv = m / V;
      for (int v = tid; v < mv; v += step)
        reinterpret_cast<P*>(out)[v] = reinterpret_cast<const P*>(level)[v];
      for (int e = mv * V + tid; e < m; e += step) out[e] = level[e];
    }
    level += span * (F >> l) * C;
  }
}

// The flat walk of a call whose length 2^L divides (every main-path
// call): `rows` top rows (B * (length >> L)); `span` top rows a block
// (the staged fold only).
enum FlatMode { kFlatVecMode, kFlatStagedMode, kFlatC1Mode };

template <typename T, int L, int MODE>
__global__ void __launch_bounds__(256)
    pool1d_flat_kernel(const T* __restrict__ x, OutPtrs1d outs, int C,
                       int rows, int span) {
  if constexpr (MODE == kFlatVecMode)
    flat_vec<T, L>(x, outs, C, rows);
  else if constexpr (MODE == kFlatC1Mode)
    flat_c1<T, L>(x, outs, rows << L);
  else
    flat_staged<T, L>(x, outs, C, rows, span);
}

// grid: x over (batch, window, channel group, lane of the window)
// quadruples, flattened; the windows include the ragged one past the
// pooled region.  The S lanes of a window are neighbours (S divides 32),
// in or past the end together, and on the same branch.
template <typename T, int V, int F, int S>
__global__ void pool1d_backward_kernel(const T* __restrict__ x,
                                       const T* __restrict__ g,
                                       T* __restrict__ dx, int64_t B,
                                       int Len, int C, int windows) {
  constexpr int FL = F / S;  // positions of a lane's run
  const int groups = C / V;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t per_b = (int64_t)windows * groups;
  if (t >= B * per_b * S) return;
  const int s = (int)(t % S);
  const int64_t u = t / S;
  const int64_t b = u / per_b;
  const int r = (int)(u - b * per_b);
  const int grp = r % groups;
  const int w = r / groups;
  const int c0 = grp * V;
  const int lf = Len / F;
  const int64_t base = (b * Len + (int64_t)w * F + s * FL) * C + c0;
  float zero[V];
#pragma unroll
  for (int k = 0; k < V; ++k) zero[k] = 0.0f;
  if (w >= lf) {  // the ragged tail: zeros where positions exist
    for (int j = 0; j < FL && w * F + s * FL + j < Len; ++j)
      store<T, V>(dx + base + (int64_t)j * C, zero);
    return;
  }
  float sel_val[V];
  int sel[V];
  bool nan[V];
  load<T, V>(x + base, sel_val);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sel[k] = s * FL;
    nan[k] = sel_val[k] != sel_val[k];
  }
#pragma unroll
  for (int j = 1; j < FL; ++j) {
    float e[V];
    load<T, V>(x + base + (int64_t)j * C, e);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      nan[k] = nan[k] || e[k] != e[k];
      if (!(sel_val[k] >= e[k])) {
        sel_val[k] = e[k];
        sel[k] = s * FL + j;
      }
    }
  }
  if (S == 2) {  // the runs in order: lane s = 0 holds the earlier
    const unsigned pair = 3u << ((threadIdx.x & 31) & ~1u);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float ov = __shfl_xor_sync(pair, sel_val[k], 1);
      const int os = __shfl_xor_sync(pair, sel[k], 1);
      const bool on = __shfl_xor_sync(pair, (int)nan[k], 1) != 0;
      // the later run's choice wins if that run held a NaN or the
      // earlier run's value is not >= its value; lane 0 then takes its
      // partner's choice, lane 1 otherwise
      const bool later = s == 0 ? (on || !(sel_val[k] >= ov))
                                : (nan[k] || !(ov >= sel_val[k]));
      if (later == (s == 0)) sel[k] = os;
    }
  }
  float gv[V];
  load<T, V>(g + (b * lf + w) * C + c0, gv);
#pragma unroll
  for (int j = 0; j < FL; ++j) {
    float o[V];
#pragma unroll
    for (int k = 0; k < V; ++k) o[k] = sel[k] == s * FL + j ? gv[k] : 0.0f;
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

enum Route1d {
  kNone1d, kVec1d, kScalar1d, kFlatVec1d, kFlat1d, kFlatC11d
};

const char* const kPyramid1dNames[] = {
    "none", "pool1d_kernel<V=16B>", "pool1d_kernel<V=1>",
    "pool1d_flat_kernel<V=16B>", "pool1d_flat_kernel",
    "pool1d_flat_kernel<C=1>"};
const char* const kBackward1dNames[] = {"none",
                                        "pool1d_backward_kernel<V=16B>",
                                        "pool1d_backward_kernel<V=1>"};

// The staged fold's shared memory a block may use (the input run and
// every level: span * C * (2^(L+1) - 1) elements), the input it aims at,
// and the blocks it keeps at least, where the call has the rows for them
// (two on each of the H100's 132 SMs: a call of a few hundred KB, as the
// deep-supervision mask's, would otherwise run on a few SMs).
constexpr int kFlatSmemMax = 48 * 1024;
constexpr int kFlatInAim = 16 * 1024;
constexpr int kFlatMinBlocks = 264;

// Top rows of one staged span: a multiple of the rows that bring every
// level's output to a 16-byte boundary, about kFlatInAim bytes of input,
// no fewer than kFlatMinBlocks blocks where `rows` allows; 0 if the least
// such span passes kFlatSmemMax.
template <typename T>
int flat_span(int rows, int C, int L) {
  const int64_t bytes = (int64_t)C * sizeof(T);
  const int64_t low = bytes & -bytes;       // gcd(bytes, 16) below 16
  const int q = low >= 16 ? 1 : (int)(16 / low);
  const int64_t row_in = bytes << L;
  const int64_t row_smem = bytes * ((2 << L) - 1);
  const int64_t most = kFlatSmemMax / row_smem / q * q;
  if (most < q) return 0;
  int64_t span = kFlatInAim / row_in / q * q;
  const int64_t par = (rows + kFlatMinBlocks - 1) / kFlatMinBlocks;
  if (span > (par + q - 1) / q * q) span = (par + q - 1) / q * q;
  if (span < q) span = q;
  return (int)(span > most ? most : span);
}

// The launcher's choice (and, for the staged fold, its span).
template <typename T>
Route1d pyramid_route(const void* x, const OutPtrs1d& outs, int64_t B,
                      int Len, int C, int L, int* span) {
  if (B == 0 || (Len >> 1) == 0) return kNone1d;
  bool aligned = aligned16(x);
  for (int l = 0; l < L; ++l)
    if (outs.p[l] && !aligned16(outs.p[l])) aligned = false;
  constexpr int V = 16 / sizeof(T);
  const bool vec = C % V == 0;
  if (aligned && Len % (1 << L) == 0 && B * Len * C <= 0x7fffffffLL) {
    if (vec) return kFlatVec1d;
    const int per_thread = (1 << L) > V ? (1 << L) : V;  // flat_c1's P
    if (C == 1 && B * Len % per_thread == 0) return kFlatC11d;
    *span = flat_span<T>((int)(B * (Len >> L)), C, L);
    if (*span > 0) return kFlat1d;
  }
  return vec && aligned ? kVec1d : kScalar1d;
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
    case 4:
      pool1d_kernel<T, V, 4><<<grid, threads, 0, s>>>(x, outs, B, Len, C,
                                                      spans);
      break;
    case 5:
      pool1d_kernel<T, V, 5><<<grid, threads, 0, s>>>(x, outs, B, Len, C,
                                                      spans);
      break;
    default:
      pool1d_kernel<T, V, 6><<<grid, threads, 0, s>>>(x, outs, B, Len, C,
                                                      spans);
  }
}

// Threads a block for n threads in all: 256, or fewer where that keeps a
// block on each of the H100's 132 SMs (at L = 5 the deep-supervision
// mask's 128 x 1024 positions are 4,096 threads: 16 blocks of 256).
int threads_for(int64_t n) {
  const int64_t per_sm = (n + 131) / 132;
  if (per_sm >= 256) return 256;
  return per_sm <= 32 ? 32 : (int)((per_sm + 31) / 32 * 32);
}

template <typename T, int L, int MODE>
void launch_flat_l(const T* x, const OutPtrs1d& outs, int C, int rows,
                   int span, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  constexpr int F = 1 << L;
  if (MODE == kFlatVecMode) {
    // S = F / min(F, 8) lanes a (top row, channel group)
    const int64_t n = (int64_t)rows * (C / V) * (F > 8 ? F / 8 : 1);
    const int t = threads_for(n);
    pool1d_flat_kernel<T, L, kFlatVecMode>
        <<<blocks_for(n, t), t, 0, s>>>(x, outs, C, rows, span);
  } else if (MODE == kFlatC1Mode) {
    const int64_t n = (int64_t)rows * F / (F > V ? F : V);  // flat_c1's P
    const int t = threads_for(n);
    pool1d_flat_kernel<T, L, kFlatC1Mode>
        <<<blocks_for(n, t), t, 0, s>>>(x, outs, C, rows, span);
  } else {
    // threads: the span's input vectors, in whole warps, at most 256
    const int64_t nv = ((int64_t)span * C << L) / V;
    const int t = nv >= 256 ? 256 : (int)((nv + 31) / 32 * 32);
    const size_t smem = (size_t)span * C * ((2 << L) - 1) * sizeof(T);
    pool1d_flat_kernel<T, L, kFlatStagedMode>
        <<<blocks_for(rows, span), t, smem, s>>>(x, outs, C, rows, span);
  }
}

template <typename T, int MODE>
void launch_flat(const T* x, const OutPtrs1d& outs, int64_t B, int Len,
                 int C, int L, int span, cudaStream_t s) {
  const int rows = (int)(B * (Len >> L));
  switch (L) {
    case 1:
      launch_flat_l<T, 1, MODE>(x, outs, C, rows, span, s);
      break;
    case 2:
      launch_flat_l<T, 2, MODE>(x, outs, C, rows, span, s);
      break;
    case 3:
      launch_flat_l<T, 3, MODE>(x, outs, C, rows, span, s);
      break;
    case 4:
      launch_flat_l<T, 4, MODE>(x, outs, C, rows, span, s);
      break;
    case 5:
      launch_flat_l<T, 5, MODE>(x, outs, C, rows, span, s);
      break;
    default:
      launch_flat_l<T, 6, MODE>(x, outs, C, rows, span, s);
  }
}

// The arguments checked, and the route they take; returns a CUDA error
// code (0 if they are valid).
int prepare_pyramid(const void* x, const void* out_ptrs, int dtype, int64_t B,
                    int Len, int C, int L, OutPtrs1d* outs, int* spans,
                    int* span, Route1d* r) {
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
  *r = dtype == 0
      ? pyramid_route<float>(x, *outs, B, Len, C, L, span)
      : pyramid_route<__nv_bfloat16>(x, *outs, B, Len, C, L, span);
  return (int)cudaSuccess;
}

template <typename T>
void launch_pyramid(Route1d r, const void* x, const OutPtrs1d& outs,
                    int64_t B, int Len, int C, int L, int spans, int span,
                    cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  if (r == kVec1d)
    launch_pyramid_v<T, 16 / sizeof(T)>(xt, outs, B, Len, C, L, spans, s);
  else if (r == kScalar1d)
    launch_pyramid_v<T, 1>(xt, outs, B, Len, C, L, spans, s);
  else if (r == kFlatVec1d)
    launch_flat<T, kFlatVecMode>(xt, outs, B, Len, C, L, span, s);
  else if (r == kFlat1d)
    launch_flat<T, kFlatStagedMode>(xt, outs, B, Len, C, L, span, s);
  else if (r == kFlatC11d)
    launch_flat<T, kFlatC1Mode>(xt, outs, B, Len, C, L, span, s);
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

// pool1d_backward_kernel for windows of F, S lanes a window.
template <typename T, int V, int F, int S>
void launch_backward_f(const T* x, const T* g, T* dx, int64_t B, int Len,
                       int C, cudaStream_t s) {
  const int threads = 256;
  const int windows = (Len + F - 1) / F;
  const int grid = blocks_for(B * windows * (C / V) * S, threads);
  pool1d_backward_kernel<T, V, F, S><<<grid, threads, 0, s>>>(
      x, g, dx, B, Len, C, windows);
}

template <typename T, int V>
void launch_backward_v(const T* x, const T* g, T* dx, int64_t B, int Len,
                       int C, int F, cudaStream_t s) {
  switch (F) {
    case 2:
      launch_backward_f<T, V, 2, 1>(x, g, dx, B, Len, C, s);
      break;
    case 4:
      launch_backward_f<T, V, 4, 1>(x, g, dx, B, Len, C, s);
      break;
    case 8:
      launch_backward_f<T, V, 8, 1>(x, g, dx, B, Len, C, s);
      break;
    case 16:
      launch_backward_f<T, V, 16, 1>(x, g, dx, B, Len, C, s);
      break;
    case 32:
      launch_backward_f<T, V, 32, 1>(x, g, dx, B, Len, C, s);
      break;
    default:
      launch_backward_f<T, V, 64, 2>(x, g, dx, B, Len, C, s);
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
      (factor != 2 && factor != 4 && factor != 8 && factor != 16 &&
       factor != 32 && factor != 64))
    return (int)cudaErrorInvalidValue;
  // threads: a window, channel and lane of the window (2 at F = 64)
  const int64_t per_b =
      (int64_t)((Len + factor - 1) / factor) * C * (factor == 64 ? 2 : 1);
  if (per_b > 0x7fffffffLL || B * per_b > 0x7fffffffLL * 256)
    return (int)cudaErrorInvalidConfiguration;
  *r = dtype == 0 ? backward_route<float>(x, g, dx, B, Len, C)
                  : backward_route<__nv_bfloat16>(x, g, dx, B, Len, C);
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  x: (B, Len, C) memory.  out_ptrs:
// host array of L (1..6) device pointers, level 1 first, each a (B,
// Len >> l, C) buffer, or null for a level the caller does not want.
// Launches on `stream` and returns cudaGetLastError() (0 on success);
// launches nothing when there is nothing to pool.  Sets *launched to the
// name of the kernel it launched ("none" if it launched nothing).
int tpuseg_maxpool1d_pyramid(const void* x, const void* out_ptrs, int dtype,
                             int64_t B, int Len, int C, int L,
                             const char** launched, void* stream) {
  OutPtrs1d outs;
  int spans, span = 0;
  Route1d r;
  *launched = kPyramid1dNames[kNone1d];
  const int err = prepare_pyramid(x, out_ptrs, dtype, B, Len, C, L, &outs,
                                  &spans, &span, &r);
  if (err) return err;
  if (r == kNone1d) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_pyramid<float>(r, x, outs, B, Len, C, L, spans, span, s);
  else
    launch_pyramid<__nv_bfloat16>(r, x, outs, B, Len, C, L, spans, span, s);
  *launched = kPyramid1dNames[r];
  return (int)cudaGetLastError();
}

// The kernel tpuseg_maxpool1d_pyramid launches for the same arguments
// ("none" if it launches nothing), or null if it refuses them.
const char* tpuseg_maxpool1d_pyramid_route(const void* x,
                                           const void* out_ptrs, int dtype,
                                           int64_t B, int Len, int C, int L) {
  OutPtrs1d outs;
  int spans, span = 0;
  Route1d r;
  if (prepare_pyramid(x, out_ptrs, dtype, B, Len, C, L, &outs, &spans, &span,
                      &r))
    return nullptr;
  return kPyramid1dNames[r];
}

// dtype: 0 = float32, 1 = bfloat16; factor: 2, 4, 8, 16, 32 or 64.  x and dx:
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
