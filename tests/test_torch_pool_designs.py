"""The two pool kernels' designs, written out in numpy, against JAX.

The CUDA kernels cannot run here, so these tests hold the index maps and
the routing rule that ``csrc/pyramid.cu``'s ``pool_rows_kernel`` and
``csrc/pool_backward.cu``'s ``pool_backward_rows_kernel`` are built on to
the JAX package's pool (``downsample_pool``: ``lax.reduce_window`` max,
and ``jax.vjp`` of it, whose gradient XLA's select_and_scatter routes).
Both are exact, so both sides must agree bit for bit (signed zeros
aside, which compare equal).

(a) The odd-C pool works on a contiguous NHWC row: the F rows of a band
    are folded element by element over spans of output pixels, then
    output element e of a span (pixel px = e // C) is the max over j < F
    of ``row[e + (F - 1) * px * C + j * C]``, with (px, c) stepped by a
    block's 256 threads.
(b) The backward for windows of F >= 4 walks each window row on its own
    (move to e whenever ``not (s >= e)``), keeps the row's value, column
    and whether it held a NaN, and joins the rows: take B if B held a NaN
    or ``not (A >= B)``, else keep A, in row order or as a tree.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.ops.blocks import (  # noqa: E402
    downsample_pool as jax_pool)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_SIZEOF = {"float32": 4, "bfloat16": 2}
#: pool_rows_kernel's block and shared-memory budget (csrc/pyramid.cu)
_THREADS = 256
_SMEM_MAX, _SMEM_AIM = 48 * 1024, 24 * 1024


def _rounded(x: np.ndarray, dtype: str) -> np.ndarray:
    """``x`` as the kernel sees it: rounded to ``dtype``, held in f32."""
    return np.asarray(jnp.asarray(x, _JDT[dtype]).astype(jnp.float32))


def _jax_pool(x: np.ndarray, factor: int, dtype: str) -> np.ndarray:
    y = jax_pool(jnp.asarray(x, _JDT[dtype]), factor, op="max")
    return np.asarray(y.astype(jnp.float32))


def _rows_span(w: int, c: int, level: int, size: int) -> int:
    """``rows_span`` of csrc/pyramid.cu: output pixels of one span."""
    px_bytes = ((c << level) + c) * size
    if 8 * px_bytes > _SMEM_MAX:
        return 0
    most = max(8, _SMEM_AIM // px_bytes // 8 * 8)
    wo = w >> level
    spans = -(-wo // most)
    return (-(-wo // spans) + 7) // 8 * 8


def _pool_rows(x: np.ndarray, factor: int, dtype: str) -> np.ndarray:
    """pool_rows_kernel's index map on an NHWC array: per band and span,
    the vertical fold of the span's contiguous slice of F rows, then the
    horizontal fold from the folded row, (px, c) stepped as the threads
    step them."""
    b, h, w, c = x.shape
    level = factor.bit_length() - 1
    ho, wo = h // factor, w // factor
    span = _rows_span(w, c, level, _SIZEOF[dtype])
    assert span > 0
    rows = x.reshape(b, h, w * c)
    out = np.full((b, ho, wo * c), -7.0, np.float32)
    dpx, dc = divmod(_THREADS, c)
    for x0 in range(0, wo, span):
        n = min(span, wo - x0)
        n_out = n * c
        lo = factor * x0 * c
        for bi in range(b):
            for yo in range(ho):
                band = rows[bi, factor * yo:factor * yo + factor,
                            lo:lo + factor * n_out]
                row = band[0]
                for i in range(1, factor):
                    row = np.maximum(row, band[i])  # NaN propagates
                folded = np.full(n_out, -7.0, np.float32)
                t = np.arange(min(_THREADS, n_out))
                px, ch = t // c, t % c
                e = t
                while e.size:
                    m = row[e + (factor - 1) * px * c]
                    for j in range(1, factor):
                        m = np.maximum(m, row[e + (factor - 1) * px * c
                                              + j * c])
                    folded[e] = m
                    px, ch = px + dpx, ch + dc
                    px, ch = np.where(ch >= c, px + 1, px), np.where(
                        ch >= c, ch - c, ch)
                    keep = e + _THREADS < n_out
                    e, px, ch = e[keep] + _THREADS, px[keep], ch[keep]
                out[bi, yo, x0 * c:x0 * c + n_out] = folded
    return out.reshape(b, ho, wo, c)


def _pool_input(shape, seed: int, dtype: str) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[rng.random(shape) < 0.2] = 0.0  # plateaus
    flat = x.reshape(-1)
    for v in (np.nan, np.inf, -np.inf, np.nan):
        flat[rng.integers(flat.size)] = v
    flat[-1] = np.nan  # the last element of the last row
    return _rounded(x, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,factor", [
    ((2, 8, 16, 3), 2),
    ((2, 9, 24, 31), 2),      # ragged H
    ((1, 6, 17, 51), 2),      # ragged W
    ((1, 4, 128, 31), 2),     # the encoder's row, one span
    ((1, 2, 1024, 51), 2),    # a row wider than one span
    ((2, 11, 19, 3), 4),      # ragged H and W
    ((1, 8, 64, 31), 4),
    ((1, 4, 40, 51), 4),
])
def test_pool_rows_index_map_equals_reduce_window(dtype, shape, factor):
    """(a) Rows, then columns, through spans: the same pool as JAX's
    ``reduce_window`` max, NaN positions included."""
    x = _pool_input(shape, 11 + factor, dtype)
    got = _pool_rows(x, factor, dtype)
    want = _jax_pool(x, factor, dtype)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


@pytest.mark.parametrize("dtype,w,c,level", [
    ("bfloat16", 256, 31, 1), ("bfloat16", 256, 51, 1),
    ("bfloat16", 32, 426, 1), ("bfloat16", 1024, 51, 1),
    ("float32", 64, 7, 1), ("bfloat16", 256, 5, 4),
])
def test_pool_rows_spans_tile_the_row_within_shared_memory(dtype, w, c,
                                                           level):
    """Every span starts on a multiple of 8 output pixels (so on 16 bytes
    when the row does), the spans cover the row, and one span's shared
    memory (its folded row and output) stays within 48 KB."""
    size = _SIZEOF[dtype]
    span = _rows_span(w, c, level, size)
    wo = w >> level
    assert span > 0 and span % 8 == 0
    assert -(-wo // span) * span - wo < span  # no empty span
    assert (span * c << level) * size + span * c * size <= _SMEM_MAX


def _walk(vals: np.ndarray):
    """The serial walk over the last-but-one axis of ``vals`` (..., n, C):
    the selected value and index, and whether a NaN was seen."""
    s = vals[..., 0, :].copy()
    sel = np.zeros(s.shape, np.int64)
    nan = np.isnan(s)
    for j in range(1, vals.shape[-2]):
        e = vals[..., j, :]
        nan |= np.isnan(e)
        with np.errstate(invalid="ignore"):
            take = ~(s >= e)
        s = np.where(take, e, s)
        sel = np.where(take, j, sel)
    return s, sel, nan


def _join(a, b):
    """Rows A then B: B if B held a NaN or not (A >= B), else A."""
    (av, ai, an), (bv, bi, bn) = a, b
    with np.errstate(invalid="ignore"):
        take = bn | ~(av >= bv)
    return (np.where(take, bv, av), np.where(take, bi, ai), an | bn)


def _row_split_choice(x: np.ndarray, factor: int, tree: bool) -> np.ndarray:
    """pool_backward_rows_kernel's choice, index i * F + j per window and
    channel: each window row walked alone, the rows joined in row order
    (as the kernel does) or as a balanced tree."""
    b, h, w, c = x.shape
    f = factor
    hf, wf = h // f, w // f
    win = x[:, :hf * f, :wf * f].reshape(b, hf, f, wf, f, c)
    win = win.transpose(0, 1, 3, 2, 4, 5)  # (b, hf, wf, row, col, c)
    rows = []
    for i in range(f):
        v, j, nan = _walk(win[:, :, :, i])
        rows.append((v, j + i * f, nan))
    while len(rows) > 1:
        if tree:
            rows = [_join(rows[k], rows[k + 1])
                    for k in range(0, len(rows), 2)]
        else:
            rows = [_join(rows[0], rows[1])] + rows[2:]
    return rows[0][1]


def _routed(x: np.ndarray, g: np.ndarray, sel: np.ndarray, factor: int
            ) -> np.ndarray:
    """dx: g at the chosen element of each window, zero elsewhere."""
    b, h, w, c = x.shape
    f = factor
    hf, wf = h // f, w // f
    onehot = (np.arange(f * f)[:, None] == sel[..., None, :])  # window, n, C
    parts = np.where(onehot, g[:, :, :, None, :], 0.0)
    dx = np.zeros(x.shape, np.float32)
    dx[:, :hf * f, :wf * f] = parts.reshape(b, hf, wf, f, f, c).transpose(
        0, 1, 3, 2, 4, 5).reshape(b, hf * f, wf * f, c)
    return dx


def _jax_grad(x: np.ndarray, g: np.ndarray, factor: int, dtype: str
              ) -> np.ndarray:
    _, vjp = jax.vjp(lambda t: jax_pool(t, factor, op="max"),
                     jnp.asarray(x, _JDT[dtype]))
    (dx,) = vjp(jnp.asarray(g, _JDT[dtype]))
    return np.asarray(dx.astype(jnp.float32))


def _window_input(factor: int, kind: str, seed: int) -> np.ndarray:
    """(2, 2F + 1, 2F + 3, 3): four full windows and cut-off edges, with
    plateaus of zeros, and NaNs planted as ``kind`` says in window (0, 0)
    of batch 0, channel 1."""
    f = factor
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 2 * f + 1, 2 * f + 3, 3)).astype(np.float32)
    x[rng.random(x.shape) < 0.4] = 0.0
    x[1, f:2 * f, f:2 * f, 2] = 0.0  # a window that is one plateau
    w0 = x[0, :f, :f, 1]
    if kind == "first":
        w0[0, 0] = np.nan
    elif kind == "last":
        w0[f - 1, f - 1] = np.nan
    elif kind == "inner":
        w0[f // 2, 1] = np.nan
    elif kind == "twice":
        # the second NaN is followed in its row by values below every
        # row above it: only its NaN flag makes the join take that row
        w0[1, f // 2] = np.nan
        w0[f - 2, 1] = np.nan
        w0[f - 2, 2:] = -5.0
    elif kind == "inf":
        w0[2, 3] = np.inf
        w0[0, 1] = -np.inf
    return x


@pytest.mark.parametrize("tree", [False, True], ids=["row_order", "tree"])
@pytest.mark.parametrize("kind", ["random", "first", "last", "inner",
                                  "twice", "inf"])
@pytest.mark.parametrize("factor", [4, 8, 16])
def test_row_split_join_routes_as_jax_vjp(factor, kind, tree):
    """(b) The row walks joined by the rule give the gradient of
    ``jax.vjp`` of the JAX pool, bit for bit, in f32."""
    x = _window_input(factor, kind, seed=factor * 7 + len(kind))
    rng = np.random.default_rng(3)
    g = rng.standard_normal((2, x.shape[1] // factor, x.shape[2] // factor,
                             3)).astype(np.float32)
    got = _routed(x, g, _row_split_choice(x, factor, tree), factor)
    np.testing.assert_array_equal(got, _jax_grad(x, g, factor, "float32"))


@pytest.mark.parametrize("factor", [4, 8, 16])
def test_row_split_join_routes_as_jax_vjp_in_bf16_on_plateaus(factor):
    """(b) in bf16, where rounding makes ties common: random inputs from a
    seed, each window with a few distinct values and two NaNs a batch."""
    rng = np.random.default_rng(factor)
    shape = (2, 3 * factor, 2 * factor + 1, 5)
    x = rng.integers(-2, 3, shape).astype(np.float32) * 0.5
    x[0, 1, 2, 3] = np.nan
    x[1, factor + 3, factor - 1, 0] = np.nan
    x = _rounded(x, "bfloat16")
    g = _rounded(rng.standard_normal(
        (2, shape[1] // factor, shape[2] // factor, 5)), "bfloat16")
    got = _routed(x, g, _row_split_choice(x, factor, tree=False), factor)
    np.testing.assert_array_equal(got, _jax_grad(x, g, factor, "bfloat16"))


def test_route_queries_refuse_cpu_tensors():
    """The route queries name a CUDA launch: on a CPU tensor they raise
    before the kernels' library is needed."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pool_backward, pyramid)

    x = torch.zeros(1, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="CUDA"):
        pyramid.route(x, 1)
    with pytest.raises(ValueError, match="CUDA"):
        pool_backward.route(x, torch.zeros(1, 3, 2, 2), 4)
