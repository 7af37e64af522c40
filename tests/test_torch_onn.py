"""The port's Self-ONN layers (ops/onn.py: ``power_stack``, ``Oper``,
``OperTranspose``, ``OperationalDenseBlock``; ops/blocks.py:
``SelfRecurrentConvBlock``) against the JAX package's, in 2D on NHWC
arrays and in 1D on NLC signals, float32 and bfloat16, with the same
variables (random, from numpy, converted by utils/flax_to_torch.py):

- the power stack equals JAX's bit for bit in both dtypes: each power is
  the previous one times x, rounded to the input's dtype;
- each layer's output in eval mode, and in training mode the output, the
  input's and every parameter's gradient of ``sum(y * g)`` for one random
  ``g``, and the new running statistics.  Tolerances, in units of
  max(1, the largest magnitude of the JAX array): float32 outputs 1e-5,
  gradients 1e-4, statistics 1e-5; bfloat16 (the same float32
  parameters, activations in bf16, as both packages cast them) outputs,
  gradients and statistics 2e-2 (two bf16 ulps: the two libraries sum a
  convolution's products in different orders before rounding, and the
  batch statistics are those of bf16 convolution outputs).  The
  statistics are in units of their size too: the variance of the cubes'
  convolutions runs to the hundreds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import (  # noqa: E402
    blocks as jblocks, onn as jonn)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import (  # noqa: E402
    Oper, OperationalDenseBlock, OperTranspose, SelfRecurrentConvBlock,
    power_stack)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

#: dtype -> the bars of outputs, gradients, running statistics
BAR = {torch.float32: (1e-5, 1e-4, 1e-5), torch.bfloat16: (2e-2, 2e-2, 2e-2)}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _to_torch(x: np.ndarray, rank: int, dtype=torch.float32) -> torch.Tensor:
    """NHWC (rank 2) or NLC (rank 1) numpy -> the port's channels_last
    (B, C, H, W) or (B, C, 1, L) view."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(dtype)
    if rank == 1:
        t = t.unsqueeze(1)
    return t.permute(0, 3, 1, 2)


def _to_np(t: torch.Tensor, rank: int) -> np.ndarray:
    y = t.detach().float().permute(0, 2, 3, 1)
    return (y[:, 0] if rank == 1 else y).numpy()


def _x(rank: int, channels: int, seed: int = 0) -> np.ndarray:
    shape = (2, 8, 8, channels) if rank == 2 else (2, 16, channels)
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _off(got: np.ndarray, want: np.ndarray) -> float:
    """|got - want| in units of max(1, |want|)."""
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1.0)


def _pair(jmod, tmod, x: np.ndarray, rank: int, dtype=torch.float32,
          train_arg: bool = False, seed: int = 0):
    """Both layers on ``x`` (fed in ``dtype``) with the same variables:
    eval-mode outputs, then one training-mode forward and backward of
    ``sum(y * g)``, held to ``BAR``."""
    out_bar, grad_bar, stats_bar = BAR[dtype]
    jx = jnp.asarray(x, _JDT[dtype])
    variables = dict(random_variables(jmod, jx, seed=seed))
    sd = flax_to_state_dict(variables, tmod.state_dict())
    assert sorted(sd) == sorted(tmod.state_dict())
    tmod.load_state_dict(sd)
    kw = dict(train=False) if train_arg else {}
    want = np.asarray(jax.jit(lambda v, a: jmod.apply(v, a, **kw))(
        variables, jx).astype(jnp.float32))
    with torch.no_grad():
        got = _to_np(tmod.eval()(_to_torch(x, rank, dtype)), rank)
    assert got.shape == want.shape
    assert _off(got, want) <= out_bar
    assert float(want.std()) > 1e-2

    stats = variables.get("batch_stats", {})

    def f(p, a, g):
        if train_arg:
            y, upd = jmod.apply({"params": p, "batch_stats": stats}, a,
                                train=True, mutable=["batch_stats"])
        else:
            y, upd = jmod.apply({"params": p}, a), {"batch_stats": {}}
        return jnp.sum(y.astype(jnp.float32) * g), (y, upd["batch_stats"])

    g = np.random.default_rng(seed + 7).normal(size=want.shape).astype(
        np.float32)
    (dparams, dx), (y_j, new_bs) = jax.jit(jax.grad(
        f, argnums=(0, 1), has_aux=True))(variables["params"], jx,
                                          jnp.asarray(g))
    xt = _to_torch(x, rank, dtype).detach().requires_grad_()
    y_t = tmod.train()(xt)
    (y_t.float() * _to_torch(g, rank)).sum().backward()
    assert _off(_to_np(y_t, rank), y_j.astype(jnp.float32)) <= out_bar
    assert _off(_to_np(xt.grad, rank), dx.astype(jnp.float32)) <= grad_bar
    names = dict(tmod.named_parameters())
    jg = flax_to_state_dict({"params": dparams}, names)
    for k, p in names.items():
        assert _off(p.grad.numpy(), jg[k].numpy()) <= grad_bar, k
    run = {k: v for k, v in tmod.state_dict().items() if "running" in k}
    if run:
        js = flax_to_state_dict({"batch_stats": new_bs}, run)
        for k, v in run.items():
            assert _off(v.numpy(), js[k].numpy()) <= stats_bar, k
    return tmod


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_power_stack_rounds_as_jax(dtype):
    """``[x, x**2, x**3]`` on the channels, x**3 = (x**2 rounded) * x
    rounded, bit for bit as JAX's; in bf16 the stack differs from x**3
    computed in float32 and rounded once, so the data tells the two
    apart.  q = 1 is the input itself."""
    x = np.random.default_rng(3).normal(size=(2, 8, 8, 6)).astype(
        np.float32) * 3
    jx = jnp.asarray(x, _JDT[dtype])
    for q in (1, 2, 3):
        want = np.asarray(jax.jit(lambda a: jonn._power_stack(a, q))(jx)
                          .astype(jnp.float32))
        t = _to_torch(x, 2, dtype)
        got = power_stack(t, q)
        assert got.dtype == dtype
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(_to_np(got, 2), want)
    assert power_stack(t, 1) is t
    once = (t.float() ** 3).to(dtype)
    assert bool((once != got[:, 12:]).any()) == (dtype == torch.bfloat16)


#: (rank, in channels, features, kernel, stride, activation, q, dtype)
OPER_CASES = [
    (2, 3, 5, 3, 1, None, 3, torch.float32),
    (2, 4, 6, 3, 1, None, 1, torch.float32),
    (2, 4, 1, 1, 2, None, 3, torch.float32),       # the UNet3+ DS head
    (2, 4, 2, 1, 1, "sigmoid", 3, torch.float32),  # the model's head
    (2, 3, 5, 3, 1, None, 3, torch.bfloat16),
    (2, 4, 1, 1, 2, None, 3, torch.bfloat16),
    (1, 2, 5, 3, 1, None, 3, torch.float32),
    (1, 3, 4, 4, 1, None, 2, torch.float32),       # even kernel: SAME 1, 2
    (1, 4, 1, 1, 2, None, 3, torch.float32),       # the 1D UNet3+ DS head
    (1, 2, 5, 3, 1, None, 3, torch.bfloat16),
]


def _oper_id(c):
    return (f"r{c[0]}-c{c[1]}-f{c[2]}-k{c[3]}-s{c[4]}-{c[5]}-q{c[6]}-"
            f"{str(c[7])[6:]}")


@pytest.mark.parametrize("case", OPER_CASES,
                         ids=[_oper_id(c) for c in OPER_CASES])
def test_oper_equals_flax(case):
    """flax ``nn.Conv`` SAME over the power stack: the kernel's input
    channels in the stack's order map one for one; a stride-2 1x1 conv
    slices, then convolves (its gradient included)."""
    rank, cin, feats, k, s, act, q, dtype = case
    tmod = Oper(cin, feats, k, stride=s, activation=act, q=q, dtype=dtype,
                rank=rank)
    assert tuple(tmod.onn_conv.weight.shape) == (
        (feats, q * cin, k, k) if rank == 2 else (feats, q * cin, 1, k))
    _pair(jonn.Oper(feats, k, strides=s, activation=act, q=q,
                    dtype=_JDT[dtype]), tmod, _x(rank, cin), rank, dtype)


@pytest.mark.parametrize("rank,q,dtype", [
    (2, 3, torch.float32), (2, 1, torch.float32), (2, 3, torch.bfloat16),
    (1, 3, torch.float32), (1, 1, torch.float32), (1, 3, torch.bfloat16)])
def test_oper_transpose_equals_flax(rank, q, dtype):
    """flax ``ConvTranspose(transpose_kernel=True)`` k4 s2 SAME with tanh
    over the power stack: 2x the input's size, in 1D along the length
    alone with a (1, 4) kernel."""
    tmod = OperTranspose(3, 4, q=q, dtype=dtype, rank=rank)
    tmod = _pair(jonn.OperTranspose(4, 4, strides=2, activation="tanh", q=q,
                                    dtype=_JDT[dtype]),
                 tmod, _x(rank, 3), rank, dtype)
    y = tmod(_to_torch(_x(rank, 3), rank, dtype))
    assert y.shape[-1] == (32 if rank == 1 else 16)


@pytest.mark.parametrize("rank,layers,dtype", [
    (2, 0, torch.float32), (2, 2, torch.float32), (2, 1, torch.bfloat16),
    (1, 1, torch.float32), (1, 2, torch.float32)])
def test_operational_dense_block_equals_flax(rank, layers, dtype):
    """``Oper_0``, then ``layers`` residual ``Oper_k`` adds (q = 3)."""
    tmod = OperationalDenseBlock(3, 4, 3, num_layers=layers, q=3,
                                 dtype=dtype, rank=rank)
    assert sorted(n for n, _ in tmod.named_children()) == [
        f"Oper_{k}" for k in range(layers + 1)]
    _pair(jonn.OperationalDenseBlock(4, 3, num_layers=layers, q=3,
                                     dtype=_JDT[dtype]),
          tmod, _x(rank, 3), rank, dtype)


@pytest.mark.parametrize("rank,t,q,dtype", [
    (1, 2, 3, torch.float32), (1, 1, 1, torch.float32),
    (1, 2, 3, torch.bfloat16), (2, 2, 3, torch.float32),
    (2, 3, 1, torch.float32)])
def test_self_recurrent_conv_block_equals_flax(rank, t, q, dtype):
    """``t`` times ``x = concat(Oper_i(x), inputs)``, then ``ConvBlock_0``
    (BatchNorm on the batch statistics in training, its running
    statistics advanced as flax's)."""
    tmod = SelfRecurrentConvBlock(3, 4, 3, t=t, q=q, dtype=dtype, rank=rank)
    assert sorted(n for n, _ in tmod.named_children()) == sorted(
        [f"Oper_{i}" for i in range(t)] + ["ConvBlock_0"])
    _pair(jblocks.SelfRecurrentConvBlock(4, 3, t=t, q=q, dtype=_JDT[dtype]),
          tmod, _x(rank, 3), rank, dtype, train_arg=True)
