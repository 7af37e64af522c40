"""The blocks of the last 1D families and the train step's random stream,
against the JAX package with the same variables (random, from numpy,
converted by utils/flax_to_torch.py; output, every input's and
parameter's gradient in float32 within 1e-4, BatchNorm's new running
statistics within 1e-5, ``_pair`` of tests/test_torch_specials_1d.py):

- the general ``TransConv`` at every (kernel, stride) the families use,
  with and without BatchNorm, and the three decoder routes bit for bit;
  the strided ``ConvBlock``; ``SpatialAttention`` (its bf16 channel mean
  as ``jnp.mean``'s); ``DropBlock`` on replayed draws at odd and even
  block sizes, one clipped by a short signal; ``pool_same`` max, avg and
  mix at strides 1, 2, 4, 8; AlbUNet's ``Dropout``; ``MSPUnit``, ``MRPBlock``,
  ``ConvBlockRegulated``, ``MultiResBlockRegulated``, the four
  Dense-Inception blocks and ``ResidualGroup`` with and without
  bottleneck;
- the stream: a (seed, step) key gives the same draws, another step or
  seed others, each microbatch its own; every ``remat`` mode the plain
  step's gradients; nothing drawn in eval mode, by the eval and predict
  steps; DropBlock's dropped share at keep_prob 0.9 on (64, 1024, 32)
  within 0.02 of JAX's; a SIGTERM-interrupted SAUNet run resumed from
  ``last`` equals a straight one bit for bit."""
import copy
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402
from test_torch_pool1d import nlc_to_torch, torch_to_nlc  # noqa: E402
from test_torch_extra_models_1d import ReplayedBernoulli, _drawn_in_order  # noqa: E402
from test_torch_specials_1d import _pair, _x  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    dense_inception as jdi, extra_1d as jextra, mlmrsnet as jmlmrs,
    saunet as jsaunet)
from tf_1d_2d_segmentation_end2endpipelines_tpu.ops import blocks as jblocks  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    dense_inception, extra_1d, mlmrsnet, model_selector_1d, saunet)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import (  # noqa: E402
    blocks, remat, stochastic)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    CheckpointManager, Trainer, get_loss, make_eval_step, make_optimizer,
    make_predict_step, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

ATOL = 1e-4
#: every (kernel, stride) of the families' transposed convs
TRANSCONV_PAIRS = [(4, 1), (4, 2), (4, 4), (4, 8), (4, 16), (1, 2), (3, 2),
                   (3, 1), (1, 1), (2, 2)]


@pytest.mark.parametrize("kernel,stride", TRANSCONV_PAIRS)
def test_transconv_equals_flax(kernel, stride):
    """flax's SAME ConvTranspose of any kernel and stride (no flip,
    ``transconv_pads``; k3 s2 and k4 s1 crop a trailing sample), with
    BatchNorm and ReLU; the output keeps channels_last."""
    tm = _pair(jblocks.TransConv(5, kernel=kernel, strides=stride,
                                 use_bn=True, activation="relu"),
               blocks.TransConv(3, 5, rank=1, kernel=kernel, strides=stride,
                                use_bn=True, activation="relu"),
               [_x((2, 9, 3))])
    y = tm.eval()(nlc_to_torch(_x((2, 9, 3))))
    assert y.shape[-1] == 9 * stride
    assert y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("kernel,stride", [(1, 1), (3, 2)])
def test_bare_transconv_equals_flax(kernel, stride):
    """No BatchNorm, no activation (the Upsampling block's 1x1 convs)."""
    _pair(jblocks.TransConv(4, kernel=kernel, strides=stride, use_bn=False,
                            activation=None),
          blocks.TransConv(3, 4, rank=1, kernel=kernel, strides=stride,
                           use_bn=False, activation=None),
          [_x((2, 8, 3))], train_arg=False)


@pytest.mark.parametrize("route", ["2d", "1d", "2d_rank1"])
def test_decoder_transconv_routes_are_unchanged(route):
    """The decoders' dialects give what the general block gives with the
    dialect's kernel, stride, BatchNorm and activation, bit for bit."""
    dialect, rank = {"2d": ("2d", 2), "1d": ("1d", 1),
                     "2d_rank1": ("2d", 1)}[route]
    k, s, bn, act = blocks.TransConv._DIALECTS[dialect]
    a = blocks.TransConv(3, 4, dialect=dialect, rank=rank,
                         generator=torch.Generator().manual_seed(0))
    b = blocks.TransConv(3, 4, rank=1 if dialect == "1d" else rank,
                         kernel=k, strides=s, use_bn=bn, activation=act)
    b.load_state_dict(a.state_dict())
    shape = (2, 3, 1, 8) if rank == 1 or dialect == "1d" else (2, 3, 8, 8)
    x = torch.randn(shape).contiguous(memory_format=torch.channels_last)
    assert torch.equal(a.train()(x), b.train()(x))
    assert blocks.transconv_pads(k, s)[1:] == (0, 0)


def test_strided_conv_block_equals_flax():
    """AlbUNet's stem and connectors: SAME at stride 2 (k7: 2 before, 3
    after on an even length)."""
    for k in (7, 3):
        _pair(jblocks.ConvBlock(4, k, strides=2),
              blocks.ConvBlock(3, 4, k, rank=1, stride=2), [_x((2, 16, 3))])


def test_spatial_attention_equals_flax():
    _pair(jblocks.SpatialAttention(kernel=7),
          blocks.SpatialAttention(7, rank=1), [_x((2, 16, 5))],
          train_arg=False)


def test_spatial_attention_bf16_mean_is_jnp_mean():
    """In a bf16 model the channel mean is accumulated in float32 and
    rounded to bf16, as ``jnp.mean``: the gate's input equals JAX's."""
    x = _x((2, 16, 48), 3) * 3
    jm = jblocks.SpatialAttention(kernel=7, dtype=jnp.bfloat16)
    variables = random_variables(jm, jnp.asarray(x), seed=1)
    tm = blocks.SpatialAttention(7, rank=1, dtype=torch.bfloat16)
    tm.load_state_dict(flax_to_state_dict(variables, tm.state_dict()))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jm.apply(variables, xb).astype(jnp.float32))
    got = torch_to_nlc(tm(nlc_to_torch(x).to(torch.bfloat16)).float())
    assert float(np.abs(got - want).max()) <= 1e-2 * float(np.abs(want).max())
    mean = nlc_to_torch(x).to(torch.bfloat16).float().mean(1).to(
        torch.bfloat16)
    jmean = np.asarray(jnp.mean(xb, axis=-1).astype(jnp.float32))
    assert np.array_equal(mean[:, 0].float().numpy(), jmean)


@pytest.mark.parametrize("block_size,length", [(3, 24), (4, 24), (7, 5)])
def test_dropblock_equals_flax_on_replayed_draws(block_size, length,
                                                 monkeypatch):
    """DropBlock in training mode on the same seeds: the valid-centre
    border, the SAME expansion (asymmetric for an even block), a block
    clipped to a 5-sample signal, the renormalization and the gradient."""
    jm = jblocks.DropBlock(block_size, 0.7)
    tm = stochastic.DropBlock(block_size, 0.7)
    x = _x((3, length, 4), 2)
    (_, seeds), = _drawn_in_order(tm, nlc_to_torch(x))
    assert seeds.any()
    stochastic.replay(tm, {"": seeds})
    monkeypatch.setattr(jax.random, "bernoulli", ReplayedBernoulli([seeds]))
    g = _x((3, length, 4), 5)

    def f(xj):
        y = jm.apply({}, xj, deterministic=False,
                     rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(y * g), y

    (dx, y_j) = jax.grad(f, has_aux=True)(jnp.asarray(x))
    xt = nlc_to_torch(x).requires_grad_()
    y_t = tm.train()(xt)
    y_t.backward(nlc_to_torch(g))
    assert float(np.abs(torch_to_nlc(y_t) - np.asarray(y_j)).max()) <= ATOL
    assert float(np.abs(torch_to_nlc(xt.grad) - np.asarray(dx)).max()) <= ATOL
    assert float(np.abs(np.asarray(y_j) - x).max()) > 0.1  # it dropped
    assert torch.equal(tm.eval()(xt), xt)  # eval: the identity


def test_dropout_equals_flax_on_replayed_draws(monkeypatch):
    """AlbUNet's head dropout (flax ``nn.Dropout``): kept elements divided
    by the keep rate, the others 0, on the same draws; the identity at
    rate 0 and in eval mode."""
    from flax import linen as fnn

    x = _x((3, 16, 4), 6)
    tm = stochastic.Dropout(0.4)
    (_, keep), = _drawn_in_order(tm, nlc_to_torch(x))
    stochastic.replay(tm, {"": keep})
    monkeypatch.setattr(jax.random, "bernoulli", ReplayedBernoulli([keep]))
    want = fnn.Dropout(0.4, deterministic=False).apply(
        {}, jnp.asarray(x), rngs={"dropout": jax.random.PRNGKey(0)})
    got = torch_to_nlc(tm.train()(nlc_to_torch(x)))
    assert float(np.abs(got - np.asarray(want)).max()) <= 1e-6
    assert (got == 0).any() and (got != 0).any()
    xt = nlc_to_torch(x)
    assert torch.equal(tm.eval()(xt), xt)
    assert torch.equal(stochastic.Dropout(0.0).train()(xt), xt)


def test_dropblock_share_at_keep_prob_0_9_equals_jax():
    """On a (64, 1024, 32) signal at block 7, keep_prob 0.9, the share
    the port drops is within 0.02 of the share JAX's own DropBlock drops
    (their draws differ; their law is the same)."""
    ones = np.ones((64, 1024, 32), np.float32)
    y = jblocks.DropBlock(7, 0.9).apply({}, jnp.asarray(ones),
                                        deterministic=False,
                                        rngs={"dropout":
                                              jax.random.PRNGKey(3)})
    want = float(np.mean(np.asarray(y) == 0))
    tm = stochastic.DropBlock(7, 0.9).train()
    with stochastic.random_stream(torch.Generator().manual_seed(3)):
        got = float((tm.block_mask(nlc_to_torch(ones)) == 0).float().mean())
    assert 0.05 < want < 0.15 and abs(got - want) <= 0.02


@pytest.mark.parametrize("op", ["max", "avg"])
@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_pool_same_equals_jax(op, stride):
    """Window 3 SAME at each stride: the asymmetric padding, -inf for max,
    the count of valid elements for avg."""
    x = _x((2, 19, 3), stride)
    want = np.asarray(jmlmrs._pool_same(jnp.asarray(x), 3, stride, op))
    got = torch_to_nlc(mlmrsnet.pool_same(nlc_to_torch(x), stride, op))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-6


@pytest.mark.parametrize("pooling_type,level",
                         [("mix", 1), ("mix", 4), ("avg", 2), ("max", 8)])
def test_msp_unit_equals_flax(pooling_type, level):
    _pair(jmlmrs.MSPUnit(3, 2, level, pooling_type=pooling_type),
          mlmrsnet.MSPUnit(5, 3, 2, level, pooling_type), [_x((2, 16, 5))])


@pytest.mark.parametrize("cardinality,pooling_type", [(3, "mix"), (0, "avg")])
def test_mrp_block_equals_flax(cardinality, pooling_type):
    _pair(jmlmrs.MRPBlock(3, 2, cardinality, pooling_type),
          mlmrsnet.MRPBlock(4, 3, 2, cardinality, pooling_type),
          [_x((2, 16, 4))])


def test_regulated_blocks_equal_flax(monkeypatch):
    """ConvBlockRegulated and MultiResBlockRegulated in eval mode and, on
    replayed draws, in training mode."""
    x = _x((3, 16, 4), 1)
    for jmod, tmod in (
            (jsaunet.ConvBlockRegulated(6, 3, block_size=3, keep_prob=0.8),
             saunet.ConvBlockRegulated(4, 6, 3, block_size=3,
                                       keep_prob=0.8)),
            (jsaunet.MultiResBlockRegulated(8, multiplier=2, block_size=4,
                                            keep_prob=0.8),
             saunet.MultiResBlockRegulated(4, 8, 2, block_size=4,
                                           keep_prob=0.8))):
        draws = _drawn_in_order(tmod, nlc_to_torch(x))
        stochastic.replay(tmod, dict(draws))
        monkeypatch.setattr(jax.random, "bernoulli", ReplayedBernoulli(
            [d for _, d in draws] * 2))  # traced for the shape, then run
        _pair(jmod, tmod, [x], rngs={"dropout": jax.random.PRNGKey(0)})


@pytest.mark.parametrize("kind", ["irb", "dib", "down", "up"])
def test_dense_inception_blocks_equal_flax(kind):
    jmod, tmod, c = {
        "irb": (jdi.InceptionResBlock(4), dense_inception.InceptionResBlock(
            3, 4), 3),
        "dib": (jdi.DenseInceptionBlock(2),
                dense_inception.DenseInceptionBlock(3, 2), 3),
        "down": (jdi.DownsamplingBlock(4),
                 dense_inception.DownsamplingBlock(5, 4), 5),
        "up": (jdi.UpsamplingBlock(4), dense_inception.UpsamplingBlock(5, 4),
               5)}[kind]
    _pair(jmod, tmod, [_x((2, 16, c))])


@pytest.mark.parametrize("bottleneck", [False, True])
def test_residual_group_equals_flax(bottleneck):
    cin = 4 if not bottleneck else 6
    _pair(jextra._ResidualGroup(4, 2, bottleneck=bottleneck),
          extra_1d.ResidualGroup(cin, 4, 2, bottleneck=bottleneck),
          [_x((2, 16, cin))])


# ---- the stream ------------------------------------------------------


def _saunet(keep_prob=0.8, **kw):
    return model_selector_1d("SAUNet", 32, 2, 1, 4, 3, block_size=3,
                             keep_prob=keep_prob,
                             generator=torch.Generator().manual_seed(1),
                             **kw)


def _batch(n=4, length=32):
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.normal(size=(n, length, 1)).astype(
        np.float32)), torch.from_numpy((rng.uniform(size=(n, length, 1))
                                        > 0.5).astype(np.float32)))


def _step(model, seed=0, step=None, **kw):
    x, y = _batch()
    fn = make_train_step(model, make_optimizer("Adam", model.parameters(),
                                               1e-3),
                         get_loss("MeanAbsoluteError"), seed=seed, **kw)
    loss, _ = fn(x, y, step=step)
    return float(loss), {k: v.clone() for k, v in
                         stochastic.drawn_by_name(model).items()}


def test_stream_is_keyed_by_seed_and_step():
    """The same (seed, step) draws the same masks on a fresh model; the
    next step and another seed draw others; a step without ``step``
    counts its own calls from 0."""
    base = _saunet()
    loss, drawn = _step(copy.deepcopy(base), seed=5, step=3)
    again = _step(copy.deepcopy(base), seed=5, step=3)
    assert again[0] == loss
    assert all(torch.equal(drawn[k], again[1][k]) for k in drawn)
    assert len(drawn) == 10 and all(d.any() for d in drawn.values())
    for other in (dict(seed=5, step=4), dict(seed=6, step=3)):
        d = _step(copy.deepcopy(base), **other)[1]
        assert not all(torch.equal(drawn[k], d[k]) for k in drawn)
    counted = _step(copy.deepcopy(base), seed=5)[1]
    assert all(torch.equal(counted[k], _step(copy.deepcopy(base), seed=5,
                                             step=0)[1][k]) for k in drawn)


def test_each_microbatch_draws_its_own_mask():
    """Under accumulation microbatch i draws from the (seed, step, i)
    stream: the two microbatches' masks differ, each is that stream's."""
    model = _saunet()
    first = stochastic.stochastic_layers(model)["ConvBlockRegulated_0.drop"]
    seen = []
    first.register_forward_hook(lambda m, i, o: seen.append(m.drawn.clone()))
    _step(model, seed=2, step=7, accum_steps=2)
    assert len(seen) == 2 and not torch.equal(seen[0], seen[1])
    x = _batch()[0].chunk(2)
    for i in range(2):
        m = copy.deepcopy(model).train()
        with torch.no_grad(), stochastic.random_stream(
                stochastic.stream_generator("cpu", 2, 7, i)):
            m(x[i])
        assert torch.equal(stochastic.stochastic_layers(m)[
            "ConvBlockRegulated_0.drop"].drawn, seen[i])


@pytest.mark.parametrize("mode", ["full", "conv_outs", "dots", "blocks"])
def test_remat_keeps_the_plain_steps_draws_and_gradients(mode):
    """The recomputed forward reuses the forward's draws: the loss and
    every gradient equal the plain step's, on SAUNet and on the
    MultiRes variant (whose regulated blocks ``remat = blocks``
    checkpoints)."""
    for arch in ("SAUNet", "SAMultiResUNet"):
        base = model_selector_1d(arch, 32, 2, 1, 4, 3, block_size=3,
                                 keep_prob=0.8,
                                 generator=torch.Generator().manual_seed(1))
        plain, remat_model = copy.deepcopy(base), copy.deepcopy(base)
        kw = {}
        if mode == "blocks":
            blocks.set_block_remat(remat_model, True)
        else:
            kw["remat"] = mode
        want = _step(plain, seed=1, step=2)
        got = _step(remat_model, seed=1, step=2, **kw)
        assert got[0] == want[0]
        gp = dict(plain.named_parameters())
        for k, p in remat_model.named_parameters():
            assert torch.allclose(p.grad, gp[k].grad, rtol=0, atol=1e-7), k


def test_nothing_is_drawn_outside_training():
    """Eval-mode forwards, the eval step and the predict step leave every
    layer's draws untouched (None) and give the deterministic output."""
    model = _saunet()
    x, y = _batch()
    ev = make_eval_step(model, get_loss("MeanAbsoluteError"))
    _, out, _ = ev(x, y)
    pred = make_predict_step(model)(x)
    assert torch.equal(out["out"], pred["out"])
    assert stochastic.drawn_by_name(model) == {}
    assert not remat.recomputing()


def _sigterm_batches(sigterm_at=None):
    x, y = _batch(n=8)

    class Batches:
        epoch = 0

        def set_epoch(self, epoch):
            self.epoch = epoch

        def __call__(self):
            epoch, self.epoch = self.epoch, self.epoch + 1
            for b in range(2):
                if sigterm_at == (epoch, b):
                    signal.raise_signal(signal.SIGTERM)
                yield x[4 * b:4 * b + 4], y[4 * b:4 * b + 4]

    return Batches()


def test_sigterm_resumed_saunet_run_equals_a_straight_one(tmp_path):
    """DropBlock at keep_prob 0.8: a run stopped by SIGTERM in epoch 1 and
    resumed from ``last`` draws the straight run's masks (the restored
    step count keys them): its history and weights equal the straight
    run's bit for bit."""
    def fit(ckpt, **kw):
        tr = Trainer(_saunet(), loss="MeanAbsoluteError", learning_rate=1e-2,
                     device="cpu", seed=4)
        hist = tr.fit(_sigterm_batches(**kw), epochs=3, checkpoint=ckpt,
                      monitor="loss", verbose=0, exact_resume=True)
        return tr, hist

    straight, want = fit(CheckpointManager(str(tmp_path / "a")))
    ckpt = CheckpointManager(str(tmp_path / "b"))
    first, _ = fit(ckpt, sigterm_at=(1, 1))
    assert first.preempted
    resumed, got = fit(ckpt)
    assert got["loss"] == want["loss"]
    sa, sb = straight.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
