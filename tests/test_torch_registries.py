"""The port's loss, metric and optimizer registries against the JAX
package's, name by name, on the same numpy inputs from a seed: every loss
in value and gradient with respect to the prediction (float32, 1e-4),
every metric streamed over 3 batches (1e-6; the IoU family at 2 and 3
classes), the threshold counts from ``bucketize`` against the JAX
broadcast, ties included; every optimizer, alone and with each gradient
clip, 5 steps from the converted optax state (parameters within 1e-5
relative); the converter's optimizer states and its one-to-one map of
flax leaves to torch parameters; the clip keys through the INI; and one
``train`` verb run (W4/D2 32x32, ``class_number = 2``, Nadam with every
clip, FocalLoss and the IoU and threshold metrics) against the JAX verb's
history.  The losses, the metrics and the verb run are in
test_torch_registries_metrics.py (split to keep each file short on one
test worker)."""
import configparser
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu import drivers as jdrivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    Trainer as JaxTrainer, losses as jlosses, metrics as jmetrics,
    optimizers as joptim)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import drivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import (  # noqa: E402
    main as cli_main)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import synthetic  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    losses, metrics, optimizers)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TrainConfig, load_train_config, save_train_config,
    unported_train_keys)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict, load_flax_variables, load_optax_state)

KERAS = "tf.keras.metrics."
SHORT = tuple(n[len(KERAS):] for n in jmetrics.METRIC_NAMES
              if n.startswith(KERAS))
IOU = ("IoU", "MeanIoU", "OneHotIoU", "OneHotMeanIoU")


# ------------------------------------------------------------------ losses


# ----------------------------------------------------------------- metrics


# -------------------------------------------------------------- optimizers

@pytest.fixture(scope="module")
def flax_unet():
    """A W4/D2 UNet's flax variables (the JAX package's initial state) and
    the port's model built from the same INI."""
    cfg = TrainConfig(imlength=16, imwidth=16, decoder_name="UNet",
                      model_width=4, model_depth=2)
    jt = JaxTrainer(jdrivers._build_model(jconfig.TrainConfig(
        imlength=16, imwidth=16, decoder_name="UNet", model_width=4,
        model_depth=2)))
    jt.init_state(np.zeros((1, 16, 16, 3), np.float32))
    variables = {"params": jax.tree.map(np.asarray, jt.state.params),
                 "batch_stats": jax.tree.map(np.asarray,
                                             jt.state.batch_stats)}
    return cfg, variables


def _grads(params, n, seed=0):
    """``n`` gradient trees shaped as ``params``: normals, each leaf at its
    own scale (so a per-leaf clip bites on some leaves only)."""
    rng = np.random.default_rng(seed)
    scales = jax.tree.map(lambda _: rng.uniform(0.01, 1.0), params)
    return [jax.tree.map(lambda a, s: (rng.normal(size=a.shape) * s).astype(
        np.float32), params, scales) for _ in range(n)]


def _clips(kind, g):
    """Clip settings that bite on the gradient tree ``g``."""
    leaves = jax.tree.leaves(g)
    norms = [float(np.linalg.norm(x)) for x in leaves]
    total = float(np.sqrt(sum(n * n for n in norms)))
    allc = dict(global_clipnorm=0.5 * total,
                clipnorm=float(np.median(norms)),
                clipvalue=float(np.median(np.abs(np.concatenate(
                    [x.ravel() for x in leaves])))))
    return allc if kind == "all" else {
        k: v for k, v in allc.items() if k == kind}


def _port(cfg, variables):
    model = drivers._build_model(cfg)
    load_flax_variables(model, variables)
    return model


def _set_grads(model, g):
    conv = flax_to_state_dict({"params": g}, dict(model.named_parameters()))
    for name, p in model.named_parameters():
        p.grad = conv[name].clone()


def _optax_steps(tx, state, params, grads):
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, upd)
    return state, params


@pytest.mark.parametrize("clip", ["none", "global_clipnorm", "clipnorm",
                                  "clipvalue", "all"])
@pytest.mark.parametrize("name", joptim.OPTIMIZER_NAMES)
def test_optimizer_equals_optax(flax_unet, name, clip):
    """Two optax steps, the state converted, then 5 steps of each package
    on the same gradients (the learning rate halved through each
    package's hook before the last 2): the parameters agree within 1e-5
    relative."""
    cfg, variables = flax_unet
    lr = 1e-2
    grads = _grads(variables["params"], 7)
    kw = {} if clip == "none" else _clips(clip, grads[0])
    tx = joptim.make_optimizer(name, lr, **kw)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state, params = _optax_steps(tx, tx.init(params), params, grads[:2])
    model = _port(cfg, {"params": params,
                        "batch_stats": variables["batch_stats"]})
    opt = optimizers.make_optimizer(name, model.parameters(), lr, **kw)
    load_optax_state(opt, model, name, state)
    for i, g in enumerate(grads[2:]):
        if i == 3:
            state = joptim.set_learning_rate(state, lr / 2)
            optimizers.set_learning_rate(opt, lr / 2)
        state, params = _optax_steps(tx, state, params, [g])
        _set_grads(model, g)
        opt.step()
    want = flax_to_state_dict({"params": params},
                              dict(model.named_parameters()))
    for pname, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[pname].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=pname)


@pytest.mark.parametrize("name", joptim.OPTIMIZER_NAMES)
def test_runtime_lr_hook_survives_clipping(name):
    """As tests/test_clipping.py holds the JAX package: the learning rate
    is read and set through the clip chain, and the update is finite."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = optimizers.make_optimizer(name, [p], 1e-3, clipnorm=1.0,
                                    clipvalue=1.0, global_clipnorm=5.0)
    assert optimizers.get_learning_rate(opt) == pytest.approx(1e-3)
    optimizers.set_learning_rate(opt, 5e-4)
    assert optimizers.get_learning_rate(opt) == pytest.approx(5e-4)
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    opt.step()
    p = p.detach()
    assert bool(torch.isfinite(p).all()) and float(p.abs().sum()) > 0


def test_clips_equal_the_jax_chain():
    """tests/test_clipping.py's gradients through SGD at lr 1: each clip
    alone gives the JAX chain's update."""
    grads = {"a": [3.0, 4.0, 0.0], "b": [0.3, -0.4]}
    for kw in ({"clipnorm": 1.0}, {"global_clipnorm": 1.0},
               {"clipvalue": 0.35}, {"global_clipnorm": 100.0},
               {"clipnorm": 1.0, "clipvalue": 0.5, "global_clipnorm": 2.0}):
        tx = joptim.make_optimizer("SGD", 1.0, **kw)
        params = {k: jnp.zeros(len(v)) for k, v in grads.items()}
        upd, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()},
                           tx.init(params), params)
        ps = {k: torch.nn.Parameter(torch.zeros(len(v)))
              for k, v in grads.items()}
        opt = optimizers.make_optimizer("SGD", list(ps.values()), 1.0, **kw)
        for k, p in ps.items():
            p.grad = torch.tensor(grads[k])
        opt.step()
        for k, p in ps.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(upd[k]), rtol=1e-6,
                                       err_msg=str(kw))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        optimizers.make_optimizer("NoSuchOptimizer", [], 1e-3)


# --------------------------------------------------------------- converter

def _to_flax(t):
    # the converter's OIHW/(C_in, C_out, kh, kw) back to flax's layout
    a = t.detach().numpy()
    return a.transpose(2, 3, 1, 0) if a.ndim == 4 else a


@pytest.mark.parametrize("name", joptim.OPTIMIZER_NAMES)
def test_load_optax_state_round_trip(flax_unet, name):
    """Every per-parameter tree of the optax state (through the clip
    chain) comes back from the torch state unchanged, and so do the
    learning rate and the count."""
    cfg, variables = flax_unet
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = joptim.make_optimizer(name, 3e-3, clipnorm=1.0, clipvalue=1.0,
                               global_clipnorm=5.0)
    state, _ = _optax_steps(tx, tx.init(params), params,
                            _grads(variables["params"], 3, seed=1))
    model = _port(cfg, variables)
    opt = optimizers.make_optimizer(name, model.parameters(), 1.0)
    load_optax_state(opt, model, name, state)
    assert optimizers.get_learning_rate(opt) == pytest.approx(3e-3)
    inner = state.inner_state[-1]
    trees = {"Adam": lambda: {"exp_avg": inner[0].mu,
                              "exp_avg_sq": inner[0].nu},
             "Adamax": lambda: {"exp_avg": inner[0].mu,
                                "exp_inf": inner[0].nu},
             "Nadam": lambda: {"mu": inner[0].mu, "nu": inner[0].nu},
             "Adadelta": lambda: {"square_avg": inner[1].e_g,
                                  "acc_delta": inner[1].e_x},
             "Adagrad": lambda: {"sum_of_squares": inner[0].sum_of_squares},
             "RMSprop": lambda: {"nu": inner[0].nu},
             "FTRL": lambda: {"accum": inner[0], "linear": inner[1]},
             "SGD": dict}[name]()
    named = dict(model.named_parameters())
    for key, tree in trees.items():
        flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
        assert len(flat) == len(named)
        for path, leaf in flat.items():
            names = [k.key for k in path]
            torch_key = ".".join(names[:-1] + [
                "bias" if names[-1] == "bias" else "weight"])
            got = _to_flax(opt.state[named[torch_key]][key])
            assert np.array_equal(got, np.asarray(leaf)), (key, torch_key)
    if name in ("Adam", "Adamax", "Adadelta", "Nadam"):
        assert all(float(opt.state[p]["step"]) == 3 for p in named.values())


def test_flax_leaves_and_torch_parameters_map_one_to_one(flax_unet):
    """One torch parameter per flax leaf and back (the per-variable
    clipnorm's unit); two leaves onto one torch key raise."""
    cfg, variables = flax_unet
    model = _port(cfg, variables)
    named = dict(model.named_parameters())
    conv = flax_to_state_dict({"params": variables["params"]}, named)
    assert len(jax.tree.leaves(variables["params"])) == len(named)
    assert sorted(conv) == sorted(named)
    bn_path = next(k for k in named if k.endswith(".weight")
                   and named[k].dim() == 1).split(".")[:-1]
    tree = {"params": {}}
    node = tree["params"]
    for part in bn_path:
        node = node.setdefault(part, {})
    node["scale"] = np.ones(named[".".join(bn_path + ["weight"])].shape,
                            np.float32)
    node["kernel"] = node["scale"]
    with pytest.raises(KeyError, match="two flax leaves"):
        flax_to_state_dict(tree, named)


# ------------------------------------------------------------------ verbs

def test_clip_keys_round_trip_through_the_ini(tmp_path):
    """The port writes the clip keys that both packages read back, reads
    the JAX package's, and its train verb no longer refuses them."""
    cfg = TrainConfig(clipnorm=1.5, clipvalue=0.5, global_clipnorm=10.0)
    path = str(tmp_path / "port.ini")
    save_train_config(cfg, path)
    for loaded in (load_train_config(path), jconfig.load_train_config(path)):
        assert (loaded.clipnorm, loaded.clipvalue, loaded.global_clipnorm) \
            == (1.5, 0.5, 10.0)
    jpath = str(tmp_path / "jax.ini")
    jconfig.save_train_config(jconfig.TrainConfig(
        clipnorm=2.5, clipvalue=0.25, global_clipnorm=3.0), jpath)
    loaded = load_train_config(jpath)
    assert (loaded.clipnorm, loaded.clipvalue, loaded.global_clipnorm) == (
        2.5, 0.25, 3.0)
    assert unported_train_keys(loaded) == []
