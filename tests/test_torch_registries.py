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
history."""
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

def _loss_inputs(name, channels, seed=0):
    """Probabilities with the clip's edges (0, 1, 1e-9), errors of exactly
    0 and exactly 1 (Huber's delta), tied channel maxima (CategoricalHinge)
    and an all-zero channel vector (CosineSimilarity); integer labels for
    the sparse CCE, -1 among them (counted from the end)."""
    rng = np.random.default_rng(seed)
    shape = (2, 5, 6, channels)
    p = rng.uniform(size=shape).astype(np.float32)
    t = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    p.reshape(-1)[:3] = [0.0, 1.0, 1e-9]
    t.reshape(-1)[:3] = [0.0, 0.0, 1.0]    # |err| 0, 1 and ~1
    p[0, 1] = t[0, 1]                       # |err| exactly 0
    p[1, 1, 1] = 0.0                        # an all-zero channel vector
    if channels == 3:
        t[1, 0, 0], p[1, 0, 0] = [1, 0, 0], [0.2, 0.6, 0.6]  # tied maxima
    if name == "SparseCategoricalCrossentropy":
        t = rng.integers(0, channels, shape[:-1] + (1,)).astype(np.float32)
        t.reshape(-1)[0] = -1.0
    return t, p


def test_loss_registry_has_the_jax_names():
    assert list(losses.LOSSES) == list(jlosses.LOSSES)
    with pytest.raises(ValueError):
        losses.get_loss("NoSuchLoss")


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("name", list(jlosses.LOSSES))
def test_loss_and_its_gradient_equal_jax(name, channels):
    t, p = _loss_inputs(name, channels)
    want, jgrad = jax.value_and_grad(
        lambda q: jlosses.get_loss(name)(jnp.asarray(t), q))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    got = losses.get_loss(name)(torch.from_numpy(t), pt)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-4, atol=1e-4)


def test_sparse_cce_label_outside_the_channels_is_nan_as_in_jax():
    """JAX's ``take_along_axis`` fills NaN (no gradient) where ``gather``
    would fault."""
    p = np.full((1, 2, 2), 0.5, np.float32)
    t = np.array([[[1.0], [2.0]]], np.float32)
    want, jgrad = jax.value_and_grad(lambda q: jlosses.get_loss(
        "SparseCategoricalCrossentropy")(jnp.asarray(t), q))(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_()
    got = losses.get_loss("SparseCategoricalCrossentropy")(
        torch.from_numpy(t), pt)
    got.backward()
    assert np.isnan(float(want)) and np.isnan(float(got.detach()))
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgrad))


# ----------------------------------------------------------------- metrics

_TH = [np.float32(0.5), np.float32(1 / 199), np.float32(100 / 199),
       np.float32(0.0), np.float32(1.0)]


def _metric_batch(name, seed, num_classes):
    """One batch for ``name``: integer labels for IoU and MeanIoU (both
    arguments) and for the sparse metrics (targets); one-hot targets and
    7 channels for the top-k accuracies; binary targets and probabilities
    with values exactly at thresholds otherwise."""
    rng = np.random.default_rng(seed)
    short = name[len(KERAS):] if name.startswith(KERAS) else name
    channels = 7 if "TopK" in short else max(num_classes, 3)
    shape = (2, 5, 6, channels)
    p = rng.uniform(size=shape).astype(np.float32)
    p.reshape(-1)[:len(_TH)] = _TH
    if short in ("IoU", "MeanIoU"):
        lab = rng.integers(0, num_classes, (2, 5, 6, 2)).astype(np.float32)
        return lab[..., :1], lab[..., 1:]
    if short.startswith("Sparse"):
        t = rng.integers(0, channels, shape[:-1] + (1,))
        return t.astype(np.float32), p
    if short in ("CategoricalAccuracy", "TopKCategoricalAccuracy",
                 "OneHotIoU", "OneHotMeanIoU", "CategoricalCrossentropy",
                 "CategoricalHinge"):
        t = np.eye(channels, dtype=np.float32)[
            rng.integers(0, num_classes, shape[:-1])]
        return t, p
    t = (rng.uniform(size=shape) > 0.5).astype(np.float32)
    p[0, 0, 0] = t[0, 0, 0]  # Accuracy counts exact equality
    return t, p


def _stream(name, num_classes, batches=(0, 1, 2)):
    jm = jmetrics.make_metric(name, num_classes=num_classes)
    tm = metrics.make_metric(name, num_classes=num_classes)
    js, ts = jm.init(), tm.init(None)
    for seed in batches:
        t, p = _metric_batch(name, seed, num_classes)
        js = jm.update(js, jnp.asarray(t), jnp.asarray(p))
        ts = tm.update(ts, torch.from_numpy(t), torch.from_numpy(p))
    return float(tm.result(ts)), float(jm.result(js)), tm, ts


@pytest.mark.parametrize("name", jmetrics.METRIC_NAMES + SHORT)
def test_streamed_metric_equals_jax(name):
    got, want, _, _ = _stream(name, 2)
    assert np.isfinite(want)
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("num_classes", [2, 3])
@pytest.mark.parametrize("name", IOU)
def test_iou_family_sized_by_num_classes_equals_jax(name, num_classes):
    got, want, tm, ts = _stream(name, num_classes)
    assert ts["cm"].shape == (num_classes, num_classes)
    assert abs(got - want) <= 1e-6, (got, want)


@pytest.mark.parametrize("name", jmetrics.METRIC_NAMES)
def test_metric_states_merge_additively(name):
    """Two batches' states added key by key give the result of one stream
    over both (the JAX states merge with one psum)."""
    m = metrics.make_metric(name)
    states = []
    for seed in (0, 1):
        t, p = _metric_batch(name, seed, 2)
        states.append(m.update(m.init(None), torch.from_numpy(t),
                               torch.from_numpy(p)))
    merged = {k: states[0][k] + states[1][k] for k in states[0]}
    assert all(v.dtype == torch.float32 for v in merged.values())
    _, _, _, streamed = _stream(name, 2, batches=(0, 1))
    a, b = float(m.result(merged)), float(m.result(streamed))
    assert abs(a - b) <= 1e-6 * max(1.0, abs(b))


def test_metric_names_and_refusals():
    for name in jmetrics.METRIC_NAMES + SHORT:
        assert metrics.make_metric(name).name == name
    for bad in ("NoSuchMetric", KERAS + "AUC"):
        with pytest.raises(ValueError):
            metrics.make_metric(bad)
        with pytest.raises(ValueError):
            jmetrics.make_metric(bad)


@pytest.mark.parametrize("num_thresholds", [1, 3, 200])
def test_bucketize_counts_equal_the_broadcast_counts(num_thresholds):
    """Every threshold hit exactly, NaN, and values outside [0, 1]: the
    counts equal the broadcast's and the JAX ``_conf_counts``'s."""
    th = np.asarray(jmetrics._keras_thresholds(num_thresholds), np.float32)
    rng = np.random.default_rng(num_thresholds)
    p = np.concatenate([th, th, rng.uniform(-0.1, 1.1, 500).astype(
        np.float32), [np.nan, -1.0, 2.0]]).astype(np.float32)
    t = (rng.uniform(size=p.shape) > 0.4).astype(np.float32)
    tth = torch.from_numpy(th)
    got = metrics.conf_counts(torch.from_numpy(t), torch.from_numpy(p), tth)
    ref = metrics.conf_counts_broadcast(torch.from_numpy(t),
                                        torch.from_numpy(p), tth)
    want = jmetrics._conf_counts(jnp.asarray(t), jnp.asarray(p),
                                 jnp.asarray(th))
    for k in ("tp", "fp", "fn", "tn"):
        assert torch.equal(got[k], ref[k]), k
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    assert float((got["tp"] + got["fn"])[0]) == float(t.sum())


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


VERB_METRICS = ("MeanIoU", "OneHotMeanIoU", "AUC", "Precision", "Recall",
                "BinaryAccuracy", "tf.keras.metrics.TruePositives")


@pytest.fixture(scope="module")
def nadam_fold(tmp_path_factory):
    """The port's train verb through the command line on the CPU: W4/D2
    UNet 32x32, ``class_number = 2``, FocalLoss, Nadam with every clip,
    the IoU and threshold metrics, 1 epoch."""
    tmp = str(tmp_path_factory.mktemp("registries_verb"))
    for name, n, seed in (("Train", 4, 0), ("Val", 2, 1)):
        synthetic.write_image_folder(os.path.join(tmp, "Data", name),
                                     *synthetic.synthetic_images(n, 32,
                                                                 seed=seed))
    cfg = TrainConfig(
        train_dir=os.path.join(tmp, "Data", "Train"),
        val_dir=os.path.join(tmp, "Data", "Val"), imlength=32, imwidth=32,
        decoder_name="UNet", model_width=4, model_depth=2, batch_size=2,
        num_epochs=1, learning_rate=1e-3, class_number=2,
        loss_function="FocalLoss", optimizer_function="Nadam",
        clipnorm=0.5, clipvalue=0.05, global_clipnorm=1.0,
        metric_list=VERB_METRICS, save_dir=os.path.join(tmp, "Results"),
        load_weights=False, seed=3)
    ini = os.path.join(tmp, "Train_Configs.ini")
    save_train_config(cfg, ini)
    cli_main(["train", ini, "--device", "cpu"])
    return tmp, cfg, ini


def test_train_verb_history_equals_the_jax_verbs(nadam_fold, tmp_path):
    """Every metric under the JAX key, train and val, each value finite;
    the JAX verb on the same INI gives the same keys in the same order;
    both packages' Trainers size the IoU matrices by class_number + 1."""
    _, cfg, ini = nadam_fold
    with open(os.path.join(cfg.save_dir, "Fold_1", "history.json")) as f:
        got = json.load(f)
    for m in VERB_METRICS:
        for key in (m, f"val_{m}"):
            assert len(got[key]) == 1 and np.isfinite(got[key][0]), key
    jcfg = jconfig.load_train_config(ini)
    jcfg.save_dir = str(tmp_path / "jax")
    want = jdrivers.train(config=jcfg)[1]
    assert list(got) == list(want)
    trainer = drivers._make_trainer(cfg, drivers._build_model(cfg), "cpu")
    cm = [s["cm"] for s in trainer._metric_init() if "cm" in s]
    assert [tuple(c.shape) for c in cm] == [(3, 3), (3, 3)]
    assert isinstance(trainer.optimizer, optimizers.Nadam)
    assert len(trainer.optimizer._optimizer_step_pre_hooks) == 1  # clips
    parser = configparser.ConfigParser()
    parser.read(os.path.join(cfg.save_dir, "Train_Configs.ini"))
    assert float(parser["TRAIN"]["global_clipnorm"]) == 1.0
