"""The train step's options and the callbacks of the port against the JAX
package, on the CPU: gradient accumulation, the four remat modes and the
EMA shadow against JAX's ``make_train_step`` (UNet++ W4/D2 on (4, 32, 32,
3), float32, within 1e-4: loss, every gradient, parameters and shadow;
BatchNorm's running statistics within 1e-5), each remat mode equal to the
plain step bit for bit within the port, block remat keeping the
``state_dict`` keys; the callbacks' state, NaNGuard's two recoveries and
the learning rate schedules by value; ``resume_token`` equal to JAX's;
and the train verb with accumulation, remat, EMA and TensorBoard against
the JAX verb (history within 1e-4, ``history.h5`` and the TensorBoard
scalars read back)."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu import drivers as jdrivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    Trainer as JaxTrainer, callbacks as jcb, losses as jlosses,
    optimizers as joptim, state as jstate)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import drivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.data import synthetic  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.ops import remat  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    CheckpointManager, LearningRateScheduler, NaNGuard, Trainer,
    bce_dice_loss, callbacks, make_optimizer, make_train_step)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TrainConfig, resume_token, unported_train_keys)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    ema_from_flax, flax_to_state_dict, load_flax_variables)

LR = 0.1  # SGD: a step's gradient is (before - after) / LR on the JAX side
TOL = 1e-4
STATS_TOL = 1e-5
STEPS = 2
# the step options under test, as JAX make_train_step's keyword arguments
# (blocks: the model's block_remat)
OPTIONS = {
    "accum2": dict(accum_steps=2),
    "dots": dict(remat="dots"),
    "conv_outs": dict(remat="conv_outs"),
    "full": dict(remat="full"),
    "blocks": dict(),
    "ema": dict(ema_decay=0.9),
}


def _batches(n=STEPS, seed=11):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(size=(4, 32, 32, 3)).astype(np.float32),
             (rng.uniform(size=(4, 32, 32, 1)) > 0.6).astype(np.float32))
            for _ in range(n)]


def _jax_steps(option, batches):
    """JAX: the states before and after each step, and the losses."""
    kw = OPTIONS[option]
    jm = JaxSegModel(decoder_name="UNetPP", model_width=4, model_depth=2,
                     output_nums=1, final_activation="sigmoid",
                     block_remat=option == "blocks")
    variables = random_variables(jm, jnp.asarray(batches[0][0]), seed=3)
    # the accumulation case also clips: the clip must see the averaged
    # gradient
    clip = 0.05 if option == "accum2" else 0.0
    opt = joptim.make_optimizer("SGD", LR, global_clipnorm=clip)
    state = jstate.create_train_state(
        jm, jax.random.PRNGKey(0), jnp.asarray(batches[0][0]), opt,
        ema="ema_decay" in kw, variables=variables)
    step = jax.jit(jstate.make_train_step(jm, opt, jlosses.bce_dice_loss,
                                          **kw))
    states, losses = [jax.device_get(state)], []
    for x, y in batches:
        state, loss, _ = step(state, jnp.asarray(x), jnp.asarray(y))
        states.append(jax.device_get(state))
        losses.append(float(loss))
    return states, losses, clip


def _port_model(state, block_remat=False):
    tm = SegModel("UNetPP", 4, 2, in_channels=3, output_nums=1,
                  final_activation="sigmoid", block_remat=block_remat)
    load_flax_variables(tm, {"params": state.params,
                             "batch_stats": state.batch_stats})
    return tm


def _tree(model, tree):
    return {k: v.numpy() for k, v in flax_to_state_dict(
        {"params": tree}, dict(model.named_parameters())).items()}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_train_step_option_equals_jax(option):
    """Two SGD steps from the same converted state: loss, every gradient
    (JAX's as (before - after) / lr), parameters and, for ``ema``, the
    shadow within 1e-4; running statistics within 1e-5."""
    batches = _batches()
    states, jlosses_, clip = _jax_steps(option, batches)
    kw = dict(OPTIONS[option])
    tm = _port_model(states[0], block_remat=option == "blocks")
    opt = make_optimizer("SGD", tm.parameters(), LR, global_clipnorm=clip)
    ema = (ema_from_flax(tm, states[0].ema_params) if "ema_decay" in kw
           else None)
    step = make_train_step(tm, opt, bce_dice_loss,
                           remat=kw.get("remat"),
                           accum_steps=kw.get("accum_steps", 1),
                           ema=ema, ema_decay=kw.get("ema_decay", 0.0))
    for i, (x, y) in enumerate(batches):
        loss, _ = step(torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(loss) - jlosses_[i]) < TOL, option
        before, after = (_tree(tm, states[i].params),
                         _tree(tm, states[i + 1].params))
        for name, p in tm.named_parameters():
            want_g = (before[name] - after[name]) / LR
            np.testing.assert_allclose(p.grad.numpy(), want_g, atol=TOL,
                                       err_msg=f"{option} grad {name}")
            np.testing.assert_allclose(p.detach().numpy(), after[name],
                                       atol=TOL, err_msg=f"{option} {name}")
        want_bs = flax_to_state_dict(
            {"batch_stats": states[i + 1].batch_stats},
            {k: v for k, v in tm.state_dict().items() if "running" in k})
        for k, v in want_bs.items():
            np.testing.assert_allclose(tm.state_dict()[k].numpy(),
                                       v.numpy(), atol=STATS_TOL,
                                       err_msg=f"{option} {k}")
        if ema is not None:
            want_e = _tree(tm, states[i + 1].ema_params)
            for (name, _), e in zip(tm.named_parameters(), ema):
                np.testing.assert_allclose(e.numpy(), want_e[name],
                                           atol=TOL,
                                           err_msg=f"shadow {name}")


def _port_steps(block_remat=False, **kw):
    """Two Adam steps of a seeded port model: loss, gradients, state."""
    torch.manual_seed(0)
    tm = SegModel("UNetPP", 4, 2, generator=torch.Generator().manual_seed(4),
                  block_remat=block_remat)
    opt = make_optimizer("Adam", tm.parameters(), 1e-3)
    step = make_train_step(tm, opt, bce_dice_loss, **kw)
    out = []
    for x, y in _batches(seed=12):
        loss, _ = step(torch.from_numpy(x), torch.from_numpy(y))
        out.append((loss, {n: p.grad.clone()
                           for n, p in tm.named_parameters()},
                    {k: v.clone() for k, v in tm.state_dict().items()}))
    return out


@pytest.mark.parametrize("mode", ["dots", "conv_outs", "full", "blocks"])
def test_remat_mode_equals_the_plain_step_bit_for_bit(mode):
    """The recomputed forward gives the plain step's loss, gradients,
    parameters and running statistics exactly: BatchNorm advances once."""
    plain = _port_steps()
    got = (_port_steps(block_remat=True) if mode == "blocks"
           else _port_steps(remat=mode))
    for (l0, g0, s0), (l1, g1, s1) in zip(plain, got):
        assert torch.equal(l0, l1)
        assert all(torch.equal(g0[k], g1[k]) for k in g0)
        assert all(torch.equal(s0[k], s1[k]) for k in s0)


def test_unknown_remat_policy_raises():
    tm = SegModel("UNet", 4, 2)
    with pytest.raises(ValueError, match="unknown remat policy"):
        make_train_step(tm, make_optimizer("Adam", tm.parameters(), 1e-3),
                        bce_dice_loss, remat="bogus")
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(tm, make_optimizer("Adam", tm.parameters(), 1e-3),
                        bce_dice_loss, accum_steps=3)(
            torch.zeros(4, 16, 16, 3), torch.zeros(4, 16, 16, 1))


@pytest.mark.parametrize("decoder", ["UNetPP", "UNet3P", "MultiResUNet",
                                     "KSSNet"])
def test_block_remat_keeps_state_dict_keys(decoder, tmp_path):
    """``remat = blocks`` is a flag inside the blocks: the same keys, a
    plain model's ``best.pt`` loads into a block-remat model and back, and
    the flax converter fills it from a JAX ``block_remat`` model."""
    plain = SegModel(decoder, 4, 2, generator=torch.Generator().manual_seed(1))
    rem = SegModel(decoder, 4, 2, generator=torch.Generator().manual_seed(1),
                   block_remat=True)
    assert list(plain.state_dict()) == list(rem.state_dict())
    assert any(getattr(m, "remat", False) for m in rem.modules())
    path = str(tmp_path / "best.pt")
    torch.save(plain.state_dict(), path)
    rem.load_state_dict(torch.load(path, weights_only=True))
    jm = JaxSegModel(decoder_name=decoder, model_width=4, model_depth=2,
                     block_remat=True)
    load_flax_variables(rem, random_variables(
        jm, jnp.zeros((1, 16, 16, 3)), seed=2))


# ------------------------------------------------------------ callbacks

LOGS = [{"val_loss": v, "loss": v + 0.1}
        for v in (1.0, 0.9, 0.95, 0.97, 0.89, 0.99, 1.2, 0.5)]


@pytest.mark.parametrize("name", ["EarlyStopping", "ReduceLROnPlateau",
                                  "BestTracker"])
def test_callback_state_dicts_equal_jax(name):
    """Epoch by epoch, the same decisions and the same state dicts; a
    callback loaded from the other package's state dict continues alike."""
    kw = {"EarlyStopping": dict(patience=3),
          "ReduceLROnPlateau": dict(patience=2, factor=0.5),
          "BestTracker": {}}[name]
    ours, theirs = getattr(callbacks, name)(**kw), getattr(jcb, name)(**kw)
    lr = jlr = 1e-3
    for epoch, logs in enumerate(LOGS):
        if name == "BestTracker":
            assert ours.is_best(logs) == theirs.is_best(logs)
        elif name == "ReduceLROnPlateau":
            lr, jlr = (ours.on_epoch_end(epoch, logs, lr),
                       theirs.on_epoch_end(epoch, logs, jlr))
            assert lr == jlr
        else:
            ours.on_epoch_end(epoch, logs)
            theirs.on_epoch_end(epoch, logs)
        assert ours.state_dict() == theirs.state_dict()
        again = getattr(callbacks, name)(**kw)
        again.load_state_dict(json.loads(json.dumps(theirs.state_dict())))
        assert again.state_dict() == ours.state_dict()


def test_nan_guard_and_schedules_equal_jax():
    guard, jguard = NaNGuard(max_restores=2), jcb.NaNGuard(max_restores=2)
    for logs in ({"loss": 1.0}, {"loss": math.nan}, {"loss": math.inf},
                 {"loss": math.nan}, {}):
        assert guard.check(logs) == jguard.check(logs)
        if guard.check(logs):
            assert guard.on_failure() == jguard.on_failure()
        assert guard.state_dict() == jguard.state_dict()
    for args in ((1e-3, 10), (1e-3, 4, 1e-5, 2), (2e-2, 1, 0.0, 3)):
        ours, theirs = callbacks.cosine_decay(*args), jcb.cosine_decay(*args)
        assert [ours(e) for e in range(12)] == [theirs(e) for e in range(12)]
    for args in ((1e-3, 0.5), (1e-2, 0.9, 3), (1.0, 0.1, 0)):
        ours = callbacks.exponential_decay(*args)
        theirs = jcb.exponential_decay(*args)
        assert [ours(e) for e in range(8)] == [theirs(e) for e in range(8)]


def _signals(n=8, seed=0, size=16):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, size, size, 3)).astype(np.float32),
            (rng.uniform(size=(n, size, size, 1)) > 0.5).astype(np.float32))


def _loader(x, y, nan_epochs=()):
    """Batches of 4; the images of an epoch in ``nan_epochs`` are NaN."""
    calls = {"n": 0}

    def data():
        epoch = calls["n"]
        calls["n"] += 1
        for i in range(0, len(x), 4):
            xi = x[i:i + 4] * (np.nan if epoch in nan_epochs else 1.0)
            yield xi.astype(np.float32), y[i:i + 4]
    return data


@pytest.mark.parametrize("recovery", ["restored best", "re-initialized"])
def test_nan_guard_recovery_equals_jax(recovery, tmp_path, capsys):
    """A NaN epoch: with a best checkpoint both packages restore it, without
    one both draw fresh weights; then the learning rate halves.  The loss
    pattern, the learning rates and the guard's state equal JAX's (finite
    losses within 1e-4 where the weights are the same), and the weights
    end finite after a re-initialization."""
    x, y = _signals()
    jm = JaxSegModel(decoder_name="UNet", model_width=4, model_depth=2,
                     final_activation="sigmoid")
    jtr = JaxTrainer(jm, loss="BCEDiceLoss", learning_rate=1e-3, seed=5)
    variables = random_variables(jm, jnp.asarray(x[:1]), seed=6)
    jtr.init_state(x[:4], variables=variables)
    tm = SegModel("UNet", 4, 2, final_activation="sigmoid")
    load_flax_variables(tm, variables)
    tr = Trainer(tm, loss="BCEDiceLoss", learning_rate=1e-3, seed=5,
                 device="cpu")
    best = recovery == "restored best"
    nan_epochs = (1,) if best else (0,)
    hists, guards = [], []
    for which, trainer in (("jax", jtr), ("port", tr)):
        guard = (NaNGuard if which == "port" else jcb.NaNGuard)(
            max_restores=1)
        ckpt = None
        if best:
            ckpt = (CheckpointManager(str(tmp_path / which)) if which ==
                    "port" else jdrivers.CheckpointManager(
                        str(tmp_path / which)))
        hists.append(trainer.fit(_loader(x, y, nan_epochs), epochs=4,
                                 callbacks=[guard], checkpoint=ckpt,
                                 monitor="loss", verbose=1))
        guards.append(guard.state_dict())
    out = capsys.readouterr().out
    assert out.count(f"NaNGuard: non-finite loss; {recovery}") == 2
    (jh, ph), (jg, pg) = hists, guards
    assert pg == jg
    assert len(ph["loss"]) == len(jh["loss"])
    np.testing.assert_allclose(ph["lr"], jh["lr"], rtol=1e-6)
    assert [math.isfinite(v) for v in ph["loss"]] == [
        math.isfinite(v) for v in jh["loss"]]
    if best:
        np.testing.assert_allclose(ph["loss"][0], jh["loss"][0], atol=TOL)
    else:
        assert all(torch.isfinite(p).all() for p in tm.parameters())


def test_profile_dir_keeps_one_epochs_trace(tmp_path):
    """``profile_dir`` with ``profile_epoch``: a ``torch.profiler`` trace
    of that epoch, its train steps' operators in it."""
    x, y = _signals()
    tr = Trainer(SegModel("UNet", 4, 2), loss="BCEDiceLoss", device="cpu")
    tr.fit(_loader(x, y), epochs=2, verbose=0,
           profile_dir=str(tmp_path / "prof"), profile_epoch=1)
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names


def test_lr_scheduler_drives_the_logged_lr():
    """The schedule's rate at every epoch start, as JAX's
    ``test_lr_scheduler_cosine_drives_logged_lr``."""
    x, y = _signals()
    sched = callbacks.cosine_decay(1e-3, total_epochs=4, min_lr=1e-5,
                                   warmup_epochs=2)
    tr = Trainer(SegModel("UNet", 4, 2), loss="BinaryCrossentropy",
                 learning_rate=999.0, device="cpu")
    hist = tr.fit(_loader(x, y), epochs=4, verbose=0,
                  callbacks=[LearningRateScheduler(sched)])
    assert hist["lr"] == [sched(e) for e in range(4)]


@pytest.mark.parametrize("kw", [
    {}, dict(learning_rate=1e-3, remat="dots", accumulation_steps=2,
             ema_decay=0.99, augment_device=True, exact_resume=True),
    dict(patchify=True, patch_width=16, augment=True, decoder_name="UNet3P",
         d_s=1, tensorboard_dir="tb", optimizer_function="Nadam")],
    ids=["defaults", "options", "patches"])
def test_resume_token_equals_jax(kw):
    cfg = TrainConfig(**kw)
    want = jconfig.resume_token(jconfig.TrainConfig(**kw))
    assert resume_token(cfg) == want and len(want) == 16
    # bookkeeping fields do not change it, a training field does
    assert resume_token(dataclasses.replace(
        cfg, num_epochs=7, save_dir="elsewhere")) == want
    assert resume_token(dataclasses.replace(cfg, seed=99)) != want


# ------------------------------------------------------- the train verb

SIZE = 32


def _verb_cfg(tmp, **kw):
    base = dict(train_dir=os.path.join(tmp, "Data", "Train"),
                val_dir=os.path.join(tmp, "Data", "Val"), imlength=SIZE,
                imwidth=SIZE, decoder_name="UNetPP", model_width=4,
                model_depth=2, dense_loop=1, batch_size=4, num_epochs=2,
                learning_rate=1e-3, loss_function="BCEDiceLoss",
                metric_list=("MeanSquaredError",), load_weights=False, seed=3,
                accumulation_steps=2, remat="conv_outs", ema_decay=0.9,
                save_dir=os.path.join(tmp, "port"),
                tensorboard_dir=os.path.join(tmp, "tb_port"))
    base.update(kw)
    return TrainConfig(**base)


def _tb_scalars(directory):
    from tensorboard.backend.event_processing import event_accumulator

    acc = event_accumulator.EventAccumulator(directory, size_guidance={
        event_accumulator.SCALARS: 0, event_accumulator.TENSORS: 0})
    acc.Reload()
    out = {t: [e.step for e in acc.Scalars(t)] for t in acc.Tags()["scalars"]}
    for t in acc.Tags()["tensors"]:  # tf.summary writes scalars as tensors
        out[t] = [e.step for e in acc.Tensors(t)]
    return out


def test_train_verb_with_step_options_equals_jax(tmp_path):
    """``accumulation_steps = 2``, ``remat = conv_outs``, ``ema_decay``
    and ``tensorboard_dir`` through both verbs from the same weights: the
    history within 1e-4, ``history.h5`` holding it, the shadow beside
    ``best.pt``, and the same TensorBoard tags at the same steps."""
    import h5py

    tmp = str(tmp_path)
    x, y = synthetic.synthetic_images(8, SIZE, seed=0)
    synthetic.write_image_folder(os.path.join(tmp, "Data", "Train"), x, y)
    x, y = synthetic.synthetic_images(4, SIZE, seed=1)
    synthetic.write_image_folder(os.path.join(tmp, "Data", "Val"), x, y)
    cfg = _verb_cfg(tmp)
    jcfg = jconfig.TrainConfig(**dict(
        dataclasses.asdict(cfg), save_dir=os.path.join(tmp, "jax"),
        tensorboard_dir=os.path.join(tmp, "tb_jax")))
    want = jdrivers.train(config=jcfg)[1]
    # the port starts from the JAX fold's initial weights: the JAX verb
    # draws them from PRNGKey(seed), which the port cannot; so both start
    # from the weights a JAX Trainer draws for this seed
    jm = jdrivers._build_model(jcfg)
    jtr = JaxTrainer(jm, seed=cfg.seed)
    jtr.init_state(np.zeros((1, SIZE, SIZE, 3), np.float32))
    init = jax.device_get({"params": jtr.state.params,
                           "batch_stats": jtr.state.batch_stats})
    real_build = drivers._build_model

    def build(c, dtype=None, generator=None):
        model = real_build(c, dtype=dtype, generator=generator)
        load_flax_variables(model, init)
        return model

    drivers._build_model = build
    try:
        got = drivers.train(config=cfg, device="cpu")[1]
    finally:
        drivers._build_model = real_build
    assert list(got) == list(want)
    for k in want:
        if k not in ("steps_per_sec", "epoch_time"):
            np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=k)
    fold = os.path.join(cfg.save_dir, "Fold_1")
    assert {"best.pt", "best_ema.pt", "history.json", "history.h5",
            "history.png"} <= set(os.listdir(fold))
    with h5py.File(os.path.join(fold, "history.h5")) as hf:
        assert sorted(hf) == sorted(got)
        np.testing.assert_array_equal(hf["loss"][()], got["loss"])
    ours = _tb_scalars(os.path.join(tmp, "tb_port", "Fold_1"))
    theirs = _tb_scalars(os.path.join(tmp, "tb_jax", "Fold_1"))
    assert ours == theirs and set(ours) == set(got)
    assert all(steps == [0, 1] for steps in ours.values())


def test_unported_train_keys_are_the_multi_device_ones():
    cfg = TrainConfig(model_parallel=2, spatial_parallel=2,
                      pipeline_parallel=2, zero1=True, augment=True,
                      augment_device=True, patchify=True,
                      accumulation_steps=2, remat="full", ema_decay=0.5,
                      exact_resume=True, tensorboard_dir="tb")
    assert [k.split(" =")[0] for k in unported_train_keys(cfg)] == [
        "model_parallel", "spatial_parallel", "pipeline_parallel", "zero1"]


def test_remat_recompute_flag_is_scoped():
    """``recomputing()`` is true only inside a checkpoint's recompute."""
    seen = []

    def fn(t):
        seen.append(remat.recomputing())
        return (t * 2).sin()

    t = torch.ones(3, requires_grad=True)
    remat.checkpoint(fn, t, policy="full").sum().backward()
    assert seen == [False, True] and not remat.recomputing()
