"""Checkpoints and exact resume of the port, on the CPU (the JAX
package's tests/test_exact_resume.py for the port): a full checkpoint
round-trips the model, every optimizer's state, the step count and the
EMA shadow; a run resumed from ``last`` equals an uninterrupted one bit
for bit, whether it stopped at an epoch's end, at a raised SIGTERM in an
epoch or in its validation pass, with a ReduceLROnPlateau counter, or
through the train verb with ``augment_device`` and ``cache_data``; a
changed config starts fresh; the sidecar pairs with its arrays; and the
EMA shadow beside ``best.pt`` restores either way, is ignored when a cut
save left it beside other weights, and is what the ``test``, ``serve``
and ``predict`` verbs load."""
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tf_1d_2d_segmentation_end2endpipelines_torch import drivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.data import synthetic  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    OPTIMIZER_NAMES, CheckpointManager, ReduceLROnPlateau, Trainer)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import (  # noqa: E402
    checkpoint as ckpt_module)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TrainConfig)

TIMING = ("steps_per_sec", "epoch_time")


def _data(seed=0, n=8, size=16):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(n, size, size, 3)).astype(np.float32),
            (rng.uniform(size=(n, size, size, 1)) > 0.5).astype(np.float32))


class _Batches:
    """An (seed, epoch)-keyed loader of batches of 4, as PrefetchLoader's
    shuffle; ``sigterm_at`` raises SIGTERM before the batch of that
    (epoch, index)."""

    def __init__(self, x, y, seed=7, sigterm_at=None):
        self.x, self.y, self.seed = x, y, seed
        self.sigterm_at = sigterm_at
        self._epoch = 0

    def set_epoch(self, epoch):
        self._epoch = epoch

    def __call__(self):
        epoch = self._epoch
        self._epoch += 1
        idx = np.random.default_rng(self.seed + epoch).permutation(
            len(self.x))
        for b, s in enumerate(range(0, len(idx), 4)):
            if self.sigterm_at == (epoch, b):
                signal.raise_signal(signal.SIGTERM)
            sel = idx[s:s + 4]
            yield self.x[sel], self.y[sel]


def _trainer(**kw):
    model = SegModel("UNet", 4, 2, generator=torch.Generator().manual_seed(2))
    return Trainer(model, loss="BCEDiceLoss", learning_rate=1e-2,
                   metrics=("BinaryAccuracy",), device="cpu", **kw)


def _fit(tr, ckpt, epochs, val=None, callbacks=(), **loader_kw):
    x, y = _data()
    return tr.fit(_Batches(x, y, **loader_kw), val_data=val, epochs=epochs,
                  callbacks=callbacks, checkpoint=ckpt, monitor="loss",
                  verbose=0, exact_resume=True)


def _trajectory(history):
    return {k: v for k, v in history.items() if k not in TIMING}


def _same_weights(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return list(sa) == list(sb) and all(torch.equal(sa[k], sb[k])
                                        for k in sa)


@pytest.mark.parametrize("name", OPTIMIZER_NAMES)
def test_full_checkpoint_round_trips_every_optimizer(name, tmp_path):
    """save_full holds weights, optimizer state (the hand-written ones'
    included), step count and shadow; a fresh trainer restored from it
    takes the next step exactly as the saving one."""
    x, y = _data()
    kw = dict(optimizer=name, ema_decay=0.9, global_clipnorm=1.0)
    tr = _trainer(**kw)
    ckpt = CheckpointManager(str(tmp_path))
    for i in (0, 4):
        tr.train_step(*tr._batch(x[i:i + 4], y[i:i + 4]))
        tr.step += 1
    ckpt.save_full(tr.model, tr.optimizer, tr.step, "last", ema=tr.ema,
                   meta={"epoch": 2, "note": "hi"})
    assert ckpt.has_full("last") and not ckpt.has_full("best")
    tr2 = _trainer(**kw)
    step, meta = ckpt.restore_full(tr2.model, tr2.optimizer, "last",
                                   ema=tr2.ema)
    assert (step, meta["epoch"], meta["note"], meta["step"]) == (2, 2, "hi",
                                                                 2)
    for t in (tr, tr2):
        t.train_step(*t._batch(x[:4], y[:4]))
    assert _same_weights(tr.model, tr2.model)
    assert all(torch.equal(a, b) for a, b in zip(tr.ema, tr2.ema))


@pytest.mark.parametrize("options", [{}, dict(remat="conv_outs",
                                              accum_steps=2,
                                              ema_decay=0.9)],
                         ids=["plain", "remat_accum_ema"])
def test_interrupted_fit_equals_uninterrupted(options, tmp_path):
    """2 epochs, then a fresh trainer to 4: the history and weights of a
    straight 4-epoch run, bit for bit."""
    straight = _trainer(**options)
    want = _fit(straight, CheckpointManager(str(tmp_path / "a")), 4)
    ckpt = CheckpointManager(str(tmp_path / "b"))
    _fit(_trainer(**options), ckpt, 2)
    resumed = _trainer(**options)
    got = _fit(resumed, ckpt, 4)
    assert _trajectory(got) == _trajectory(want)
    assert _same_weights(resumed.model, straight.model)


@pytest.mark.parametrize("where", ["in an epoch", "in validation"])
def test_sigterm_resume_equals_uninterrupted(where, tmp_path):
    """A SIGTERM in epoch 1 (its second batch) or in epoch 1's validation
    pass: the run stops there, ``preempted`` is set, the previous handler
    is back, the sidecar records epoch 1, and the run resumed from
    ``last`` equals an uninterrupted one bit for bit."""
    x, y = _data()
    vx, vy = _data(seed=1, n=4)
    state = {"calls": 0}

    def val():
        state["calls"] += 1
        if where == "in validation" and state["calls"] == 2:
            signal.raise_signal(signal.SIGTERM)
        yield vx, vy

    straight = _trainer(ema_decay=0.5)
    want = _fit(straight, CheckpointManager(str(tmp_path / "a")), 3,
                val=lambda: iter([(vx, vy)]))
    ckpt = CheckpointManager(str(tmp_path / "b"))
    first = _trainer(ema_decay=0.5)
    prev = signal.getsignal(signal.SIGTERM)
    hist = _fit(first, ckpt, 3, val=val,
                sigterm_at=(1, 1) if where == "in an epoch" else None)
    assert first.preempted and signal.getsignal(signal.SIGTERM) == prev
    assert len(hist["loss"]) == 1
    assert ckpt.read_meta("last")["epoch"] == 1
    resumed = _trainer(ema_decay=0.5)
    got = _fit(resumed, ckpt, 3, val=lambda: iter([(vx, vy)]))
    assert not resumed.preempted
    assert _trajectory(got) == _trajectory(want)
    assert _same_weights(resumed.model, straight.model)
    assert all(torch.equal(a, b) for a, b in zip(resumed.ema, straight.ema))


def test_rlrop_counter_resumes(tmp_path):
    """A plateau counter half-way to its patience at the interruption:
    the resumed run cuts the rate when the straight run does."""
    def cb():
        return [ReduceLROnPlateau(monitor="loss", factor=0.5, patience=2,
                                  min_delta=10.0)]

    want = _fit(_trainer(), CheckpointManager(str(tmp_path / "a")), 5,
                callbacks=cb())
    ckpt = CheckpointManager(str(tmp_path / "b"))
    _fit(_trainer(), ckpt, 2, callbacks=cb())
    assert ckpt.read_meta("last")["callbacks"]["rlrop"]["wait"] == 1
    got = _fit(_trainer(), ckpt, 5, callbacks=cb())
    assert got["lr"] == want["lr"] and len(set(got["lr"])) > 1
    assert _trajectory(got) == _trajectory(want)


def test_changed_config_starts_fresh_and_tokenless_resumes(tmp_path, capsys):
    ckpt = CheckpointManager(str(tmp_path))
    x, y = _data()

    def fit(tr, epochs, token):
        return tr.fit(_Batches(x, y), epochs=epochs, checkpoint=ckpt,
                      monitor="loss", verbose=1, exact_resume=True,
                      resume_token=token)

    fit(_trainer(), 2, "stage1")
    h = fit(_trainer(), 2, "stage2")
    assert "DIFFERENT training config" in capsys.readouterr().out
    assert len(h["loss"]) == 2
    meta = ckpt.read_meta("last")
    meta.pop("config")
    with open(ckpt._meta_path("last"), "w") as f:
        json.dump(meta, f)
    h = fit(_trainer(), 3, "stage3")
    assert "continuing from epoch 2" in capsys.readouterr().out
    assert len(h["loss"]) == 3


def test_sidecar_pairs_with_its_arrays(tmp_path, capsys):
    """A kill between the arrays' rename and the sidecar's leaves the new
    arrays, the old sidecar and the new one staged: ``restore_full``
    adopts the staged one by its step token; without it, it warns."""
    ckpt = CheckpointManager(str(tmp_path))
    tr = _trainer()
    ckpt.save_full(tr.model, tr.optimizer, 3, meta={"epoch": 1})
    with open(ckpt._meta_path("last")) as f:
        old = json.load(f)
    ckpt.save_full(tr.model, tr.optimizer, 6, meta={"epoch": 2})
    os.replace(ckpt._meta_path("last"), ckpt._meta_path("last") + ".staging")
    with open(ckpt._meta_path("last"), "w") as f:
        json.dump(old, f)
    step, meta = ckpt.restore_full(_trainer().model, _trainer().optimizer)
    assert (step, meta["epoch"]) == (6, 2)
    assert ckpt.read_meta("last")["epoch"] == 2
    with open(ckpt._meta_path("last"), "w") as f:
        json.dump(old, f)
    _, meta = ckpt.restore_full(tr.model, tr.optimizer)
    assert meta["epoch"] == 1 and "does not match" in capsys.readouterr().out


def test_checkpoint_guards(tmp_path):
    """A weights-only save clears a stale sidecar; exact resume needs a
    checkpoint and the same EMA setting on both sides."""
    ckpt = CheckpointManager(str(tmp_path))
    tr = _trainer(ema_decay=0.9)
    ckpt.save_full(tr.model, tr.optimizer, 0, "last", ema=tr.ema)
    plain = _trainer()
    with pytest.raises(ValueError, match="ema_decay"):
        ckpt.restore_full(plain.model, plain.optimizer, "last")
    ckpt.save(tr.model, tr.optimizer, "last")
    assert not ckpt.has_full("last") and ckpt.read_meta("last") is None
    with pytest.raises(ValueError, match="requires a checkpoint"):
        plain.fit(_Batches(*_data()), exact_resume=True, verbose=0)


def test_ema_best_restores_either_way(tmp_path):
    """A shadow beside best.pt fills an EMA trainer's shadow; a best.pt
    without one seeds it from the weights; a plain save removes a stale
    shadow file."""
    ckpt = CheckpointManager(str(tmp_path))
    src = _trainer(ema_decay=0.9)
    with torch.no_grad():
        for e in src.ema:
            e.add_(1.0)
    ckpt.save(src.model, src.optimizer, "best", ema=src.ema)
    dst = _trainer(ema_decay=0.9)
    shadow = ckpt.restore(dst.model, None, "best", ema=dst.ema)
    assert shadow is not None
    assert all(torch.equal(a, b) for a, b in zip(src.ema, dst.ema))
    ckpt.save(src.model, None, "best")
    assert not os.path.exists(tmp_path / "best_ema.pt")
    assert ckpt.restore(dst.model, None, "best", ema=dst.ema) is None
    assert all(torch.equal(e, p) for e, p in zip(dst.ema,
                                                 dst.model.parameters()))


class _Killed(Exception):
    """Stands for the process dying inside a save."""


@pytest.mark.parametrize("cut", ["before_shadow_rename",
                                 "before_shadow_removal"])
def test_a_cut_save_never_pairs_weights_with_a_stale_shadow(
        tmp_path, monkeypatch, cut):
    """A save killed after best.pt's rename leaves the previous save's
    shadow beside the new weights: before the new shadow's rename, or
    (a save without a shadow) before the stale one's removal.
    ``restore``, ``read_shadow`` and ``_restore_model`` (the test, serve
    and predict verbs' loader) ignore it and keep best.pt's own
    weights."""
    cfg = _cfg(tmp_path, "G", 1)

    def trainer():
        return Trainer(drivers._build_model(cfg), learning_rate=1e-2,
                       device="cpu", ema_decay=0.9)
    ckpt = CheckpointManager(str(tmp_path))
    src = trainer()
    with torch.no_grad():
        for e in src.ema:
            e.add_(1.0)
    ckpt.save(src.model, src.optimizer, "best", ema=src.ema)
    assert ckpt.read_shadow("best") is not None
    with torch.no_grad():
        for p, e in zip(src.model.parameters(), src.ema):
            p.add_(0.5)
            e.add_(0.25)
    if cut == "before_shadow_rename":
        real = ckpt_module._save

        def dying(obj, path):
            if path.endswith("_ema.pt"):
                raise _Killed
            return real(obj, path)
        monkeypatch.setattr(ckpt_module, "_save", dying)
        ema = src.ema
    else:
        def dying(path):
            raise _Killed
        monkeypatch.setattr(ckpt_module.os, "remove", dying)
        ema = None
    with pytest.raises(_Killed):
        ckpt.save(src.model, None, "best", ema=ema)
    monkeypatch.undo()
    assert os.path.exists(tmp_path / "best_ema.pt")  # the stale shadow
    assert ckpt.read_shadow("best") is None
    dst = trainer()
    assert ckpt.restore(dst.model, None, "best", ema=dst.ema) is None
    assert _same_weights(dst.model, src.model)
    assert all(torch.equal(e, p) for e, p in zip(dst.ema,
                                                 dst.model.parameters()))
    served = drivers._restore_model(cfg, str(tmp_path), "testing", "cpu")
    assert _same_weights(served, src.model)


# ------------------------------------------------------- the train verb

def _write_folder(root, n=4):
    x, y = synthetic.synthetic_images(n, 32, seed=0)
    synthetic.write_image_folder(str(root), x, y)


def _cfg(tmp_path, save, epochs, **kw):
    base = dict(train_dir=str(tmp_path / "Train"), imlength=32, imwidth=32,
                model_width=4, model_depth=2, decoder_name="UNet",
                batch_size=2, num_epochs=epochs, learning_rate=1e-2,
                loss_function="BCEDiceLoss", metric_list=(),
                monitor_param="loss", save_dir=str(tmp_path / save),
                save_history=False, load_weights=False,
                independent_val_set=False, validation_portion=0.0,
                exact_resume=True, augment_device=True, cache_data=True)
    base.update(kw)
    return TrainConfig(**base)


def test_train_verb_resumes_with_device_augment_and_cache(tmp_path,
                                                          monkeypatch):
    """The verb with ``augment_device`` and ``cache_data``: 2 epochs then
    4 (resumed at epoch 2), and 4 with a SIGTERM in epoch 2 then the same
    INI again, both equal a straight 4-epoch run bit for bit: the augment
    stream is keyed by (seed, epoch, step) from the loader's counter."""
    _write_folder(tmp_path / "Train")
    straight = drivers.train(config=_cfg(tmp_path, "A", 4), device="cpu",
                             verbose=0)[1]
    drivers.train(config=_cfg(tmp_path, "B", 2), device="cpu", verbose=0)
    resumed = drivers.train(config=_cfg(tmp_path, "B", 4), device="cpu",
                            verbose=0)[1]
    assert _trajectory(resumed) == _trajectory(straight)
    with open(tmp_path / "B" / "Fold_1" / "last.meta.json") as f:
        assert json.load(f)["epoch"] == 4

    real = drivers.PrefetchLoader.__call__
    calls = {"n": 0}

    def preempting(self):
        calls["n"] += 1
        for i, batch in enumerate(real(self)):
            if calls["n"] == 3 and i == 1:  # epoch 2, its second batch
                signal.raise_signal(signal.SIGTERM)
            yield batch

    monkeypatch.setattr(drivers.PrefetchLoader, "__call__", preempting)
    drivers.train(config=_cfg(tmp_path, "C", 4), device="cpu", verbose=0)
    monkeypatch.undo()
    with open(tmp_path / "C" / "Fold_1" / "last.meta.json") as f:
        assert json.load(f)["epoch"] == 2
    again = drivers.train(config=_cfg(tmp_path, "C", 4), device="cpu",
                          verbose=0)[1]
    assert _trajectory(again) == _trajectory(straight)
    ours = torch.load(tmp_path / "C" / "Fold_1" / "last.pt",
                      weights_only=True)["model"]
    theirs = torch.load(tmp_path / "A" / "Fold_1" / "last.pt",
                        weights_only=True)["model"]
    assert all(torch.equal(ours[k], theirs[k]) for k in theirs)


def test_verbs_load_the_ema_shadow(tmp_path):
    """A fold trained with ``ema_decay`` has ``best_ema.pt``;
    ``_restore_model`` (the test, serve and predict verbs' loader) gives
    the shadow's weights, and the verb's guards raise before anything is
    written."""
    _write_folder(tmp_path / "Train")
    cfg = _cfg(tmp_path, "E", 2, ema_decay=0.9, augment_device=False,
               exact_resume=False)
    drivers.train(config=cfg, device="cpu", verbose=0)
    fold = tmp_path / "E" / "Fold_1"
    shadow = torch.load(fold / "best_ema.pt", weights_only=True)["ema"]
    model = drivers._restore_model(cfg, str(fold), "testing", "cpu")
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), shadow[name])
    for bad in (dict(augment=True), dict(patchify=True),
                dict(accumulation_steps=3), dict(remat="bogus"),
                dict(ema_decay=1.0)):
        cfg = _cfg(tmp_path, "F", 1, **bad)
        with pytest.raises(ValueError):
            drivers.train(config=cfg, device="cpu", verbose=0)
        assert not os.path.exists(cfg.save_dir)
