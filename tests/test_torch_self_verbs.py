"""The Self-ONN family's overflow and verbs in the port against the JAX
package, on the CPU (moved from test_torch_self_models.py, whose docstring
gives the bars, to keep each file short on one test worker):

- the reference's overflow: the 1D Self archs at W8/D3 on config 1's
  signals times 1, 0.3, 0.1 and 0.03 with JAX's own initial weights: the
  port's output is non-finite exactly where JAX's is, and where finite
  within 1e-4 of the largest finite magnitude;
- the verbs: ``train`` through the command line on SelfUNetPP and SelfFPN,
  ``serve``, ``test`` and ``predict`` against the JAX verbs; ``train1d``,
  ``test1d`` and ``predict1d`` on SelfUNetPP."""
import dataclasses
import json
import os
import numpy as np
import pytest
torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402
import chip_smoke  # noqa: E402
from test_torch_config2_models import assert_model_matches_jax  # noqa: E402
from test_torch_recurrent_1d import assert_1d_model_matches_jax  # noqa: E402
from test_torch_test_verb import _labels, _write_ini  # noqa: E402
from test_torch_verbs_1d import _cfg as _signal_cfg  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu import (  # noqa: E402
    drivers as jdrivers, drivers_1d as jdrivers_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models.api_1d import (  # noqa: E402
    model_selector_1d as jax_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    Trainer as JaxTrainer)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import (  # noqa: E402
    drivers, drivers_1d, serve)
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import main  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    SegmentationFolderDataset, save_pt, synthetic, synthetic_signals)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel, model_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TestConfig as EvalConfig, TrainConfig, load_signal_config,
    load_train_config, save_train_config)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)
from test_torch_self_models import NEAR, SIZE  # noqa: E402


def test_self_1d_archs_overflow_where_jax_does():
    """The 1D Self archs have no BatchNorm or tanh after their Opers, and
    each Oper stacks x, x**2, x**3: on config 1's signals (amplitude up to
    ~4.4) JAX's forward overflows, and the port's does at the same
    elements; where JAX's output is finite the port's is within 1e-4 of
    its largest magnitude (up to ~1e20)."""
    x, _ = synthetic_signals(2, 256, seed=0)
    seen_nan = False
    for arch in ("SelfR2UNetPP", "SelfUNetPP", "SelfUNet3P"):
        jm = jax_selector_1d(arch, 256, 3, 1, 8, 3)
        tm = model_selector_1d(arch, 256, 3, 1, 8, 3)
        variables = jax.tree.map(np.asarray, jax.jit(jm.init)(
            jax.random.PRNGKey(0), jnp.asarray(x)))
        tm.load_state_dict(flax_to_state_dict(variables, tm.state_dict()))
        fwd = jax.jit(lambda v, a: jm.apply(
            v, a, train=True, mutable=["batch_stats"])[0]["out"])
        for s in (1.0, 0.3, 0.1, 0.03):
            xs = x * np.float32(s)
            want = np.asarray(fwd(variables, jnp.asarray(xs)))
            with torch.no_grad():
                got = tm.train()(torch.from_numpy(xs))["out"].numpy()
            finite = np.isfinite(want)
            np.testing.assert_array_equal(np.isfinite(got), finite)
            seen_nan |= not finite.all()
            if finite.any():
                big = max(float(np.abs(want[finite]).max()), 1.0)
                assert float(np.abs(got[finite] - want[finite]).max()) \
                    <= 1e-4 * big, (arch, s)
    assert seen_nan


def _folder(tmp, n=4):
    x, y = synthetic.synthetic_images(n, SIZE, seed=0)
    synthetic.write_image_folder(os.path.join(tmp, "Data"), x, y)


#: (decoder, genre, the images' normalizing factor): JAX's initial
#: SelfUNetPP weights (W4/D2) overflow on most pixels of [0, 1] images
#: (its encoder and latent cube their inputs seven times without
#: normalization), and on none of [0, 0.25]
VERB_CASES = [("SelfUNetPP", "UNet", 4 * 255.0), ("SelfFPN", "FPN", 255.0)]


@pytest.mark.parametrize("name,genre,factor", VERB_CASES,
                         ids=[c[0] for c in VERB_CASES])
def test_2d_verbs_equal_jax(tmp_path, capsys, name, genre, factor):
    tmp = str(tmp_path)
    _folder(tmp)
    cfg = TrainConfig(normalizing_factor_img=factor,
        train_dir=os.path.join(tmp, "Data"), val_dir=os.path.join(tmp, "Data"),
        imlength=SIZE, imwidth=SIZE, model_genre=genre, decoder_name=name,
        model_width=4, model_depth=2, batch_size=2, num_epochs=1,
        learning_rate=1e-3, loss_function="BCEDiceLoss",
        metric_list=("BinaryAccuracy",), save_dir=os.path.join(tmp, "port"),
        load_weights=False, seed=3)
    ini = os.path.join(tmp, "Train_Configs.ini")
    save_train_config(cfg, ini)
    main(["train", ini, "--device", "cpu"])
    saved = load_train_config(os.path.join(cfg.save_dir, "Train_Configs.ini"))
    assert saved == cfg
    fold = os.path.join(cfg.save_dir, "Fold_1")
    best = torch.load(os.path.join(fold, drivers.BEST_WEIGHTS),
                      weights_only=True)
    server = serve.make_server(saved, fold, port=0, device="cpu")
    try:
        model = server.predictor.model
        assert all(torch.equal(model.state_dict()[k], best[k]) for k in best)
        probs = server.predictor(np.zeros((1, SIZE, SIZE, 3), np.float32))
        assert probs.shape == (1, SIZE, SIZE, 1)
        assert bool(np.isfinite(probs).all())
    finally:
        server.server_close()

    # the JAX verbs' initial weights, converted into the port's fold
    jcfg = dataclasses.replace(jconfig.load_train_config(ini),
                               save_dir=os.path.join(tmp, "jax"))
    os.makedirs(jcfg.save_dir)
    save_train_config(dataclasses.replace(cfg, save_dir=jcfg.save_dir),
                      os.path.join(jcfg.save_dir, "Train_Configs.ini"))
    jt = JaxTrainer(jdrivers._build_model(jcfg))
    jt.init_state(np.zeros((1, SIZE, SIZE, 3), np.float32))
    torch.save(flax_to_state_dict(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats},
        best), os.path.join(fold, drivers.BEST_WEIGHTS))
    capsys.readouterr()

    test = EvalConfig(test_dir=os.path.join(tmp, "Data"), imheight=SIZE,
                      imwidth=SIZE, class_number=1, batch_size=2,
                      normalizing_factor_img=factor,
                      normalizing_factor_msk=255.0)
    tests = {side: dataclasses.replace(test, save_dir=os.path.join(tmp, side))
             for side in ("port", "jax")}
    jini = os.path.join(tmp, "jax", "Test_Configs.ini")
    _write_ini(jini, "TEST", tests["jax"])
    want = jdrivers.test(config=jconfig.load_test_config(jini))
    got = drivers.test(config=tests["port"], device="cpu")
    assert got[1]["checkpoint_restored"] is True
    cm, jcm = got[1]["confusion_matrix"], want[1]["confusion_matrix"]
    assert cm.sum() == jcm.sum() == 4 * SIZE * SIZE

    ds = SegmentationFolderDataset(test.test_dir, (SIZE, SIZE),
                                   normalizing_factor_img=factor,
                                   normalizing_factor_msk=255.0)
    xs = np.stack([ds.load_pair(i)[0] for i in range(len(ds))])
    model = drivers._restore_model(cfg, fold, "evaluating", "cpu")
    probs = Trainer(model, device="cpu").predict(xs)["out"][..., 0]
    assert float(np.std(probs)) > 1e-4  # the maps are not constant
    near = np.abs(probs - 0.5) < NEAR
    differ = _labels(tests["port"].save_dir, 4) != _labels(
        tests["jax"].save_dir, 4)
    assert not bool((differ & ~near).any())
    assert float(np.abs(cm - jcm).sum()) <= 2 * int(differ.sum())

    images = os.path.join(tmp, "Data", "images")
    mine = drivers.predict(cfg, input_path=images,
                           out_dir=os.path.join(tmp, "port_masks"), batch=2,
                           device="cpu")
    theirs = jdrivers.predict(jcfg, input_path=images,
                              out_dir=os.path.join(tmp, "jax_masks"),
                              batch=2)
    a = np.stack([np.asarray(Image.open(p)) for p in mine])
    b = np.stack([np.asarray(Image.open(p)) for p in theirs])
    assert a.shape == b.shape == (4, SIZE, SIZE)
    assert not bool(((a != b) & ~near).any())


def test_signal_verbs_on_self_unet_pp_equal_jax(tmp_path, capsys):
    """``train1d`` on SelfUNetPP (W4/D2, d_s = 1, signals of amplitude
    0.1) writes its artifacts with finite losses; ``test1d`` and
    ``predict1d`` through the command line on JAX's initial weights
    (converted into ``best.pt``) give JAX's verbs' metrics and arrays."""
    tmp = str(tmp_path)
    x, y = synthetic_signals(12, length=64, seed=3)
    x = x * np.float32(0.1)
    save_pt({"samples": x, "labels": y}, os.path.join(tmp, "Train_Set.pt"))
    save_pt({"samples": x[:6], "labels": y[:6]},
            os.path.join(tmp, "Test_Set.pt"))
    cfg = _signal_cfg(tmp, model_name="SelfUNetPP", num_epochs=1,
                      ds_type="UNetPP")
    hist = drivers_1d.train_1d(config=cfg, device="cpu", verbose=0)
    assert np.isfinite(hist["loss"]).all()
    for name in ("Signal_Configs.ini", "best.pt", "history.json"):
        assert os.path.exists(os.path.join(cfg.save_dir, name)), name
    ini = os.path.join(cfg.save_dir, "Signal_Configs.ini")
    assert load_signal_config(ini) == cfg

    # JAX's verbs on a fold without a checkpoint take the seed's initial
    # weights: converted, they are the port's best.pt
    jcfg = jconfig.Signal1DConfig(**dict(
        dataclasses.asdict(cfg), save_dir=os.path.join(tmp, "jax")))
    _, jt, restored = jdrivers_1d._restore_trainer_1d(jcfg, "x")
    assert not restored
    model, _ = drivers_1d._restore_model_1d(cfg, "x", "cpu")
    torch.save(flax_to_state_dict(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats},
        model.state_dict()), os.path.join(cfg.save_dir, "best.pt"))
    main(["test1d", ini, "--device", "cpu"])
    want = jdrivers_1d.test_1d(config=jcfg)
    with open(os.path.join(cfg.save_dir, "test_metrics_1d.json")) as f:
        got = json.load(f)
    assert sorted(got) == sorted(want) and got["restored_checkpoint"]
    for key, w in want.items():
        if key != "restored_checkpoint" and w is not None:
            assert abs(got[key] - w) <= 1e-4 + 1e-9, key
    out = str(tmp_path / "port.npz")
    main(["predict1d", ini, "--device", "cpu", "--out", out])
    jout = jdrivers_1d.predict_1d(config=jcfg,
                                  out_path=str(tmp_path / "jax.npz"))
    got, want = np.load(out), np.load(jout)
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].shape == want[key].shape
        assert float(np.abs(got[key] - want[key]).max()) <= 1e-4, key
