"""The Self-ONN family and the FPN genre in the port against the JAX
package, on the CPU, with the same variables (random, from numpy,
converted by utils/flax_to_torch.py):

- 2D (``SegModel``, W4 on 32 x 32 images): SelfUNet, SelfUNetPP,
  SelfUNet3P and SelfFPN (genre FPN), and FPN with ConvBlock nodes, with
  and without deep supervision and transposed convs, q = 1 and 3,
  ``dense_loop``, FPN with ``a_g`` and ``lstm``; on EfficientNetB0
  (D2): FPN's ConvBlock and SelfFPN's Oper projections, SelfUNet's Self
  tap projectors.  Each is held to tests/test_torch_config2_models.py's
  ``assert_model_matches_jax``: every leaf mapped, every head in eval
  mode within 1e-4, one float32 training step (BCEDice on every head)
  against JAX's step in float64: the loss and every gradient within
  1e-4, the new running statistics within 1e-5.  The random kernels are
  scaled by 0.5 (at the default draw the cubes of five unnormalized
  encoder Opers overflow in both packages).
- 1D (``model_selector_1d``, W4 on 32-sample signals): SelfR2UNetPP,
  SelfUNetPP and SelfUNet3P with the options, held to
  tests/test_torch_recurrent_1d.py's ``assert_1d_model_matches_jax``
  (float64 steps within 1e-6, the float32 step within 1e-4 or the
  relative bar), on normal signals times 0.03, the random kernels scaled
  by 0.25 (at 0.5 SelfR2UNetPP's outputs reach a loss of 5, whose
  float32 rounding through the cubes exceeds the loss's absolute 1e-4).
- The reference's overflow: W8/D3 on config 1's signals times 1, 0.3,
  0.1 and 0.03 with JAX's own initial weights (converted), a training
  forward: the port's output is non-finite exactly where JAX's is, and
  where finite within 1e-4 of the largest finite magnitude.  At W32/D3,
  config 1's width, on phase 29's 128 signals, JAX's forward of all
  three archs is finite at ``chip_smoke.SELF_1D_SCALE`` and
  SelfR2UNetPP's not at the scales above it; at W32/D4 JAX's 2D
  SelfUNet overflows on phase 28's images and no Self model does at
  ``chip_smoke.SELF_2D_SCALE`` times them.
- The verbs: ``train`` through the command line on SelfUNetPP and
  SelfFPN (genre FPN) writes ``best.pt``, which ``serve`` restores;
  ``test`` and
  ``predict`` on the JAX verb's initial weights label every pixel as the
  JAX verbs do but within 1e-5 of the threshold; ``train1d`` on
  SelfUNetPP, then ``test1d`` and ``predict1d`` on JAX's initial weights
  against JAX's verbs (metrics and predictions within 1e-4)."""
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

SIZE = 32
NEAR = 1e-5
#: decoder -> its flax module name and the ds_type whose targets fit its
#: heads (the chains' and UNet3+'s level k at SIZE / 2**k, the grid's at
#: SIZE)
DECODERS = {"SelfUNet": ("SelfChainDecoder_0", "UNet"),
            "SelfFPN": ("SelfChainDecoder_0", "UNet"),
            "SelfUNetPP": ("SelfGridDecoder_0", "UNetPP"),
            "SelfUNet3P": ("SelfFullScaleDecoder_0", "UNet"),
            "FPN": ("ChainDecoder_0", "UNet")}
#: (decoder, W, D, options); the FPN decoders run in the FPN genre
CASES = [
    ("SelfUNet", 4, 3, dict()),
    ("SelfUNet", 4, 3, dict(ds=1, is_transconv=False, q=1)),
    ("SelfUNetPP", 4, 3, dict(ds=1)),
    ("SelfUNetPP", 4, 2, dict(is_transconv=False, dense_loop=2)),
    ("SelfUNet3P", 4, 3, dict(ds=1)),
    ("SelfUNet3P", 4, 2, dict(q=1, ag=1, lstm=1)),
    ("SelfFPN", 4, 3, dict(ds=1)),
    ("SelfFPN", 4, 2, dict(q=2)),
    ("FPN", 4, 3, dict(ds=1)),
    ("FPN", 4, 2, dict(ag=1, lstm=1, is_transconv=False)),
    ("FPN", 4, 2, dict(train_mode="pretrained_encoder", ds=1)),
    ("SelfFPN", 4, 2, dict(train_mode="pretrained_encoder")),
    ("SelfUNet", 4, 2, dict(train_mode="pretrained_encoder", ds=1)),
]


def _ids(c):
    return f"{c[0]}-W{c[1]}D{c[2]}-" + "-".join(
        f"{k}{v if isinstance(v, str) else int(v)}".replace(
            "pretrained_encoder", "B0") for k, v in c[3].items())


def _models(name, W, D, **kw):
    kw = dict(kw)
    genre = "FPN" if name.endswith("FPN") else "UNet"
    if kw.get("train_mode") == "pretrained_encoder":
        kw["backbone"] = "EfficientNetB0"
    jm = JaxSegModel(decoder_name=name, model_width=W, model_depth=D,
                     genre=genre, **kw)
    tm = SegModel(name, W, D, in_channels=3, genre=genre, **kw)
    return jm, tm


def _self_heads(module):
    """The deep-supervision heads of a Self decoder: its 1-filter Opers."""
    return lambda params: [o["onn_conv"] for n, o in params[module].items()
                           if n.startswith("Oper_")
                           and o["onn_conv"]["kernel"].shape[-1] == 1]


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_self_and_fpn_models_match_jax(case):
    name, W, D, kw = case
    jm, tm = _models(name, W, D, **kw)
    module, ds_type = DECODERS[name]
    assert_model_matches_jax(
        jm, tm, kw.get("ds", 0), module, ds_type, depth=D,
        step_dtype=jnp.float64, kernel_scale=0.5,
        heads=_self_heads(module) if name.startswith("Self") else None)


def test_flax_names_of_the_self_and_fpn_models():
    """SelfUNet3P's decoder interleaves Opers and BatchNorms as flax
    numbers them (per step: a BatchNorm after each tap Oper); the FPN
    genre builds no latent; on a backbone its projections are
    ``ConvBlock_<k>`` (FPN) or ``Oper_<k>`` (SelfFPN) beside ``out``, the
    Self head an Oper."""
    for name, kw, want in [
            ("SelfUNet3P", dict(ds=1), None),
            ("SelfFPN", {}, None),
            ("FPN", dict(train_mode="pretrained_encoder"),
             ["ConvBlock_0", "ConvBlock_1", "ConvBlock_2"]),
            ("SelfFPN", dict(train_mode="pretrained_encoder"),
             ["Oper_0", "Oper_1", "Oper_2"])]:
        jm, tm = _models(name, 4, 2, **kw)
        params = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, SIZE, SIZE, 3)))["params"]
        assert sorted(n for n, _ in tm.named_children()) == sorted(params)
        module = DECODERS[name][0]
        assert sorted(n for n, _ in getattr(tm, module).named_children()) \
            == sorted(params[module])
        if name.endswith("FPN"):
            assert "LatentLayer_0" not in params
        if want:
            assert [n for n in params
                    if n.startswith(("ConvBlock_", "Oper_"))] == want
        if name.startswith("Self"):
            assert list(params["out"]) == ["onn_conv"]
    dec = dict(_models("SelfUNet3P", 4, 2, ds=1)[1].SelfFullScaleDecoder_0
               .named_children())
    # D2: step 0: tap Oper + BN, pooled tap Oper + BN, prev, node, head;
    # step 1: tap Oper + BN, prev, earlier, node, head
    assert sum(n.startswith("Oper_") for n in dec) == 10
    assert sum(n.startswith("BatchNorm_") for n in dec) == 3


def test_fpn_without_transposed_convs_raises():
    """The FPN chains add the skip to the upsampled output; a resize keeps
    the source's width, and the JAX package fails on the shapes."""
    for name in ("FPN", "SelfFPN"):
        with pytest.raises(ValueError, match="is_transconv"):
            SegModel(name, 4, 2, genre="FPN", is_transconv=False)
        jm = JaxSegModel(decoder_name=name, model_width=4, model_depth=2,
                         genre="FPN", is_transconv=False)
        with pytest.raises(Exception):
            jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                           jnp.zeros((1, SIZE, SIZE, 3)))


#: (arch, W, D, options)
CASES_1D = [
    ("SelfR2UNetPP", 4, 3, dict(ds=1)),
    ("SelfR2UNetPP", 4, 2, dict(is_transconv=False, t=1, q=2)),
    ("SelfUNetPP", 4, 3, dict()),
    ("SelfUNetPP", 4, 2, dict(ds=1, is_transconv=False, kernel=4)),
    ("SelfUNet3P", 4, 3, dict(ds=1)),
    ("SelfUNet3P", 4, 2, dict(q=1, ag=1, lstm=1)),
]


@pytest.mark.parametrize("case", CASES_1D, ids=[_ids(c) for c in CASES_1D])
def test_self_1d_archs_match_jax(case):
    arch, W, D, kw = case
    assert_1d_model_matches_jax(arch, W, D, x_scale=0.03, kernel_scale=0.25,
                                **kw)


def test_self_1d_pools_read_channels_last(monkeypatch):
    """Every pool of the 1D Self archs reads a channels_last signal
    (channel stride 1; the kernel on the card refuses any other), also
    where the first Oper stacks the powers of a one-channel signal, whose
    strides cannot say channels_last, and at q = 1."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (
        pyramid)
    real_pool = pyramid.maxpool1d_pyramid
    seen = []

    def pool(x, levels, wanted=None):
        seen.append(x.stride(1) == 1)
        return real_pool(x, levels, wanted)

    monkeypatch.setattr(pyramid, "maxpool1d_pyramid", pool)
    for arch, q in (("SelfR2UNetPP", 3), ("SelfUNetPP", 1),
                    ("SelfUNet3P", 3)):
        tm = model_selector_1d(arch, 32, 2, 1, 4, 3, q=q)
        x = torch.randn(2, 32, 1) * 0.1
        tm.train()(x)["out"].sum().backward()
    assert len(seen) == 7 and all(seen)


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


def test_chip_scales_are_the_largest_finite_ones():
    """``chip_smoke.SELF_1D_SCALE`` is the largest of 1, 0.3, 0.1, 0.03,
    0.01 and 0.001 at which JAX's float32 training forward of the three
    1D Self archs at W32/D3 (JAX's PRNGKey(0) weights) is finite on
    phase 29's 128 signals (SelfR2UNetPP's is not at any larger one,
    SelfUNetPP's and SelfUNet3P's are from 0.03 down);
    ``chip_smoke.SELF_2D_SCALE`` the largest of 1 and 0.3 at which the
    four 2D Self models' at W32/D4 are on two of phase 28's images (64 x
    64 here: SelfUNet overflows at 1 at this size too)."""
    def fwd(jm, x):
        variables = jax.jit(jm.init)(jax.random.PRNGKey(0), x[:1])
        apply = jax.jit(lambda a: jm.apply(
            variables, a, train=True, mutable=["batch_stats"])[0]["out"])
        return lambda s: bool(jnp.isfinite(apply(x * np.float32(s))).all())

    x, _ = synthetic_signals(chip_smoke.N_SIG_TRAIN + chip_smoke.N_SIG_VAL
                             + chip_smoke.N_SIG_TEST, 1024,
                             seed=chip_smoke.SEED + 21)
    x = jnp.asarray(x[-chip_smoke.N_SIG_TEST:])
    scales = (1.0, 0.3, 0.1, 0.03, 0.01, 0.001)
    assert chip_smoke.SELF_1D_SCALE == scales[-1]
    r2 = fwd(jax_selector_1d("SelfR2UNetPP", 1024, 3, 1, 32, 3), x)
    assert [r2(s) for s in scales] == [False] * 5 + [True]
    for arch in ("SelfUNetPP", "SelfUNet3P"):
        finite = fwd(jax_selector_1d(arch, 1024, 3, 1, 32, 3), x)
        assert [finite(s) for s in scales] == [False] * 3 + [True] * 3
    x, _ = synthetic.synthetic_images(2, 64, seed=chip_smoke.SEED + 8)
    x = jnp.asarray(x)
    assert chip_smoke.SELF_2D_SCALE == 0.3
    for name in ("SelfUNet", "SelfUNetPP", "SelfUNet3P", "SelfFPN"):
        finite = fwd(JaxSegModel(
            decoder_name=name, model_width=32, model_depth=4,
            genre="FPN" if name == "SelfFPN" else "UNet"), x)
        assert finite(0.3)
        if name == "SelfUNet":
            assert not finite(1.0)


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
