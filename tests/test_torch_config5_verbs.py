"""BASELINE config 5 through the port's verbs on the CPU, against the JAX
package's verbs on the same weights:

- 1D: ``train1d`` on a small BCDUNet (``lstm = 1``) and NABNet (``d_s =
  1``, ds_type UNetPP) writes the JAX verb's artifacts and history keys;
  ``test1d`` and ``predict1d`` through the command line on the weights of
  the fold JAX's ``train_1d`` trained (converted into ``best.pt``) give
  JAX's metrics (the same keys) and arrays within 1e-4;
- 2D: ``train`` on a UNet over EfficientNetB0 (W4/D3 at 32x32,
  ``encoder_weights = none``, ``encoder_trainable = 0``) through the
  command line writes ``best.pt``, which ``serve`` restores; ``test`` and
  ``predict`` on the JAX verb's initial weights (converted) label every
  pixel as JAX's verbs do, but those within 1e-5 of the threshold;
- what stays unported raises before anything is written: ``encoder_
  weights = imagenet`` (the message says to set ``none``), another
  backbone, another tap projector."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from test_torch_test_verb import _labels, _write_ini  # noqa: E402
from test_torch_verbs_1d import _cfg as _signal_cfg, _data  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu import (  # noqa: E402
    drivers as jdrivers, drivers_1d as jdrivers_1d)
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    Trainer as JaxTrainer)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import (  # noqa: E402
    drivers, drivers_1d, serve)
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import main  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    SegmentationFolderDataset, synthetic)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TestConfig as EvalConfig, TrainConfig, load_signal_config,
    load_train_config, save_train_config)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

SIZE = 32
NEAR = 1e-5


@pytest.mark.parametrize("over", [
    dict(model_name="BCDUNet", lstm=1, dense_loop=2, d_s=0),
    dict(model_name="NABNet", dense_loop=2, d_s=1, ds_type="UNetPP")],
    ids=["BCDUNet-lstm", "NABNet-ds"])
def test_signal_verbs_on_a_special_equal_jax(tmp_path, capsys, over):
    tmp = str(tmp_path)
    _data(tmp)
    cfg = _signal_cfg(tmp, num_epochs=1, **over)
    jcfg = jconfig.Signal1DConfig(**dict(
        dataclasses.asdict(cfg), save_dir=os.path.join(tmp, "jax")))
    hist = drivers_1d.train_1d(config=cfg, device="cpu", verbose=0)
    jhist = jdrivers_1d.train_1d(config=jcfg)
    assert sorted(hist) == sorted(jhist) and np.isfinite(hist["loss"]).all()
    for name in ("Signal_Configs.ini", "best.pt", "history.json"):
        assert os.path.exists(os.path.join(cfg.save_dir, name)), name
    ini = os.path.join(cfg.save_dir, "Signal_Configs.ini")
    assert load_signal_config(ini) == cfg

    _, jtrainer, restored = jdrivers_1d._restore_trainer_1d(jcfg, "x")
    assert restored
    model, _ = drivers_1d._restore_model_1d(cfg, "x", "cpu")
    torch.save(flax_to_state_dict(
        {"params": jtrainer.state.params,
         "batch_stats": jtrainer.state.batch_stats}, model.state_dict()),
        os.path.join(cfg.save_dir, "best.pt"))
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
    assert len(got.files) == (3 if cfg.d_s else 1)
    for key in want.files:
        assert got[key].shape == want[key].shape
        assert float(np.abs(got[key] - want[key]).max()) <= 1e-4, key
    assert "wrote 6 predictions" in capsys.readouterr().out


def _effnet_cfg(tmp, **over):
    kw = dict(train_dir=os.path.join(tmp, "Data"),
              val_dir=os.path.join(tmp, "Data"), imlength=SIZE,
              imwidth=SIZE, decoder_name="UNet", model_width=4,
              model_depth=3, encoder_mode="pretrained_encoder",
              encoder_name="EfficientNetB0", encoder_weights="none",
              encoder_trainable=False, batch_size=2, num_epochs=1,
              learning_rate=1e-3, loss_function="BCEDiceLoss",
              metric_list=("BinaryAccuracy",),
              save_dir=os.path.join(tmp, "port"), load_weights=False, seed=3)
    kw.update(over)
    return TrainConfig(**kw)


def test_efficientnet_unet_through_the_2d_verbs(tmp_path, capsys):
    tmp = str(tmp_path)
    x, y = synthetic.synthetic_images(4, SIZE, seed=0)
    synthetic.write_image_folder(os.path.join(tmp, "Data"), x, y)
    cfg = _effnet_cfg(tmp)
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
        assert model.EfficientNetBackbone_0.training is False
        probs = server.predictor(np.zeros((1, SIZE, SIZE, 3), np.float32))
        assert probs.shape == (1, SIZE, SIZE, 1)
    finally:
        server.server_close()

    # the JAX verbs' initial weights, converted into the port's fold
    jcfg = jconfig.load_train_config(ini)
    jcfg = dataclasses.replace(jcfg, save_dir=os.path.join(tmp, "jax"))
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
                      normalizing_factor_msk=255.0)
    tests = {side: dataclasses.replace(test, save_dir=os.path.join(tmp, side))
             for side in ("port", "jax")}
    jini = os.path.join(tmp, "jax", "Test_Configs.ini")
    _write_ini(jini, "TEST", tests["jax"])
    want = jdrivers.test(config=jconfig.load_test_config(jini))
    assert "no 'best' checkpoint" in capsys.readouterr().out
    got = drivers.test(config=tests["port"], device="cpu")
    assert got[1]["checkpoint_restored"] is True
    cm, jcm = got[1]["confusion_matrix"], want[1]["confusion_matrix"]
    assert cm.sum() == jcm.sum() == 4 * SIZE * SIZE

    ds = SegmentationFolderDataset(test.test_dir, (SIZE, SIZE),
                                   normalizing_factor_msk=255.0)
    xs = np.stack([ds.load_pair(i)[0] for i in range(len(ds))])
    model = drivers._restore_model(cfg, fold, "evaluating", "cpu")
    probs = Trainer(model, device="cpu").predict(xs)["out"][..., 0]
    assert float(np.std(probs)) > 1e-3  # the maps are not constant
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


#: (settings, the refusal's words, the case's id); the EfficientNetV2B0
#: and ResNet50 encoders and the MultiRes tap projector are ported (the
#: verbs run them below), and with ImageNet or .h5 weights they still raise
UNPORTED = [
    (dict(encoder_weights="imagenet"), "set encoder_weights = none",
     "over0-set encoder_weights = none"),
    (dict(encoder_weights="/some/weights.h5"), "encoder_weights",
     "over1-encoder_weights"),
    (dict(encoder_name="EfficientNetV2B0", encoder_weights="imagenet"),
     "encoder_weights", "over2-EfficientNetV2B0"),
    (dict(encoder_name="ResNet50", encoder_weights="imagenet"),
     "encoder_weights", "over3-ResNet50"),
    (dict(decoder_name="MultiResUNet", encoder_weights="/some/x.h5"),
     "encoder_weights", "over4-tap projector"),
]


@pytest.mark.parametrize("over,match", [c[:2] for c in UNPORTED],
                         ids=[c[2] for c in UNPORTED])
def test_unported_pretrained_settings_write_nothing(tmp_path, over, match):
    tmp = str(tmp_path)
    cfg = _effnet_cfg(tmp, **over)
    with pytest.raises(NotImplementedError, match=match):
        drivers.train(config=cfg, device="cpu")
    assert not os.path.exists(cfg.save_dir)
    if "encoder_weights" in over:
        return  # evaluating a fold loads no encoder weights
    x, y = synthetic.synthetic_images(1, SIZE, seed=0)
    synthetic.write_image_folder(os.path.join(tmp, "Data"), x, y)
    with pytest.raises(NotImplementedError, match=match):
        drivers.predict(cfg, input_path=os.path.join(tmp, "Data", "images"),
                        out_dir=os.path.join(tmp, "masks"), device="cpu")
    with pytest.raises(NotImplementedError, match=match):
        drivers.test(config=EvalConfig(test_dir=tmp, save_dir=cfg.save_dir),
                     train_config=cfg, device="cpu")
    assert not os.path.exists(os.path.join(tmp, "masks"))
    assert not os.path.exists(cfg.save_dir)


@pytest.mark.parametrize("over", [dict(encoder_name="EfficientNetV2B0"),
                                  dict(encoder_name="ResNet50"),
                                  dict(decoder_name="MultiResUNet"),
                                  dict(decoder_name="AHNet",
                                       encoder_name="MobileNetV3Small")],
                         ids=["EfficientNetV2B0", "ResNet50",
                              "MultiResUNet_B0", "AHNet_MobileNetV3Small"])
def test_new_encoders_and_projectors_through_the_2d_verbs(tmp_path, over):
    """What the refusals above held before: ``train`` writes best.pt,
    ``test`` restores it and counts every pixel, ``predict`` writes a
    mask an image, on the CPU, with the encoder frozen."""
    tmp = str(tmp_path)
    x, y = synthetic.synthetic_images(3, SIZE, seed=0)
    synthetic.write_image_folder(os.path.join(tmp, "Data"), x, y)
    cfg = _effnet_cfg(tmp, **over)
    drivers.train(config=cfg, device="cpu")
    assert os.path.isfile(os.path.join(cfg.save_dir, "Fold_1",
                                       drivers.BEST_WEIGHTS))
    rep = drivers.test(config=EvalConfig(
        test_dir=os.path.join(tmp, "Data"), imheight=SIZE, imwidth=SIZE,
        batch_size=2, save_dir=cfg.save_dir), train_config=cfg,
        device="cpu")[1]
    assert rep["checkpoint_restored"] is True
    assert int(rep["confusion_matrix"].sum()) == 3 * SIZE * SIZE
    masks = drivers.predict(cfg, input_path=os.path.join(tmp, "Data",
                                                         "images"),
                            out_dir=os.path.join(tmp, "masks"), batch=2,
                            device="cpu")
    assert len(masks) == 3
