"""The port's ``test`` verb on the CPU (``--device cpu``) against the JAX
package's on the same weights and PNGs: a W4/D2 UNet at 32x32, binary
and with ``class_number = 2`` (ordinal masks), its weights the JAX verb's
own (``Trainer.init_state`` on zeros, as its ``test`` builds them when no
checkpoint exists) converted into the port's ``Fold_1/best.pt``; and
folds both packages' ``train`` verbs wrote (UNet3+ with ``a_g`` and
``lstm``, MultiResUNet with ``alpha = 1.67``), evaluated with the JAX
fold's trained weights.  The confusion matrices agree but for pixels whose
probability lies within 1e-5 of the threshold, which are counted; the port
writes the masks, the CSVs and the figures; patchify with views runs;
settings it does not build raise before anything is written."""
import configparser
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu import drivers as jdrivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu.train import (  # noqa: E402
    Trainer as JaxTrainer)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import drivers, serve  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import (  # noqa: E402
    main as cli_main)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    SegmentationFolderDataset, synthetic)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TestConfig as EvalConfig, TrainConfig, load_train_config,
    save_train_config)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    flax_to_state_dict)

SIZE = 32
NEAR = 1e-5


def _write_multiclass(root, n=3):
    """Ordinal masks: class 1 a square, class 2 a square inside it
    (tests/test_drivers.py::_write_multiclass_dataset)."""
    rng = np.random.default_rng(0)
    for sub in ("images", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        img = rng.uniform(0, 255, (SIZE, SIZE, 3)).astype(np.uint8)
        msk = np.zeros((SIZE, SIZE), np.uint8)
        msk[4:24, 4:24] = 1
        msk[10:16, 10:16] = 2
        Image.fromarray(img).save(os.path.join(root, "images", f"{i}.png"))
        Image.fromarray(msk).save(os.path.join(root, "masks", f"{i}.png"))


def _write_ini(path, section, cfg):
    parser = configparser.ConfigParser()
    parser[section] = {k: (",".join(v) if isinstance(v, tuple) else str(v))
                       for k, v in dataclasses.asdict(cfg).items()}
    with open(path, "w") as f:
        parser.write(f)


#: folds trained by both packages' train verbs before they are evaluated:
#: the architecture keys of each
TRAINED = {"unet3p-ag-lstm": dict(decoder_name="UNet3P", a_g=1, lstm=1),
           "multiresunet-alpha1.67": dict(decoder_name="MultiResUNet",
                                          alpha=1.67)}


def _setup(tmp, classes, trained=None):
    """Test data, and two result directories with one Train_Configs.ini:
    ``port`` holds ``Fold_1/best.pt`` converted from the JAX verb's
    initial state, ``jax`` holds no checkpoint.  With ``trained`` (a key
    of TRAINED) both packages' train verbs first train a fold of that
    architecture, one epoch on the test data, into ``port`` and ``jax``,
    and ``port``'s ``best.pt`` becomes the JAX fold's trained weights.
    Returns the TEST configs (port, JAX) and the Train config."""
    data = os.path.join(tmp, "Data")
    if classes == 1:
        x, y = synthetic.synthetic_images(5, SIZE, seed=0)
        synthetic.write_image_folder(data, x, y)
    else:
        _write_multiclass(data)
    tcfg = TrainConfig(imlength=SIZE, imwidth=SIZE, decoder_name="UNet",
                       model_width=4, model_depth=2, output_nums=classes,
                       class_number=classes)
    if trained is not None:
        tcfg = dataclasses.replace(
            tcfg, train_dir=data, val_dir=data, batch_size=2, num_epochs=1,
            loss_function="BCEDiceLoss", metric_list=("BinaryAccuracy",),
            load_weights=False, seed=3, **TRAINED[trained])
        return _trained_setup(tmp, data, tcfg)
    jax_model = jdrivers._build_model(jconfig.load_train_config(
        _saved(tmp, "jax", tcfg)))
    jt = JaxTrainer(jax_model)
    jt.init_state(np.zeros((1, SIZE, SIZE, 3), np.float32))
    model = drivers._build_model(tcfg)
    _saved(tmp, "port", tcfg)
    fold = os.path.join(tmp, "port", "Fold_1")
    os.makedirs(fold)
    torch.save(flax_to_state_dict(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats},
        model.state_dict()), os.path.join(fold, drivers.BEST_WEIGHTS))
    return _test_configs(tmp, data, classes), tcfg


def _trained_setup(tmp, data, tcfg):
    """The port's train verb into ``port``: the INI it writes keeps the
    architecture, its ``best.pt`` loads into the model the test and serve
    verbs rebuild from that INI, and the server answers with it.  The JAX
    train verb into ``jax``; its trained weights replace ``port``'s."""
    cfgs = {side: dataclasses.replace(tcfg, save_dir=os.path.join(tmp, side))
            for side in ("port", "jax")}
    drivers.train(config=cfgs["port"], device="cpu", verbose=0)
    saved = load_train_config(os.path.join(tmp, "port", "Train_Configs.ini"))
    assert saved == cfgs["port"]
    fold = os.path.join(tmp, "port", "Fold_1")
    best = torch.load(os.path.join(fold, drivers.BEST_WEIGHTS),
                      weights_only=True)
    server = serve.make_server(saved, fold, port=0, device="cpu")
    try:
        served = server.predictor.model.state_dict()
        assert sorted(served) == sorted(best)
        assert all(torch.equal(served[k], best[k]) for k in best)
        probs = server.predictor(np.zeros((1, SIZE, SIZE, 3), np.float32))
        assert probs.shape == (1, SIZE, SIZE, 1)
    finally:
        server.server_close()
    jdrivers.train(config=jconfig.load_train_config(
        _saved(tmp, "jax", cfgs["jax"])))
    _, jt = jdrivers._restore_trainer(
        jconfig.load_train_config(_saved(tmp, "jax", cfgs["jax"])),
        os.path.join(tmp, "jax", "Fold_1"), "testing")
    torch.save(flax_to_state_dict(
        {"params": jt.state.params, "batch_stats": jt.state.batch_stats},
        best), os.path.join(fold, drivers.BEST_WEIGHTS))
    return _test_configs(tmp, data, 1), cfgs["port"]


def _test_configs(tmp, data, classes):
    test = EvalConfig(test_dir=data, imheight=SIZE, imwidth=SIZE,
                      class_number=classes, batch_size=2,
                      normalizing_factor_msk=255.0 if classes == 1 else 1.0,
                      roc_from_scores=classes > 1)
    return {side: dataclasses.replace(test, save_dir=os.path.join(tmp, side))
            for side in ("port", "jax")}


def _saved(tmp, side, tcfg):
    os.makedirs(os.path.join(tmp, side), exist_ok=True)
    path = os.path.join(tmp, side, "Train_Configs.ini")
    save_train_config(tcfg, path)
    return path


def _labels(save_dir, n):
    masks = os.path.join(save_dir, "test_results", "fold_1", "masks")
    return np.stack([np.asarray(Image.open(os.path.join(
        masks, f"pred_{i}.png"))) for i in range(n)])


@pytest.mark.parametrize("classes,trained", [(1, None), (2, None)] + [
    (1, name) for name in TRAINED], ids=["binary", "classes2", *TRAINED])
def test_test_verb_equals_jax(tmp_path, capsys, classes, trained):
    """Both verbs on one folder: the port's restores ``best.pt``, JAX's
    warns and evaluates the same initial weights, or (``trained``) each
    restores its own train verb's fold, the port's holding the JAX fold's
    weights.  The label maps agree wherever every foreground probability
    lies farther than 1e-5 from the threshold, and so do the confusion
    matrices up to those pixels."""
    tests, tcfg = _setup(str(tmp_path), classes, trained)
    capsys.readouterr()
    jini = str(tmp_path / "jax" / "Test_Configs.ini")
    _write_ini(jini, "TEST", tests["jax"])
    want = jdrivers.test(config=jconfig.load_test_config(jini))
    assert want[1]["checkpoint_restored"] is (trained is not None)
    assert ("no 'best' checkpoint" in capsys.readouterr().out) is (
        trained is None)
    if classes == 1:  # through the command line
        ini = str(tmp_path / "port" / "Test_Configs.ini")
        _write_ini(ini, "TEST", tests["port"])
        cli_main(["test", ini, "--device", "cpu"])
        assert "no 'best' checkpoint" not in capsys.readouterr().out
        results = tmp_path / "port" / "test_results" / "fold_1"
        cm = np.loadtxt(results / "results_confusion_matrix.csv",
                        delimiter=",", skiprows=1, usecols=(1, 2))
    else:
        got = drivers.test(config=tests["port"], device="cpu")
        assert got[1]["checkpoint_restored"] is True
        assert np.array_equal(got["cumulative"]["confusion_matrix"],
                              got[1]["confusion_matrix"])
        cm = got[1]["confusion_matrix"]
    jcm = want[1]["confusion_matrix"]
    assert cm.shape == (classes + 1,) * 2 and cm.sum() == jcm.sum()

    ds = SegmentationFolderDataset(tests["port"].test_dir, (SIZE, SIZE),
                                   normalizing_factor_msk=tests[
                                       "port"].normalizing_factor_msk)
    x = np.stack([ds.load_pair(i)[0] for i in range(len(ds))])
    model = drivers._restore_model(tcfg, str(tmp_path / "port" / "Fold_1"),
                                   "evaluating", "cpu")
    probs = Trainer(model, device="cpu").predict(x)["out"][..., :classes]
    near = (np.abs(probs - tests["port"].threshold) < NEAR).any(-1)
    differ = _labels(tests["port"].save_dir, len(ds)) != _labels(
        tests["jax"].save_dir, len(ds))
    assert not bool((differ & ~near).any())
    assert float(np.abs(cm - jcm).sum()) <= 2 * int(differ.sum())
    print(f"{int(near.sum())} pixels within {NEAR} of the threshold, "
          f"{int(differ.sum())} labelled apart")
    assert float(np.std(probs)) > 1e-3  # the maps are not constant


def test_test_verb_writes_its_reports(tmp_path, capsys):
    """Masks, both CSVs and the five figures; without ``best.pt`` the
    verb warns and its report says so; patchify with two views covers
    every pixel once in the confusion matrix."""
    tests = _setup(str(tmp_path), 1)[0]
    cfg = dataclasses.replace(tests["jax"], tta="hflip,vflip")
    rep = drivers.test(config=cfg, device="cpu")
    assert rep[1]["checkpoint_restored"] is False
    assert "WARNING: no 'best' checkpoint" in capsys.readouterr().out
    results = tmp_path / "jax" / "test_results" / "fold_1"
    names = set(os.listdir(results))
    assert {"results_results.csv", "results_confusion_matrix.csv",
            "confusion_matrix.png", "roc.png", "prc.png",
            "prediction_distributions.png", "sample_grid.png",
            "masks"} <= names
    assert sorted(os.listdir(results / "masks")) == [
        f"pred_{i}.png" for i in range(5)]
    with open(results / "results_results.csv") as f:
        assert f.readline().startswith(",Accuracy,Precision")

    patched = dataclasses.replace(tests["port"], patchify=True,
                                  patch_width=16, patch_height=16,
                                  overlap_ratio=0.5, tta="rot90")
    rep = drivers.test(config=patched, device="cpu")
    assert rep[1]["checkpoint_restored"] is True
    assert int(rep[1]["confusion_matrix"].sum()) == 5 * SIZE * SIZE


@pytest.mark.parametrize("key,value", [("decoder_name", "UNet4PV2"),
                                       ("decoder_name", "AHNet"),
                                       ("decoder_name", "UNet4P")])
def test_unported_settings_raise_before_anything_is_written(tmp_path, key,
                                                            value):
    """These decoders are ported (tests/test_torch_dense_input_2d.py runs
    the verb on them); at depth 7 their encoders pool by 128, which the
    port lacks, and the verb raises before it writes anything."""
    cfg = EvalConfig(test_dir=str(tmp_path), imheight=SIZE, imwidth=SIZE,
                     save_dir=str(tmp_path / "R"))
    tcfg = TrainConfig(imlength=SIZE, imwidth=SIZE, model_width=4,
                       model_depth=7, save_dir=cfg.save_dir, **{key: value})
    with pytest.raises(NotImplementedError, match="pools by 128"):
        drivers.test(config=cfg, train_config=tcfg, device="cpu")
    assert not os.path.exists(cfg.save_dir)


def test_test_verb_runs_on_cuda_by_default(tmp_path, monkeypatch):
    """No ``device``: the GPU, and on a host without one an error before
    anything is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = EvalConfig(test_dir=str(tmp_path), save_dir=str(tmp_path / "R"))
    with pytest.raises(RuntimeError, match="CUDA"):
        drivers.test(config=cfg)
    assert not os.path.exists(cfg.save_dir)
