"""The port's ``predict`` verb on the CPU (``device="cpu"``) against the JAX
package's on the same weights and PNGs: a W4/D2 UNet at 32x32, binary and
with ``class_number = 2``, its weights the JAX verb's own initial state
converted into the port's ``Fold_1/best.pt`` (``tests/
test_torch_test_verb.py::_setup``), without and with every test-time view
and with and without patchify.  The masks agree but for pixels whose
probability lies within 1e-5 of the threshold, which are counted.  Also
the command line, the refusals, ``Predictor(tta=...)`` against
``make_tta_fn`` by hand, and the GPU as the default device."""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from test_torch_test_verb import SIZE, _setup  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu import drivers as jdrivers  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jconfig)
from tf_1d_2d_segmentation_end2endpipelines_torch import drivers, serve  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import (  # noqa: E402
    main as cli_main)
from tf_1d_2d_segmentation_end2endpipelines_torch.data.generators import (  # noqa: E402
    load_image)
from tf_1d_2d_segmentation_end2endpipelines_torch.data.patch import (  # noqa: E402
    create_patches, unpatchify)
from tf_1d_2d_segmentation_end2endpipelines_torch.eval import (  # noqa: E402
    make_tta_fn, parse_tta)
from tf_1d_2d_segmentation_end2endpipelines_torch.train import Trainer  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    save_train_config)

NEAR = 1e-5
PATCH = dict(patchify=True, patch_width=16, patch_height=16,
             overlap_ratio=0.5)


def _configs(tmp, classes, patchify):
    """The Train configs of both sides: ``port`` restores the converted
    ``best.pt``, ``jax`` warns and uses the same initial weights."""
    _, tcfg = _setup(tmp, classes)
    extra = PATCH if patchify else {}
    port = dataclasses.replace(tcfg, save_dir=os.path.join(tmp, "port"),
                               **extra)
    jax_cfg = jconfig.load_train_config(os.path.join(tmp, "jax",
                                                     "Train_Configs.ini"))
    jax_cfg = dataclasses.replace(jax_cfg, save_dir=os.path.join(tmp, "jax"),
                                  **extra)
    return port, jax_cfg


def _masks(paths):
    return np.stack([np.asarray(Image.open(p)) for p in paths])


def _probs(cfg, paths, views):
    """The port model's probabilities for ``paths`` by the verb's route:
    one padded Predictor batch, or each image's patch grid."""
    model = drivers._restore_model(cfg, os.path.join(cfg.save_dir, "Fold_1"),
                                   "predicting with", "cpu")
    x = np.stack([load_image(p, (SIZE, SIZE), "rgb", "lanczos", 255.0)
                  for p in paths])
    if not cfg.patchify:
        return serve.Predictor(model, x.shape[1:], max_batch=len(x),
                               tta=views)(x)
    trainer = Trainer(model, device="cpu")
    return np.stack([unpatchify(trainer.predict(create_patches(
        img, (cfg.patch_width, cfg.patch_height), cfg.overlap_ratio)[0],
        views)["out"], (SIZE, SIZE), cfg.overlap_ratio) for img in x])


@pytest.mark.parametrize("patchify", [False, True], ids=["whole", "patches"])
@pytest.mark.parametrize("tta", ["", "all"], ids=["no-views", "all-views"])
@pytest.mark.parametrize("classes", [1, 2])
def test_predict_verb_equals_jax(tmp_path, capsys, classes, tta, patchify):
    tmp = str(tmp_path)
    port, jax_cfg = _configs(tmp, classes, patchify)
    images = os.path.join(tmp, "Data", "images")
    want = jdrivers.predict(jax_cfg, input_path=images,
                            out_dir=os.path.join(tmp, "jax_masks"), batch=2,
                            tta=tta)
    assert "no 'best' checkpoint" in capsys.readouterr().out
    got = drivers.predict(port, input_path=images,
                          out_dir=os.path.join(tmp, "port_masks"), batch=2,
                          tta=tta, device="cpu")
    out = capsys.readouterr().out
    assert "no 'best' checkpoint" not in out
    assert f"wrote {len(got)} masks" in out
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want] == [
        f"{i}_mask.png" if classes > 1 else f"{i:05d}_mask.png"
        for i in range(len(got))]
    a, b = _masks(got), _masks(want)
    assert a.shape == b.shape == (len(got), SIZE, SIZE)
    srcs = [os.path.join(images, sorted(os.listdir(images))[i])
            for i in range(len(got))]
    probs = _probs(port, srcs, parse_tta(tta))[..., :classes]
    near = (np.abs(probs - 0.5) < NEAR).any(-1)
    differ = a != b
    assert not bool((differ & ~near).any())
    assert float(np.std(probs)) > 1e-3  # the maps are not constant
    assert set(np.unique(a)) <= ({0, 255} if classes == 1 else {0, 127, 254})
    print(f"{int(near.sum())} pixels within {NEAR} of the threshold, "
          f"{int(differ.sum())} labelled apart")


def test_predict_cli(tmp_path, capsys):
    """``predict <ini> --input <file> --device cpu``: one mask, named after
    the input, the size of the model."""
    port, _ = _configs(str(tmp_path), 1, False)
    ini = str(tmp_path / "port.ini")
    save_train_config(port, ini)
    src = sorted((tmp_path / "Data" / "images").iterdir())[0]
    out = tmp_path / "cli_masks"
    cli_main(["predict", ini, "--input", str(src), "--out", str(out),
              "--batch", "3", "--tta", "hflip,rot90", "--device", "cpu"])
    assert os.listdir(out) == [f"{src.stem}_mask.png"]
    assert Image.open(out / f"{src.stem}_mask.png").size == (SIZE, SIZE)
    assert "wrote 1 masks" in capsys.readouterr().out


def test_predict_refusals_write_nothing(tmp_path):
    port, _ = _configs(str(tmp_path), 1, False)
    images = str(tmp_path / "Data" / "images")
    out = str(tmp_path / "never")
    with pytest.raises(ValueError, match="batch"):
        drivers.predict(port, input_path=images, out_dir=out, batch=0,
                        device="cpu")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError, match="no images"):
        drivers.predict(port, input_path=str(empty), out_dir=out,
                        device="cpu")
    # AHNet, UNet4P and the backbones are ported (tests/test_torch_dense_
    # input_2d.py runs the verb on them); a dense-input encoder at depth 7
    # still needs a pool by 128, which the port lacks
    for over in ({"decoder_name": "AHNet", "model_depth": 7},
                 {"decoder_name": "UNet4P", "model_depth": 7},
                 {"decoder_name": "KSSNet", "model_depth": 7}):
        with pytest.raises(NotImplementedError, match="pools by 128"):
            drivers.predict(dataclasses.replace(port, **over),
                            input_path=images, out_dir=out, device="cpu")
    with pytest.raises(ValueError, match="unknown TTA"):
        drivers.predict(port, input_path=images, out_dir=out, tta="spin",
                        device="cpu")
    assert not os.path.exists(out)


def test_predict_verb_runs_on_cuda_by_default(tmp_path, monkeypatch):
    """No ``--device``: the GPU, and on a host without one an error before
    anything is written (never the CPU)."""
    port, _ = _configs(str(tmp_path), 1, False)
    ini = str(tmp_path / "port.ini")
    save_train_config(port, ini)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["predict", ini, "--input", str(tmp_path / "Data"),
                  "--out", str(out)])
    assert not out.exists()


def test_predictor_views_equal_make_tta_fn_by_hand():
    """A padded request through ``Predictor(tta=...)`` equals the model
    wrapped by ``make_tta_fn`` on the same padded batch, and every view
    of a device batch runs in one forward of max_batch x (1 + views)."""
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel

    model = SegModel("UNet", 4, 2, generator=torch.Generator().manual_seed(0))
    model.eval()
    views = parse_tta("all")
    shapes = []
    model.register_forward_pre_hook(
        lambda m, args: shapes.append(tuple(args[0].shape)))
    pred = serve.Predictor(model, (SIZE, SIZE, 3), max_batch=4, tta=views)
    assert pred.output_shape == (SIZE, SIZE, 1)
    assert shapes == [(4 * (1 + len(views)), SIZE, SIZE, 3)]  # the warm-up
    x = np.random.default_rng(0).uniform(size=(3, SIZE, SIZE, 3)).astype(
        np.float32)
    got = pred(x)
    assert shapes[1:] == [(4 * (1 + len(views)), SIZE, SIZE, 3)]
    padded = torch.from_numpy(np.concatenate([x, np.zeros_like(x[:1])]))
    with torch.inference_mode():
        want = make_tta_fn(model, views)(padded)["out"][:3].numpy()
    np.testing.assert_array_equal(got, want)
    with torch.inference_mode():
        plain = model(torch.from_numpy(x))["out"].numpy()
    assert float(np.abs(got - plain).max()) > 0  # the views did something
