"""The port's ``train`` verb with deep supervision (``d_s = 1``) on the CPU
(``--device cpu``): UNet3+ W4/D3 on a tiny synthetic 32x32 PNG folder.
Each train and validation batch gets its targets from one call of the
target pyramid (one kernel launch on the card); the verb writes
``best.pt``, which ``serve`` loads and answers with from ``out``."""
import io
import os
import threading
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tf_1d_2d_segmentation_end2endpipelines_torch import drivers, serve  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import (  # noqa: E402
    main as cli_main)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    pyramid as ds_pyramid, synthetic)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TrainConfig, load_train_config, save_train_config)

SIZE = 32


def _cfg(tmp, **kw):
    base = dict(train_dir=os.path.join(tmp, "Data", "Train"),
                val_dir=os.path.join(tmp, "Data", "Val"), imlength=SIZE,
                imwidth=SIZE, decoder_name="UNet3P", model_width=4,
                model_depth=3, dense_loop=1, batch_size=2, num_epochs=2,
                learning_rate=1e-3, loss_function="BCEDiceLoss",
                metric_list=("BinaryAccuracy",), d_s=1, ds_type="UNet",
                save_dir=os.path.join(tmp, "Results"), load_weights=False,
                seed=3)
    base.update(kw)
    return TrainConfig(**base)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One run of the verb through the command line, on the CPU, counting
    the target pyramids it builds."""
    tmp = str(tmp_path_factory.mktemp("train_ds_verb"))
    for name, n, seed in (("Train", 6, 0), ("Val", 2, 1)):
        synthetic.write_image_folder(os.path.join(tmp, "Data", name),
                                     *synthetic.synthetic_images(n, SIZE,
                                                                 seed=seed))
    cfg = _cfg(tmp)
    ini = os.path.join(tmp, "Train_Configs.ini")
    save_train_config(cfg, ini)
    calls = []
    plain = ds_pyramid.fused_maxpool_pyramid

    def spy(mask, levels):
        calls.append((tuple(mask.shape), levels))
        return plain(mask, levels)

    mp = pytest.MonkeyPatch()
    mp.setattr(ds_pyramid, "fused_maxpool_pyramid", spy)
    try:
        cli_main(["train", ini, "--device", "cpu"])
    finally:
        mp.undo()
    return tmp, cfg, calls


def test_ds_train_verb_builds_one_target_pyramid_per_batch(trained):
    """3 train batches and 1 validation batch per epoch, 2 epochs: 8
    pyramids of depth 3, each from a (2, 32, 32, 1) mask; finite losses
    that include the deep-supervision heads."""
    import json

    _, cfg, calls = trained
    assert calls == [((2, SIZE, SIZE, 1), 3)] * 8
    with open(os.path.join(cfg.save_dir, "Fold_1", "history.json")) as f:
        hist = json.load(f)
    assert all(np.isfinite(hist["loss"] + hist["val_loss"]))


def test_ds_best_weights_are_served_from_out(trained):
    from PIL import Image

    _, cfg, _ = trained
    fold = os.path.join(cfg.save_dir, "Fold_1")
    saved = load_train_config(os.path.join(cfg.save_dir, "Train_Configs.ini"))
    assert (saved.d_s, saved.ds_type, saved.decoder_name) == (1, "UNet",
                                                              "UNet3P")
    server = serve.make_server(saved, fold, port=0, max_batch=1,
                               device="cpu")
    best = torch.load(os.path.join(fold, drivers.BEST_WEIGHTS),
                      weights_only=True)
    assert any(".level1." in k for k in best)  # the heads were trained
    served = server.predictor.model.state_dict()
    assert sorted(served) == sorted(best)
    assert all(torch.equal(served[k], best[k]) for k in best)
    assert server.predictor.output_shape == (SIZE, SIZE, 1)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        buf = io.BytesIO()
        Image.fromarray(np.zeros((SIZE, SIZE, 3), np.uint8)).save(buf, "PNG")
        resp = urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/predict",
            data=buf.getvalue(), method="POST"), timeout=60)
        assert resp.status == 200
        assert np.asarray(Image.open(io.BytesIO(resp.read()))).shape == (
            SIZE, SIZE)
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)
    assert not t.is_alive()


def test_unknown_ds_type_raises_before_anything_is_written(tmp_path):
    cfg = _cfg(str(tmp_path), ds_type="UNet3P")
    with pytest.raises(ValueError, match="ds_type"):
        drivers.train(config=cfg, device="cpu")
    assert not os.path.exists(cfg.save_dir)
