"""The port's serving slice as a whole, on the CPU: Predictor against the
JAX Predictor with the same converted weights, an HTTP round trip through
make_server, and the refusals (no CUDA here, int8 not ported)."""
import dataclasses
import io
import json
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_blocks import random_variables  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.eval import (  # noqa: E402
    label_from_pred as jax_label_from_pred)
from tf_1d_2d_segmentation_end2endpipelines_tpu.models import (  # noqa: E402
    SegModel as JaxSegModel)
from tf_1d_2d_segmentation_end2endpipelines_tpu.serve import (  # noqa: E402
    Predictor as JaxPredictor)
from tf_1d_2d_segmentation_end2endpipelines_tpu.utils import (  # noqa: E402
    config as jax_config)
from tf_1d_2d_segmentation_end2endpipelines_torch import serve  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.__main__ import (  # noqa: E402
    main as cli_main)
from tf_1d_2d_segmentation_end2endpipelines_torch.drivers import (  # noqa: E402
    _build_model)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (  # noqa: E402
    TrainConfig, load_train_config)
from tf_1d_2d_segmentation_end2endpipelines_torch.utils.flax_to_torch import (  # noqa: E402
    load_flax_variables)

SIZE = 32


def _cfg(save_dir):
    return TrainConfig(imlength=SIZE, imwidth=SIZE, num_channels=3,
                       decoder_name="UNetPP", model_width=4, model_depth=3,
                       output_nums=1, class_number=1, dense_loop=1,
                       save_dir=str(save_dir))


@pytest.fixture(scope="module")
def weights():
    """The same random weights for both packages: the flax variables, and
    the port's model with them converted."""
    jm = JaxSegModel(decoder_name="UNetPP", model_width=4, model_depth=3,
                     output_nums=1, final_activation="sigmoid")
    variables = random_variables(jm, jnp.zeros((1, SIZE, SIZE, 3)), seed=5)
    tm = _build_model(_cfg("unused"))
    load_flax_variables(tm, variables)
    return jm, variables, tm.eval()


def test_predictor_pads_and_chunks_like_jax(weights):
    """max_batch=4 over 5 inputs: one full chunk and one padded one; the
    port's Predictor gives the JAX Predictor's outputs."""
    jm, variables, tm = weights
    x = np.random.default_rng(8).uniform(size=(5, SIZE, SIZE, 3)).astype(
        np.float32)
    state = types.SimpleNamespace(params=variables["params"],
                                  batch_stats=variables["batch_stats"])
    want = JaxPredictor(jm, state, (SIZE, SIZE, 3), max_batch=4)(x)
    pred = serve.Predictor(tm, (SIZE, SIZE, 3), max_batch=4)
    got = pred(x)
    assert got.shape == want.shape == (5, SIZE, SIZE, 1)
    assert got.dtype == np.float32
    assert float(np.max(np.abs(got - want))) <= 1e-4
    assert pred(x[:0]).shape == (0, SIZE, SIZE, 1)
    with pytest.raises(ValueError, match="expected inputs"):
        pred(x[:, :16])


def test_http_round_trip_matches_jax(weights, tmp_path):
    """make_server on device='cpu' with the fold's best.pt: /healthz,
    /info, /metrics, 400 on garbage, 404, and a /predict mask equal to
    label_from_pred of the JAX output away from the threshold."""
    from PIL import Image

    jm, variables, tm = weights
    cfg = _cfg(tmp_path)
    (tmp_path / "Fold_1").mkdir()
    torch.save(tm.state_dict(), tmp_path / "Fold_1" / "best.pt")
    server = serve.make_server(cfg, str(tmp_path / "Fold_1"), port=0,
                               max_batch=2, device="cpu")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        assert urllib.request.urlopen(base + "/healthz").read() == b"ok"
        info = json.loads(urllib.request.urlopen(base + "/info").read())
        assert info["input_size"] == [SIZE, SIZE, 3]
        assert info["device"] == "cpu" and info["max_batch"] == 2

        img = (np.random.default_rng(9).uniform(size=(SIZE, SIZE, 3))
               * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "PNG")
        resp = urllib.request.urlopen(urllib.request.Request(
            base + "/predict", data=buf.getvalue(), method="POST"))
        assert resp.headers["Content-Type"] == "image/png"
        mask = np.asarray(Image.open(io.BytesIO(resp.read())))
        assert mask.shape == (SIZE, SIZE)

        x = img.astype(np.float32)[None] / 255.0
        apply = jax.jit(lambda v, x: jm.apply(v, x, train=False)["out"])
        prob = np.asarray(apply(variables, jnp.asarray(x)))[0]
        want = jax_label_from_pred(prob, 1, 0.5) * 255
        away = np.abs(prob[..., 0] - 0.5) > 1e-3
        assert away.mean() > 0.9
        np.testing.assert_array_equal(mask[away], want[away])

        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(urllib.request.Request(
                base + "/predict", data=b"not an image", method="POST"))
        assert exc.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(base + "/nope")
        assert exc.value.code == 404
        text = urllib.request.urlopen(base + "/metrics").read().decode()
        assert 'tpuseg_requests_total{code="200"} 3' in text
        assert 'tpuseg_requests_total{code="400"} 1' in text
        assert 'tpuseg_requests_total{code="404"} 1' in text
        assert "tpuseg_request_latency_seconds_count 1" in text
    finally:
        server.shutdown()
        server.server_close()
        server.batcher.close()


def test_dynamic_batcher_coalesces_concurrent_requests(weights):
    """Four concurrent single-image requests ride fewer than four device
    batches, and each caller gets its own result."""
    _, _, tm = weights
    predictor = serve.Predictor(tm, (SIZE, SIZE, 3), max_batch=4)
    calls = []

    class Counting:
        max_batch = predictor.max_batch
        input_size = predictor.input_size

        def __call__(self, batch):
            calls.append(batch.shape[0])
            return predictor(batch)

    batcher = serve.DynamicBatcher(Counting(), window_ms=200.0)
    try:
        x = np.random.default_rng(10).uniform(size=(4, SIZE, SIZE, 3)).astype(
            np.float32)
        results = [None] * 4

        def worker(i):
            results[i] = batcher.predict(x[i], timeout=30)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
            assert not th.is_alive()
        want = predictor(x)
        for i in range(4):  # batch composition may differ: not bitwise
            np.testing.assert_allclose(results[i], want[i], atol=1e-6)
        assert sum(calls) == 4 and len(calls) < 4, calls
    finally:
        batcher.close()


def test_cuda_device_raises_without_a_gpu(tmp_path):
    """``device='cuda'`` (the default) refuses a host with no GPU instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.make_server(_cfg(tmp_path), str(tmp_path / "Fold_1"), port=0)


def test_cli_serve_refuses_unported_options(tmp_path):
    ini = tmp_path / "Train_Configs.ini"
    ini.write_text("[TRAIN]\nimlength = 32\nimwidth = 32\n"
                   "decoder_name = UNetPP\nmodel_width = 4\n"
                   f"model_depth = 2\nsave_dir = {tmp_path}\n")
    with pytest.raises(NotImplementedError, match="int8"):
        cli_main(["serve", str(ini), "--int8", "--device", "cpu"])


def test_train_config_schema_matches_jax(tmp_path):
    """Same fields, defaults and INI parsing as the JAX package's
    ``TrainConfig``/``load_train_config``."""
    ini = tmp_path / "Train_Configs.ini"
    ini.write_text("[TRAIN]\nimlength = 256\nimwidth = 256\n"
                   "decoder_name = UNetPP\nmodel_width = 32\n"
                   "model_depth = 4\ncompute_dtype = bfloat16\n"
                   "metric_list = MeanSquaredError, BinaryIoU\n"
                   "is_transconv = true\nlearning_rate = 3e-4\n"
                   "unknown_key = ignored\n")
    ours = dataclasses.asdict(load_train_config(str(ini)))
    theirs = dataclasses.asdict(jax_config.load_train_config(str(ini)))
    assert ours == theirs
    assert ours["metric_list"] == ("MeanSquaredError", "BinaryIoU")
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(
        jax_config.TrainConfig())
