"""Tests that need an NVIDIA GPU (``cuda`` marker); they skip elsewhere.

This file imports torch and the port only, so it runs on a machine
without JAX:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest

torch = pytest.importorskip("torch")

from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pool_backward, pyramid)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,levels", [
    (torch.bfloat16, (8, 256, 256, 32), 1),
    (torch.bfloat16, (8, 32, 32, 256), 1),
    (torch.float32, (8, 256, 256, 1), 4),
    (torch.float32, (2, 37, 53, 3), 2),
    (torch.bfloat16, (2, 7, 9, 5), 3),
    (torch.bfloat16, (2, 37, 53, 16), 1),  # 16-byte vector path, ragged
    (torch.float32, (3, 9, 11, 4), 1),     # 16-byte vector path, f32
    (torch.bfloat16, (2, 16, 16, 3), 1),   # C % 8 != 0: one-channel path
])
def test_cuda_kernel_equals_plain_version(dtype, shape, levels):
    """On the card: the CUDA kernel launches once and equals the plain
    version bit for bit (NaN included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs in chip_smoke.py's checks "
                    "on the card)")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g)
    x.view(-1)[x.numel() // 3] = float("nan")
    x = x.to("cuda", dtype).permute(0, 3, 1, 2)
    before = pyramid.launches.value
    got = pyramid.maxpool_pyramid(x, levels)
    torch.cuda.synchronize()
    assert pyramid.launches.value == before + 1
    for k, w in zip(got, pyramid.maxpool_pyramid_plain(x, levels)):
        assert k.shape == w.shape
        assert torch.equal(k.nan_to_num(7.0), w.nan_to_num(7.0))
        assert torch.equal(k.isnan(), w.isnan())


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _assert_same(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,levels,wanted", [
    (torch.float32, (16, 256, 256, 1), 4, None),   # the DS mask, C=1 kernel
    (torch.float32, (3, 37, 53, 1), 3, None),      # ragged, unaligned rows
    (torch.bfloat16, (2, 64, 64, 1), 4, None),     # levels 1-3 in a thread
    (torch.float32, (2, 19, 130, 1), 5, (2, 5)),   # some levels, L=5
    (torch.bfloat16, (2, 37, 53, 16), 3, None),    # several levels, 16-byte
    (torch.bfloat16, (2, 37, 53, 16), 3, (1, 3)),  # levels 1 and 3 only
    (torch.float32, (2, 40, 70, 4), 4, None),
    (torch.bfloat16, (16, 256, 256, 32), 3, None),  # UNet3+'s skip 0
    (torch.bfloat16, (16, 256, 256, 32), 5, None),  # a D5 tap: 16 lanes
    (torch.bfloat16, (16, 256, 256, 32), 5, (5,)),  # the pool by 32
    (torch.float32, (3, 129, 200, 24), 5, (1, 4, 5)),  # ragged, f32
])
def test_cuda_c1_and_multilevel_kernels_equal_plain_version(dtype, shape,
                                                            levels, wanted):
    """The C=1 kernel and the 16-byte kernel for several levels launch
    once and equal the plain version bit for bit, NaN positions kept."""
    _need_cuda()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(shape, generator=g)
    x.view(-1)[x.numel() // 3] = float("nan")
    x = x.to("cuda", dtype).permute(0, 3, 1, 2)
    before = pyramid.launches.value
    got = pyramid.maxpool_pyramid(x, levels, wanted)
    torch.cuda.synchronize()
    assert pyramid.launches.value == before + 1
    want = pyramid.maxpool_pyramid_plain(x, levels, wanted)
    assert len(got) == len(want)
    for k, w in zip(got, want):
        _assert_same(k, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_c1_kernel_on_an_offset_view(dtype):
    """A C=1 view one element into its storage: no row starts on 16 bytes,
    and the kernel reads every row element by element."""
    _need_cuda()
    b, h, w = 2, 32, 40
    flat = torch.randn(1 + b * h * w, generator=torch.Generator()
                       .manual_seed(4)).to("cuda", dtype)
    x = flat[1:].view(b, h, w, 1).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.data_ptr() % 16
    for k, w_ in zip(pyramid.maxpool_pyramid(x, 3),
                     pyramid.maxpool_pyramid_plain(x, 3)):
        _assert_same(k, w_)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_maxpool_levels_gradient_equals_cpu(dtype):
    """``maxpool_levels`` on the card (one pyramid launch, one backward
    launch per level with a gradient) equals the CPU's plain versions,
    forward and gradient, on plateaus with a NaN."""
    _need_cuda()
    g0 = torch.Generator().manual_seed(5)
    x = torch.randn(2, 37, 53, 16, generator=g0)
    x = torch.where(x < 0.3, torch.zeros_like(x), x)
    x.view(-1)[x.numel() // 3] = float("nan")
    x = x.to(dtype).permute(0, 3, 1, 2)
    cots = [torch.randn(2, 37 >> lvl, 53 >> lvl, 16, generator=g0).to(
        dtype).permute(0, 3, 1, 2) for lvl in (1, 2, 3)]
    grads = []
    for dev in ("cpu", "cuda"):
        xd = x.to(dev).detach().requires_grad_()
        ys = pyramid.maxpool_levels(xd, 3)
        counts = (pyramid.launches.value, pool_backward.launches.value)
        torch.autograd.backward([ys[0], ys[2]], [cots[0].to(dev),
                                                 cots[2].to(dev)])
        grads.append((ys, xd.grad))
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (pyramid.launches.value, pool_backward.launches.value) \
                == (counts[0], counts[1] + 2)
    (ys_c, dx_c), (ys_g, dx_g) = grads
    for c, k in zip(ys_c, ys_g):
        _assert_same(k.detach().cpu(), c.detach())
    assert torch.equal(dx_g.cpu(), dx_c)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_what_the_kernel_does_not_take():
    """A CUDA tensor launches the kernel or raises: never the plain path."""
    _need_cuda()
    x = torch.zeros(2, 8, 16, 16, device="cuda")  # NCHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        pyramid.maxpool_pyramid(x, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pyramid.maxpool_pyramid(
            x.half().contiguous(memory_format=torch.channels_last), 1)


@pytest.mark.cuda
def test_cuda_segmodel_float32_matches_cpu():
    """A small UNet++ in float32 on the card (TF32 off) against the CPU:
    the pool runs the kernel once per encoder level."""
    _need_cuda()
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel

    model = SegModel("UNetPP", 8, 3,
                     generator=torch.Generator().manual_seed(0)).eval()
    x = torch.rand(2, 40, 48, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        cpu = model(x)["out"]
    model.to("cuda")
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = pyramid.launches.value
        with torch.inference_mode():
            gpu = model(x.cuda())["out"].cpu()
        assert pyramid.launches.value == before + 3
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert float((gpu - cpu).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_predictor_serves_a_single_request():
    """max_batch=1 (the serve verb's default): one decoded image, given
    as numpy's ``x[None]`` (stride 0 on the batch axis), runs through the
    kernel on the card."""
    _need_cuda()
    import numpy as np

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.serve import Predictor

    model = SegModel("UNetPP", 8, 3, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0))
    pred = Predictor(model.cuda().eval(), (32, 32, 3), max_batch=1)
    x = np.random.default_rng(2).uniform(size=(32, 32, 3)).astype(np.float32)
    before = pyramid.launches.value
    out = pred(x[None])
    assert out.shape == (1, 32, 32, 1) and np.isfinite(out).all()
    assert pyramid.launches.value == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (16, 256, 256, 32)),
    (torch.bfloat16, (16, 32, 32, 256)),
    (torch.float32, (4, 64, 64, 32)),    # 16-byte vector path, f32
    (torch.bfloat16, (2, 37, 53, 16)),   # ragged, vector path
    (torch.float32, (2, 37, 53, 3)),     # ragged, one channel a thread
    (torch.bfloat16, (2, 16, 16, 12)),   # C % 8 != 0
    (torch.float32, (3, 9, 11, 4)),
    (torch.bfloat16, (1, 1, 1, 8)),      # nothing pooled: all zeros
])
def test_cuda_pool_backward_equals_plain_version(dtype, shape):
    """On the card: the backward kernel launches once and equals the
    plain version bit for bit, on post-ReLU plateaus (ties) with a NaN."""
    _need_cuda()
    g0 = torch.Generator().manual_seed(1)
    x = torch.randn(shape, generator=g0)
    x = torch.where(x < 0.3, torch.zeros_like(x), x)
    x.view(-1)[x.numel() // 3] = float("nan")
    x = x.to("cuda", dtype).permute(0, 3, 1, 2)
    b, c, h, w = x.shape
    g = torch.randn((b, h // 2, w // 2, c), generator=g0).to(
        "cuda", dtype).permute(0, 3, 1, 2)
    before = pool_backward.launches.value
    got = pool_backward.maxpool_backward(x, g, 2)
    torch.cuda.synchronize()
    assert pool_backward.launches.value == before + 1
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, pool_backward.maxpool_backward_plain(x, g, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,factor", [
    (torch.bfloat16, (16, 256, 256, 32), 8),  # UNet3+'s decoder pools
    (torch.bfloat16, (16, 128, 128, 64), 4),
    (torch.bfloat16, (2, 37, 53, 16), 8),     # ragged, vector path
    (torch.float32, (2, 19, 23, 3), 4),       # ragged, one channel a thread
    (torch.float32, (2, 33, 17, 4), 16),
    (torch.bfloat16, (1, 3, 3, 8), 4),        # nothing pooled: all zeros
    (torch.bfloat16, (16, 256, 256, 32), 32),  # a D5 tap pooled by 32
    (torch.float32, (2, 70, 66, 3), 32),      # ragged, one channel a thread
])
def test_cuda_pool_backward_by_factor_equals_plain_version(dtype, shape,
                                                           factor):
    """The backward kernel with a 2**m window: one launch, equal to the
    plain version bit for bit on plateaus with a NaN; the pool's forward
    (level m alone) equals the plain pyramid's level m."""
    _need_cuda()
    g0 = torch.Generator().manual_seed(2)
    x = torch.randn(shape, generator=g0)
    x = torch.where(x < 0.3, torch.zeros_like(x), x)
    x.view(-1)[x.numel() // 3] = float("nan")
    x = x.to("cuda", dtype).permute(0, 3, 1, 2)
    b, c, h, w = x.shape
    g = torch.randn((b, h // factor, w // factor, c), generator=g0).to(
        "cuda", dtype).permute(0, 3, 1, 2)
    before = pool_backward.launches.value
    got = pool_backward.maxpool_backward(x, g, factor)
    torch.cuda.synchronize()
    assert pool_backward.launches.value == before + 1
    assert torch.equal(got, pool_backward.maxpool_backward_plain(x, g,
                                                                 factor))
    level = factor.bit_length() - 1
    y = pyramid.maxpool_level(x, level)
    want = pyramid.maxpool_pyramid_plain(x, level)[-1]
    assert torch.equal(y.isnan(), want.isnan())
    assert torch.equal(y.nan_to_num(7.0), want.nan_to_num(7.0))


@pytest.mark.cuda
def test_cuda_pool_backward_refuses_what_the_kernel_does_not_take():
    """A CUDA tensor launches the kernel or raises, never the plain
    version; a gradient in another layout is copied (and counted)."""
    _need_cuda()
    cl = torch.channels_last
    x = torch.randn(2, 8, 6, 6, device="cuda").contiguous(memory_format=cl)
    g = torch.randn(2, 8, 3, 3, device="cuda")  # NCHW-contiguous
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pool_backward.maxpool_backward(x.half(), g.half(), 2)
    with pytest.raises(ValueError, match="channels_last"):
        pool_backward.maxpool_backward(x.contiguous(), g, 2)
    with pytest.raises(TypeError):
        pool_backward.maxpool_backward(x, g.double(), 2)
    copies, launches = pool_backward.g_copies.value, pool_backward.launches.value
    got = pool_backward.maxpool_backward(x, g, 2)
    assert (pool_backward.g_copies.value, pool_backward.launches.value) == (
        copies + 1, launches + 1)
    assert torch.equal(got, pool_backward.maxpool_backward_plain(x, g, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,offset,kernel", [
    (torch.bfloat16, (16, 256, 256, 31), 0, "pool_rows_kernel"),
    (torch.bfloat16, (16, 32, 32, 426), 0, "pool_rows_kernel"),
    (torch.bfloat16, (2, 4, 1024, 51), 0, "pool_rows_kernel"),  # 7 spans
    (torch.bfloat16, (2, 37, 64, 51), 0, "pool_rows_kernel"),   # ragged H
    (torch.float32, (2, 64, 64, 7), 0, "pool_rows_kernel"),
    (torch.bfloat16, (2, 8, 128, 31), 8, "pool_rows_kernel"),   # 16 bytes in
    (torch.bfloat16, (2, 8, 64, 31), 1, "pyramid_kernel"),      # rows unaligned
    (torch.bfloat16, (2, 37, 53, 3), 0, "pyramid_kernel"),      # ragged W
])
def test_cuda_odd_channel_pool_routes_and_equals_plain_version(
        dtype, shape, offset, kernel):
    """A pool by 2 at a C that is not a multiple of 16 bytes takes the row
    kernel when every row starts on 16 bytes, else the one-channel-a-thread
    kernel; either equals the plain version bit for bit, NaN kept."""
    _need_cuda()
    g0 = torch.Generator().manual_seed(6)
    x = torch.randn(shape, generator=g0)
    x.view(-1)[x.numel() // 3] = float("nan")
    flat = torch.zeros(offset + x.numel(), dtype=dtype, device="cuda")
    flat[offset:] = x.reshape(-1).to(flat)
    x = flat[offset:].view(shape).permute(0, 3, 1, 2)
    assert pyramid.route(x, 1) == kernel
    before = pyramid.launches.value
    got = pyramid.maxpool_level(x, 1)
    torch.cuda.synchronize()
    assert pyramid.launches.value == before + 1
    _assert_same(got, pyramid.maxpool_pyramid_plain(x, 1)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,factor,kernel", [
    (torch.bfloat16, (16, 256, 256, 32), 16, "pool_backward_rows_kernel"),
    (torch.bfloat16, (2, 32, 32, 32), 16, "pool_backward_rows_kernel"),
    (torch.bfloat16, (2, 64, 64, 32), 32, "pool_backward_block_kernel"),
    (torch.bfloat16, (2, 37, 53, 16), 8, "pool_backward_rows_kernel"),
    (torch.float32, (2, 19, 23, 3), 4, "pool_backward_rows_kernel<V=1>"),
    (torch.bfloat16, (16, 256, 256, 32), 2, "pool_backward_kernel"),
    (torch.bfloat16, (2, 37, 53, 3), 2, "pool_backward_kernel<V=1>"),
])
def test_cuda_pool_backward_routes_and_equals_plain_version(dtype, shape,
                                                            factor, kernel):
    """Windows of 4 to 16 take the row-split kernel, windows of 32 the
    block kernel, windows of 2 the whole-window walk; the gradient equals
    the plain version bit for bit
    on plateaus with NaNs at a window's first and last elements and twice
    in one window."""
    _need_cuda()
    g0 = torch.Generator().manual_seed(7)
    x = torch.randn(shape, generator=g0)
    x = torch.where(x < 0.3, torch.zeros_like(x), x)
    f = factor
    if shape[1] >= f and shape[2] >= 2 * f:
        x[0, 0, 0, 0] = float("nan")                # window (0, 0), first
        x[0, f - 1, 2 * f - 1, 0] = float("nan")    # window (0, 1), last
        x[-1, 1, 1, -1] = float("nan")              # twice in window (0, 0)
        x[-1, f - 2, 0, -1] = float("nan")
        x[-1, f - 2, 1:f, -1] = -5.0
    x = x.to("cuda", dtype).permute(0, 3, 1, 2)
    b, c, h, w = x.shape
    g = torch.randn((b, h // f, w // f, c), generator=g0).to(
        "cuda", dtype).permute(0, 3, 1, 2)
    assert pool_backward.route(x, g, f) == kernel
    before = pool_backward.launches.value
    got = pool_backward.maxpool_backward(x, g, f)
    torch.cuda.synchronize()
    assert pool_backward.launches.value == before + 1
    assert torch.equal(got, pool_backward.maxpool_backward_plain(x, g, f))


@pytest.mark.cuda
def test_cuda_train_step_float32_matches_cpu():
    """One float32 train step of a small UNet++ on the card (TF32 off,
    deterministic cuDNN) against the CPU from the same weights: loss
    within 1e-5 and gradients within 1e-4; 3 pool launches each way."""
    _need_cuda()
    import copy

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        bce_dice_loss, make_optimizer, make_train_step)

    cpu = SegModel("UNetPP", 8, 3, generator=torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(2, 40, 48, 3, generator=gen)
    y = (torch.rand(2, 40, 48, 1, generator=gen) > 0.6).float()
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        loss_c, _ = make_train_step(
            cpu, make_optimizer("Adam", cpu.parameters(), 1e-3),
            bce_dice_loss)(x, y)
        counts = (pyramid.launches.value, pool_backward.launches.value)
        loss_g, _ = make_train_step(
            gpu, make_optimizer("Adam", gpu.parameters(), 1e-3),
            bce_dice_loss)(x.cuda(), y.cuda())
        torch.cuda.synchronize()
        assert (pyramid.launches.value, pool_backward.launches.value) == (
            counts[0] + 3, counts[1] + 3)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cudnn.deterministic = flags
    assert abs(float(loss_c) - float(loss_g)) <= 1e-5
    gp = dict(gpu.named_parameters())
    for k, p in cpu.named_parameters():
        assert float((p.grad - gp[k].grad.cpu()).abs().max()) <= 1e-4, k


@pytest.mark.cuda
@pytest.mark.parametrize("decoder,ds", [("UNet", 1), ("UNetE", 0),
                                        ("UNetP", 1)])
def test_cuda_config2_forward_equals_plain_pool(decoder, ds):
    """A W8/D3 model of BASELINE config 2 in bf16 on the card: one kernel
    launch per encoder pool, and every head equal to the same model's
    forward with the plain pool on the card (the pool is exact, so the
    rest of the forward sees the same tensors)."""
    _need_cuda()
    from unittest import mock

    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel

    model = SegModel(decoder, 8, 3, ds=ds, dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0)).cuda().eval()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    before = pyramid.launches.value
    with torch.inference_mode():
        got = model(x.cuda())
        torch.cuda.synchronize()
        assert pyramid.launches.value == before + 3
        with mock.patch.object(pyramid, "maxpool_pyramid",
                               pyramid.maxpool_pyramid_plain):
            want = model(x.cuda())
    assert pyramid.launches.value == before + 3
    assert sorted(got) == sorted(want) and len(got) == 1 + 3 * ds
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
def test_cuda_test_verb_runs_end_to_end(tmp_path):
    """The ``test`` verb on the card over 3 PNGs in batches of 2 (one
    padded), with two views stacked into each batch: the model's 3 pools
    launch once per batch, every pixel is counted, the masks and tables
    are written."""
    _need_cuda()
    import os

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images, write_image_folder)
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TestConfig as EvalConfig, TrainConfig)

    write_image_folder(str(tmp_path / "Test"), *synthetic_images(3, 32))
    tcfg = TrainConfig(imlength=32, imwidth=32, decoder_name="UNetP",
                       model_width=4, model_depth=3,
                       save_dir=str(tmp_path / "R"))
    cfg = EvalConfig(test_dir=str(tmp_path / "Test"), imheight=32,
                     imwidth=32, batch_size=2, tta="hflip,rot90",
                     save_dir=tcfg.save_dir)
    before = pyramid.launches.value
    rep = drivers.test(config=cfg, train_config=tcfg)
    assert pyramid.launches.value == before + 3 * 2
    assert rep[1]["checkpoint_restored"] is False
    assert int(rep[1]["confusion_matrix"].sum()) == 3 * 32 * 32
    results = tmp_path / "R" / "test_results" / "fold_1"
    assert sorted(os.listdir(results / "masks")) == [
        f"pred_{i}.png" for i in range(3)]
    assert (results / "results_confusion_matrix.csv").exists()


@pytest.mark.cuda
def test_cuda_conf_counts_equal_the_broadcast_counts():
    """The threshold metrics' ``bucketize`` counts on the card equal the
    broadcast counts at Keras's 200 thresholds, every threshold value and
    a NaN among the predictions."""
    _need_cuda()
    from tf_1d_2d_segmentation_end2endpipelines_torch.train.metrics import (
        _keras_thresholds, conf_counts, conf_counts_broadcast)

    th = torch.tensor(_keras_thresholds(200), device="cuda")
    g = torch.Generator().manual_seed(0)
    p = torch.cat([th.cpu(), torch.rand(4096, generator=g),
                   torch.tensor([float("nan"), -1.0, 2.0])]).cuda()
    t = (torch.rand(p.shape, generator=g) > 0.4).float().cuda()
    got, want = conf_counts(t, p, th), conf_counts_broadcast(t, p, th)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Adam", "Adadelta", "Adagrad", "Adamax",
                                  "FTRL", "Nadam", "RMSprop", "SGD"])
def test_cuda_optimizer_with_clips_matches_cpu(name):
    """Three updates of each optimizer with the three clips biting, on the
    card and on the CPU from the same parameters and gradients: the
    parameters agree within 1e-6 relative or 1e-6 absolute.  (FTRL's
    sigma subtracts the square roots of two nearly equal accumulators and
    divides by lr, so one float32 ulp of a root moves its parameters,
    about 7e-3 here, by up to 2e-7.)"""
    _need_cuda()
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        make_optimizer)

    g = torch.Generator().manual_seed(1)
    shapes = [(16, 8, 3, 3), (16,), (4, 16, 1, 1), (4,)]
    init = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) * (i + 1) for i, s in
              enumerate(shapes)] for _ in range(3)]
    clips = dict(global_clipnorm=5.0, clipnorm=1.0, clipvalue=0.2)
    out = {}
    for device in ("cpu", "cuda"):
        ps = [torch.nn.Parameter(x.clone().to(device)) for x in init]
        opt = make_optimizer(name, ps, 1e-2, **clips)
        for step in grads:
            for p, gr in zip(ps, step):
                p.grad = gr.clone().to(device)
            opt.step()
        out[device] = [p.detach().cpu() for p in ps]
    for a, b in zip(out["cpu"], out["cuda"]):
        torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_cuda_predict_verb_runs_end_to_end(tmp_path):
    """The ``predict`` verb on the card (its default device) over 3 PNGs
    in batches of 2 (one padded) with one view: the model's 3 pools
    launch once per device batch and once for the warm-up, and a mask is
    written per image."""
    _need_cuda()
    import os

    from tf_1d_2d_segmentation_end2endpipelines_torch import drivers
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        synthetic_images, write_image_folder)
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.config import (
        TrainConfig)

    write_image_folder(str(tmp_path / "In"), *synthetic_images(3, 32))
    cfg = TrainConfig(imlength=32, imwidth=32, decoder_name="UNetP",
                      model_width=4, model_depth=3,
                      save_dir=str(tmp_path / "R"))
    before = pyramid.launches.value
    written = drivers.predict(cfg, input_path=str(tmp_path / "In" / "images"),
                              out_dir=str(tmp_path / "out"), batch=2,
                              tta="hflip")
    assert pyramid.launches.value == before + 3 * (2 + 1)
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        os.path.basename(w) for w in written) and len(written) == 3


# ---------------------------------------------- the rest of training

@pytest.mark.cuda
@pytest.mark.parametrize("seed,warp_mode,fast", [
    (0, "batch", True), (1, "sample", True), (2, "sample", False)])
def test_cuda_device_augment_equals_the_cpu(seed, warp_mode, fast):
    """The on-card augmentation of a batch equals the same draws applied
    on the CPU: images within 1e-5, masks equal, label values kept."""
    _need_cuda()
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        device_augment as da)

    g = torch.Generator().manual_seed(10 + seed)
    x = torch.rand((4, 64, 64, 3), generator=g)
    y = torch.randint(0, 3, (4, 64, 64, 1), generator=g).float() / 2
    p = da.draw_params(torch.Generator().manual_seed(seed), 4, p_warp=0.8,
                       p_jitter=0.8, warp_mode=warp_mode)
    gi, gm = da.apply_augment(x.cuda(), y.cuda(), p, fast_warp=fast)
    ci, cm = da.apply_augment(x, y, p, fast_warp=fast)
    assert float((gi.cpu() - ci).abs().max()) <= 1e-5
    assert torch.equal(gm.cpu(), cm)
    assert set(gm.unique().tolist()) <= {0.0, 0.5, 1.0}


@pytest.mark.cuda
@pytest.mark.parametrize("option,want", [
    ({}, (3, 3)), ({"remat": "dots"}, (6, 3)),
    ({"remat": "conv_outs"}, (6, 3)), ({"remat": "full"}, (6, 3)),
    ({"block_remat": True}, (3, 3)), ({"accum_steps": 2}, (6, 6)),
    ({"accum_steps": 2, "remat": "conv_outs"}, (12, 6))],
    ids=["plain", "dots", "conv_outs", "full", "blocks", "accum2",
         "accum2_conv_outs"])
def test_cuda_launches_per_step_under_remat_and_accumulation(option, want):
    """A W8/D3 UNet++ step on the card launches the pyramid once per
    encoder pool and forward (the recomputed forward of dots, conv_outs
    and full again; blocks recompute between the pools) and the backward
    once per pool, per microbatch."""
    _need_cuda()
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import SegModel
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        bce_dice_loss, make_optimizer, make_train_step)

    option = dict(option)
    model = SegModel("UNetPP", 8, 3, dtype=torch.bfloat16,
                     block_remat=option.pop("block_remat", False),
                     generator=torch.Generator().manual_seed(0)).cuda()
    step = make_train_step(model, make_optimizer("Adam", model.parameters(),
                                                 1e-3), bce_dice_loss,
                           **option)
    g = torch.Generator().manual_seed(1)
    x = torch.rand((4, 64, 64, 3), generator=g).cuda()
    y = (torch.rand((4, 64, 64, 1), generator=g) > 0.5).float().cuda()
    step(x, y)
    before = (pyramid.launches.value, pool_backward.launches.value)
    loss, _ = step(x, y)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(loss))
    assert (pyramid.launches.value - before[0],
            pool_backward.launches.value - before[1]) == want


def _signal(shape, seed, plateaus=True):
    """A (B, L, C) input with ReLU plateaus and a NaN, as the (B, C, 1, L)
    channels_last CPU tensor the 1D kernels take."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    if plateaus:
        x = torch.where(x < 0.3, torch.zeros_like(x), x)
    x.view(-1)[x.numel() // 3] = float("nan")
    return x.permute(0, 2, 1).unsqueeze(2)


_FLAT16 = "pool1d_flat_kernel<V=16B>"
_FLAT = "pool1d_flat_kernel"
_FLAT_C1 = "pool1d_flat_kernel<C=1>"


def _on_card(x, dtype, offset=0):
    """The (B, C, 1, L) channels_last CPU tensor ``x`` on the card in
    ``dtype``, ``offset`` elements into its storage."""
    b, c, _, n = x.shape
    flat = torch.zeros(offset + x.numel(), dtype=dtype, device="cuda")
    flat[offset:] = x.permute(0, 2, 3, 1).reshape(-1).to(flat)
    return flat[offset:].view(b, 1, n, c).permute(0, 3, 1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,levels,wanted,offset,route", [
    (torch.bfloat16, (128, 1024, 32), 1, (1,), 0, _FLAT16),
    (torch.bfloat16, (128, 256, 128), 1, (1,), 0, _FLAT16),
    (torch.bfloat16, (128, 1024, 31), 1, (1,), 0, _FLAT),
    (torch.bfloat16, (128, 1024, 32), 2, None, 0, _FLAT16),
    (torch.float32, (128, 1024, 1), 3, None, 0, _FLAT_C1),
    (torch.float32, (3, 1001, 8), 4, (1, 3), 0, "pool1d_kernel<V=16B>"),
    (torch.float32, (3, 37, 5), 4, None, 0, "pool1d_kernel<V=1>"),
    (torch.bfloat16, (2, 3, 16), 2, None, 0, "pool1d_kernel<V=16B>"),
    # levels 1-5: UNet3+'s skip 0 at depth 6, MLMRSNet_V2's tap 0 by 32,
    # the DS mask at depth 5 in both dtypes
    (torch.float32, (128, 1024, 32), 5, None, 0, _FLAT16),
    (torch.float32, (128, 1024, 32), 5, (5,), 0, _FLAT16),
    (torch.float32, (128, 1024, 1), 5, None, 0, _FLAT_C1),
    (torch.bfloat16, (3, 64, 1), 5, None, 0, _FLAT_C1),
    (torch.bfloat16, (1, 6, 1), 1, None, 0, _FLAT),  # 6 positions: staged
    # odd C: the MultiRes widths, Dense_Inception_UNet's 33; a last span
    # cut short, a level subset
    (torch.float32, (128, 512, 62), 1, (1,), 0, _FLAT),
    (torch.float32, (128, 1024, 33), 1, (1,), 0, _FLAT),
    (torch.bfloat16, (7, 96, 31), 5, (2, 5), 0, _FLAT),
    (torch.float32, (5, 64, 3), 4, (1, 4), 0, _FLAT),
    # ragged lengths and offset views: the one-window-a-thread kernel
    (torch.float32, (2, 100, 33), 5, None, 0, "pool1d_kernel<V=1>"),
    (torch.bfloat16, (2, 70, 24), 5, (5,), 0, "pool1d_kernel<V=16B>"),
    (torch.bfloat16, (2, 64, 24), 1, (1,), 1, "pool1d_kernel<V=1>"),
    (torch.float32, (2, 64, 1), 3, None, 2, "pool1d_kernel<V=1>"),
    (torch.bfloat16, (2, 64, 8), 2, None, 8, _FLAT16),  # 16 bytes in
    # levels 1-6: UNet3+'s skip 0 at depth 7 in both dtypes, the DS mask
    # at depth 6, 8 lanes a top row; odd C, ragged, short and offset
    (torch.float32, (128, 1024, 32), 6, None, 0, _FLAT16),
    (torch.bfloat16, (128, 1024, 32), 6, None, 0, _FLAT16),
    (torch.float32, (128, 1024, 1), 6, None, 0, _FLAT_C1),
    (torch.bfloat16, (3, 128, 1), 6, None, 0, _FLAT_C1),
    (torch.float32, (3, 192, 12), 6, (1, 6), 0, _FLAT16),
    (torch.float32, (5, 64, 3), 6, None, 0, _FLAT),
    (torch.float32, (3, 200, 33), 6, None, 0, "pool1d_kernel<V=1>"),
    (torch.bfloat16, (7, 128, 31), 6, (2, 6), 0, "pool1d_kernel<V=1>"),
    (torch.float32, (2, 63, 8), 6, None, 0, "pool1d_kernel<V=16B>"),
    (torch.float32, (2, 128, 8), 6, (6,), 4, _FLAT16),
])
def test_cuda_pool1d_kernel_equals_plain_version(dtype, shape, levels,
                                                 wanted, offset, route):
    """The 1D pyramid launches once, takes the named route and equals
    its plain version bit for bit (NaN positions kept), ragged lengths,
    views into their storage and level subsets included."""
    _need_cuda()
    x = _on_card(_signal(shape, 6), dtype, offset)
    assert pyramid.route1d(x, levels, wanted) == route
    pyramid.launches.reset()
    got = pyramid.maxpool1d_pyramid(x, levels, wanted)
    torch.cuda.synchronize()
    assert pyramid.launches.by_kernel == {route: 1}
    want = pyramid.maxpool1d_pyramid_plain(x, levels, wanted)
    assert len(got) == len(want)
    for k, w in zip(got, want):
        _assert_same(k, w)
        assert torch.equal(_bits(k), _bits(w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,factor", [
    (torch.bfloat16, (128, 1024, 32), 2), (torch.bfloat16, (128, 1024, 31), 2),
    (torch.float32, (3, 1001, 8), 4), (torch.bfloat16, (2, 77, 3), 8),
    (torch.float32, (2, 37, 16), 16), (torch.bfloat16, (1, 3, 8), 4),
    # F = 32: UNet3+'s skip 0 at depth 6, UNet4P's tap 1 at depth 7; odd
    # and one channel, a ragged tail, a signal shorter than a window
    (torch.float32, (128, 1024, 32), 32), (torch.bfloat16, (128, 512, 64), 32),
    (torch.float32, (3, 100, 33), 32), (torch.bfloat16, (2, 96, 1), 32),
    (torch.float32, (2, 31, 8), 32),
    # F = 64, two lanes a window: UNet3+'s skip 0 at depth 7; odd and one
    # channel, ragged tails, a signal shorter than a window
    (torch.float32, (128, 1024, 32), 64), (torch.bfloat16, (128, 1024, 32), 64),
    (torch.float32, (3, 200, 33), 64), (torch.bfloat16, (2, 192, 1), 64),
    (torch.float32, (3, 130, 8), 64), (torch.float32, (2, 63, 8), 64),
])
def test_cuda_pool1d_backward_equals_plain_version(dtype, shape, factor):
    """The 1D pool backward routes each gradient as the plain version
    does (the first maximum; NaN as select_and_scatter), bit for bit,
    zeros past the floor."""
    _need_cuda()
    x = _signal(shape, 7).to("cuda", dtype)
    b, c, _, n = x.shape
    g = torch.randn((b, c, 1, n // factor), generator=torch.Generator()
                    .manual_seed(8)).to("cuda", dtype).contiguous(
        memory_format=torch.channels_last)
    before = pool_backward.launches.value
    got = pool_backward.maxpool1d_backward(x, g, factor)
    torch.cuda.synchronize()
    assert pool_backward.launches.value == before + 1
    assert torch.equal(got, pool_backward.maxpool1d_backward_plain(x, g,
                                                                   factor))


@pytest.mark.cuda
def test_cuda_model_1d_step_launches_and_matches_cpu():
    """A W8 D3 UNet3P with ``ds = 1`` on (4, 256, 1): one float32 train
    step on the card launches 3 encoder pools, 2 skip pyramids and the
    targets pyramid (6) and 3 + 3 backward kernels, and gives the CPU's
    loss within 1e-4."""
    _need_cuda()
    from tf_1d_2d_segmentation_end2endpipelines_torch.data import (
        prepare_train_dict)
    from tf_1d_2d_segmentation_end2endpipelines_torch.models import (
        model_selector_1d)
    from tf_1d_2d_segmentation_end2endpipelines_torch.train import (
        Trainer, default_ds_weights)

    x = torch.randn(4, 256, 1, generator=torch.Generator().manual_seed(9))
    y = (torch.rand(4, 256, 1, generator=torch.Generator().manual_seed(10))
         > 0.5).float()
    losses = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            model = model_selector_1d(
                "UNet3P", 256, 3, 1, 8, 3, ds=1,
                generator=torch.Generator().manual_seed(0))
            trainer = Trainer(model, loss="MeanAbsoluteError", device=dev,
                              loss_weights=default_ds_weights(3),
                              prepare_targets=lambda m: prepare_train_dict(
                                  m, 3, "UNet", spatial_rank=1))
            counts = (pyramid.launches.value, pool_backward.launches.value)
            loss, _ = trainer.train_step(*trainer._batch(x.numpy(),
                                                         y.numpy()))
            losses.append(float(loss))
            if dev == "cuda":
                torch.cuda.synchronize()
                assert (pyramid.launches.value - counts[0],
                        pool_backward.launches.value - counts[1]) == (6, 6)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert abs(losses[0] - losses[1]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 192, 15, 15), (2, 7, 9, 9)])
def test_cuda_inception_average_pool_gradient_equals_cpu(shape):
    """The backbones' SAME average pool on a channels_last card tensor:
    forward and gradient equal the CPU's (PyTorch's channels_last
    ``avg_pool2d`` backward at stride 1 with padding was wrong on the
    card, so ``base.avgpool_same`` pools NCHW memory)."""
    _need_cuda()
    from tf_1d_2d_segmentation_end2endpipelines_torch.models.backbones import (
        base)

    g0 = torch.Generator().manual_seed(4)
    x = torch.randn(shape, generator=g0)
    g = torch.randn(shape, generator=g0)
    out = []
    for dev in ("cpu", "cuda"):
        xt = x.to(dev).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        y = base.avgpool_same(xt)
        assert y.is_contiguous(memory_format=torch.channels_last)
        y.backward(g.to(dev))
        out.append((y.detach().cpu(), xt.grad.cpu()))
    assert torch.allclose(out[0][0], out[1][0], atol=1e-6)
    assert torch.allclose(out[0][1], out[1][1], atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2])
def test_cuda_mlmrsnet_average_pool_gradient_equals_cpu(stride):
    """MLMRSNet's window-3 SAME average along a (B, C, 1, L) channels_last
    signal (``avg_pool2d`` at padding 0 after ``F.pad``): forward and
    gradient on the card equal the CPU's."""
    _need_cuda()
    from tf_1d_2d_segmentation_end2endpipelines_torch.models.mlmrsnet import (
        pool_same)

    g0 = torch.Generator().manual_seed(5)
    x = torch.randn(4, 32, 1, 1024, generator=g0)
    out = []
    for dev in ("cpu", "cuda"):
        xt = x.to(dev).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        y = pool_same(xt, stride, "avg")
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(6))
        y.backward(g.to(dev))
        out.append((y.detach().cpu(), xt.grad.cpu()))
    assert torch.allclose(out[0][0], out[1][0], atol=1e-6)
    assert torch.allclose(out[0][1], out[1][1], atol=1e-6)


def _plateau_input(shape, seed, dtype, plants=()):
    """An NHWC input with ReLU plateaus (ties everywhere) and one NaN, the
    ``plants`` (index, value) set after them, as a (B, C, H, W)
    channels_last card tensor."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    x = torch.where(x < 0.3, torch.zeros_like(x), x)
    x.view(-1)[x.numel() // 3] = float("nan")
    for idx, value in plants:
        x[idx] = value
    return x.to("cuda", dtype).permute(0, 3, 1, 2)


def _bits(t):
    """The bit patterns of ``t``, every NaN made one pattern (a kernel and
    the plain version may carry different NaN payloads)."""
    t = torch.where(t.isnan(), torch.full_like(t, float("nan")), t)
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


_ROWS16 = "pool_rows_kernel<V=16B>"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,level,kernel", [
    (torch.bfloat16, (16, 256, 256, 32), 4, _ROWS16),  # AHNet
    (torch.bfloat16, (16, 128, 128, 32), 3, _ROWS16),
    (torch.bfloat16, (4, 64, 64, 512), 2, _ROWS16),  # projector
    (torch.bfloat16, (3, 67, 45, 24), 2, _ROWS16),   # ragged
    (torch.float32, (2, 70, 130, 20), 3, _ROWS16),   # f32
    (torch.float32, (2, 37, 41, 64), 4, _ROWS16),
    (torch.bfloat16, (2, 50, 1000, 8), 2, _ROWS16),  # spans
    (torch.bfloat16, (1, 33, 40, 1024), 4, _ROWS16),  # 1 px
    (torch.bfloat16, (1, 16, 16, 2048), 4, "pool_vec_kernel"),  # too wide
    (torch.bfloat16, (2, 37, 53, 16), 1, "pool_vec_kernel"),    # level 1
])
def test_cuda_single_level_pools_equal_plain_version(dtype, shape, level,
                                                     kernel):
    """A single-level pool by 4, 8 or 16 at a C of whole 16 bytes takes
    the row kernel's 16-byte fold (a C whose folded row passes its shared
    memory, and level 1, the one-window-a-thread kernel): one launch,
    counted under that kernel's name, equal to the plain version bit for
    bit on inputs with ReLU plateaus of +0.0 and a NaN."""
    _need_cuda()
    x = _plateau_input(shape, 11, dtype)
    assert pyramid.route(x, level, (level,)) == kernel
    pyramid.launches.reset()
    got = pyramid.maxpool_level(x, level)
    torch.cuda.synchronize()
    assert pyramid.launches.by_kernel == {kernel: 1}
    want = pyramid.maxpool_level_plain(x, level)
    _assert_same(got, want)
    assert torch.equal(_bits(got), _bits(want))


#: NHWC plants for the F = 32 backward: NaNs first, last and twice in a
#: window (the second followed by -5s), a window of -inf with a NaN last
#: (channel 4) or first (5), and one of -1 with -0.0 before +0.0 (6)
_PLANTS_32 = (
    ((0, 0, 0, 1), float("nan")), ((0, 31, 63, 2), float("nan")),
    ((1, 3, 4, 3), float("nan")), ((1, 20, 12, 3), float("nan")),
    ((1, 20, slice(13, 32), 3), -5.0),
    ((0, slice(0, 32), slice(0, 32), slice(4, 6)), float("-inf")),
    ((0, 31, 31, 4), float("nan")), ((0, 0, 0, 5), float("nan")),
    ((1, slice(0, 32), slice(0, 32), 6), -1.0), ((1, 5, 6, 6), -0.0),
    ((1, 5, 7, 6), 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,plants,kernel", [
    (torch.bfloat16, (16, 256, 256, 32), (), "pool_backward_block_kernel"),
    (torch.bfloat16, (2, 64, 64, 32), _PLANTS_32,
     "pool_backward_block_kernel"),
    (torch.float32, (2, 70, 66, 8), _PLANTS_32,
     "pool_backward_block_kernel"),                      # f32, ragged
    (torch.bfloat16, (3, 100, 40, 64), (), "pool_backward_block_kernel"),
    (torch.bfloat16, (1, 33, 65, 24), (), "pool_backward_block_kernel"),
    (torch.float32, (2, 70, 66, 7), _PLANTS_32,
     "pool_backward_block_kernel<V=1>"),                 # odd C
])
def test_cuda_pool_backward_by_32_equals_plain_version(dtype, shape, plants,
                                                       kernel):
    """The pool backward by 32 takes the block kernel: one launch, counted
    under its name, equal to the plain version (the walk's first maximum,
    NaN as select_and_scatter) bit for bit, zeros past the floor."""
    _need_cuda()
    x = _plateau_input(shape, 12, dtype, plants)
    b, c, h, w = x.shape
    g = torch.randn((b, c, h // 32, w // 32), generator=torch.Generator()
                    .manual_seed(13)).to("cuda", dtype).contiguous(
        memory_format=torch.channels_last)
    assert pool_backward.route(x, g, 32) == kernel
    pool_backward.launches.reset()
    got = pool_backward.maxpool_backward(x, g, 32)
    torch.cuda.synchronize()
    assert pool_backward.launches.by_kernel == {kernel: 1}
    want = pool_backward.maxpool_backward_plain(x, g, 32)
    assert torch.equal(_bits(got), _bits(want))


def _library_pools():
    from tf_1d_2d_segmentation_end2endpipelines_torch.models.backbones import (
        base, convnets)
    import torch.nn.functional as F

    return {
        "maxpool_same_s2": lambda x: base.maxpool(x, 3, 2, "SAME"),
        "maxpool_same_s1": lambda x: base.maxpool(x, 3, 1, "SAME"),
        "maxpool_valid_s2": lambda x: base.maxpool(x, 3, 2, "VALID"),
        "resnet_stem": convnets._stem_pool,
        "densenet_transition": lambda x: F.avg_pool2d(x, 2, 2),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pool", ["maxpool_same_s2", "maxpool_same_s1",
                                  "maxpool_valid_s2", "resnet_stem",
                                  "densenet_transition"])
def test_cuda_backbone_library_pools_equal_cpu(pool, dtype):
    """The backbones' PyTorch pools on a channels_last card tensor with
    plateaus (ties that the max must route to the first maximum, as on
    the CPU): forward and gradient equal the CPU's.  The max pools are
    exact; the average may round in another order (within 1e-6 in
    float32, one bf16 rounding in bfloat16), and a gradient summed over up
    to 9 overlapping windows too: within 1e-6 of the largest in float32,
    2**-5 of it in bfloat16 (a bf16 rounding after each of the sums).  An
    O(1) error, as PyTorch's channels_last ``avg_pool2d`` backward at
    stride 1 with padding gave (ROADMAP C.5), fails."""
    _need_cuda()
    fn = _library_pools()[pool]
    g0 = torch.Generator().manual_seed(14)
    x = torch.randn(2, 24, 29, 33, generator=g0)
    x = torch.where(x < 0.3, torch.zeros_like(x), x).to(dtype)
    out = []
    for dev in ("cpu", "cuda"):
        xt = x.to(dev).contiguous(
            memory_format=torch.channels_last).requires_grad_()
        y = fn(xt)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(15))
        y.backward(g.to(dev, dtype))
        out.append((y.detach().float().cpu(), xt.grad.float().cpu()))
    (y_cpu, dx_cpu), (y_card, dx_card) = out
    f32 = dtype == torch.float32
    if pool.startswith("densenet"):
        tol = 1e-6 if f32 else 2.0 ** -8
        assert torch.allclose(y_card, y_cpu, atol=tol, rtol=tol)
    else:
        assert torch.equal(y_card, y_cpu)
    scale = max(float(dx_cpu.abs().max()), 1.0)
    assert float((dx_card - dx_cpu).abs().max()) <= (
        1e-6 if f32 else 2.0 ** -5) * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_dropblock_max_pool_equals_cpu(dtype):
    """DropBlock's stride-1 SAME max pool along a (B, C, 1, L)
    channels_last signal (forward only: the mask takes no gradient) on
    the card equals the CPU's for the same draws, the block size even
    (asymmetric pads) and odd."""
    _need_cuda()
    from tf_1d_2d_segmentation_end2endpipelines_torch.ops.stochastic import (
        DropBlock)

    x = torch.randn(4, 32, 1, 1024, generator=torch.Generator().manual_seed(16)
                    ).to(dtype)
    draws = torch.rand(x.shape, generator=torch.Generator().manual_seed(17)
                       ) < 0.02
    for block_size in (7, 4):
        masks = []
        for dev in ("cpu", "cuda"):
            layer = DropBlock(block_size=block_size, keep_prob=0.9)
            layer.replayed = draws
            masks.append(layer.block_mask(x.to(dev).contiguous(
                memory_format=torch.channels_last)).cpu())
        assert torch.equal(masks[0], masks[1])


_VEC = "pyramid_vec_kernel"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,levels,wanted,offset,kernel", [
    # level 6: KSSNet's and UNet4P's tap 0 at depth 6, AHNet's ResPath by
    # 64 alone; ragged, three groups (a patch of 64 lanes), f32, offset
    (torch.bfloat16, (16, 256, 256, 32), 6, None, 0, _VEC),
    (torch.bfloat16, (16, 256, 256, 32), 6, (6,), 0, _VEC),
    (torch.bfloat16, (2, 70, 130, 16), 6, None, 0, _VEC),
    (torch.bfloat16, (3, 129, 200, 24), 6, None, 0, _VEC),
    (torch.float32, (2, 65, 97, 12), 6, (1, 3, 6), 0, _VEC),
    (torch.bfloat16, (2, 130, 66, 16), 6, (6,), 0, _VEC),
    (torch.bfloat16, (2, 128, 64, 16), 6, (6,), 8, _VEC),
    (torch.bfloat16, (2, 64, 128, 16), 6, None, 1, "pyramid_kernel"),
    (torch.bfloat16, (2, 64, 256, 31), 6, (6,), 0, "pyramid_kernel"),
    # the deep-supervision targets at levels 6-7 (a full-scale decoder
    # with d_s = 1 at depth 6-7), and at 8 on pyramid_kernel
    (torch.float32, (16, 256, 256, 1), 6, None, 0, "pyramid_c1_kernel"),
    (torch.float32, (16, 256, 256, 1), 7, None, 0, "pyramid_c1_kernel"),
    (torch.float32, (3, 200, 301, 1), 7, None, 0, "pyramid_c1_kernel"),
    (torch.bfloat16, (2, 130, 257, 1), 6, None, 0, "pyramid_c1_kernel"),
    (torch.float32, (2, 256, 256, 1), 8, None, 0, "pyramid_kernel"),
])
def test_cuda_level_6_pyramid_equals_plain_version(dtype, shape, levels,
                                                   wanted, offset, kernel):
    """The pyramid to level 6 (7 for one channel) takes its named kernel:
    one launch, counted under its name, equal to the plain version bit
    for bit on inputs with ReLU plateaus and a NaN; pyramid_kernel, which
    these calls took before, forced on the same call equals it too."""
    _need_cuda()
    x = _plateau_input(shape, 14, dtype)
    if offset:
        flat = torch.zeros(offset + x.numel(), dtype=dtype, device="cuda")
        flat[offset:] = x.permute(0, 2, 3, 1).reshape(-1)
        x = flat[offset:].view(shape).permute(0, 3, 1, 2)
    assert pyramid.route(x, levels, wanted) == kernel
    pyramid.launches.reset()
    got = pyramid.maxpool_pyramid(x, levels, wanted)
    torch.cuda.synchronize()
    assert pyramid.launches.by_kernel == {kernel: 1}
    want = pyramid.maxpool_pyramid_plain(x, levels, wanted)
    forced = pyramid._maxpool_pyramid_cuda(
        x, levels, pyramid._wanted(levels, wanted), force="pyramid_kernel")
    for k, f, w in zip(got, forced, want):
        _assert_same(k, w)
        assert torch.equal(_bits(k), _bits(w))
        assert torch.equal(_bits(f), _bits(w))


#: NHWC plants for the F = 64 backward: NaNs first, last and twice in a
#: window (the second followed by -5s), a window of -inf with a NaN last
#: (channel 4) or first (5), one of -1 with -0.0 before +0.0 (6), and a
#: zero plateau with ones in two quarters (7: row 3's comes first in
#: row-major order, row 40's in a fold of the quarters)
_PLANTS_64 = (
    ((0, 0, 0, 1), float("nan")), ((0, 63, 63, 2), float("nan")),
    ((1, 3, 4, 3), float("nan")), ((1, 40, 12, 3), float("nan")),
    ((1, 40, slice(13, 64), 3), -5.0),
    ((0, slice(0, 64), slice(0, 64), slice(4, 6)), float("-inf")),
    ((0, 63, 63, 4), float("nan")), ((0, 0, 0, 5), float("nan")),
    ((1, slice(0, 64), slice(0, 64), 6), -1.0), ((1, 5, 6, 6), -0.0),
    ((1, 5, 7, 6), 0.0), ((0, slice(0, 64), slice(64, 128), 7), 0.0),
    ((0, 40, 64, 7), 1.0), ((0, 3, 114, 7), 1.0))
_WIDE = "pool_backward_wide_kernel"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,shape,plants,kernel", [
    (torch.bfloat16, (16, 256, 256, 32), (), _WIDE),
    (torch.float32, (16, 256, 256, 32), (), _WIDE),
    (torch.bfloat16, (2, 128, 128, 32), _PLANTS_64, _WIDE),
    (torch.float32, (2, 130, 140, 8), _PLANTS_64, _WIDE),   # f32, ragged
    (torch.bfloat16, (2, 128, 64, 256), (), _WIDE),          # 2 chunks
    (torch.float32, (2, 64, 128, 40), (), _WIDE),            # 10 groups
    (torch.bfloat16, (1, 33, 40, 8), (), _WIDE),             # zeros
    (torch.float32, (2, 70, 136, 9), _PLANTS_64, _WIDE + "<V=1>"),
])
def test_cuda_pool_backward_by_64_equals_plain_version(dtype, shape, plants,
                                                       kernel):
    """The pool backward by 64 takes the wide kernel: one launch, counted
    under its name, equal to the plain version (the walk's first maximum
    in row-major order, NaN as select_and_scatter) bit for bit, zeros past
    the floor and in an input smaller than a window."""
    _need_cuda()
    x = _plateau_input(shape, 15, dtype, plants)
    b, c, h, w = x.shape
    g = torch.randn((b, c, h // 64, w // 64), generator=torch.Generator()
                    .manual_seed(16)).to("cuda", dtype).contiguous(
        memory_format=torch.channels_last)
    assert pool_backward.route(x, g, 64) == kernel
    pool_backward.launches.reset()
    got = pool_backward.maxpool_backward(x, g, 64)
    torch.cuda.synchronize()
    assert pool_backward.launches.by_kernel == {kernel: 1}
    want = pool_backward.maxpool_backward_plain(x, g, 64)
    assert torch.equal(_bits(got), _bits(want))
