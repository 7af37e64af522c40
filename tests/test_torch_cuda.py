"""Tests that need an NVIDIA GPU (``cuda`` marker); they skip elsewhere.

This file imports torch and the port only, so it runs on a machine
without JAX:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pyramid)


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
    before = pyramid.launches
    got = pyramid.maxpool_pyramid(x, levels)
    torch.cuda.synchronize()
    assert pyramid.launches == before + 1
    for k, w in zip(got, pyramid.maxpool_pyramid_plain(x, levels)):
        assert k.shape == w.shape
        assert torch.equal(k.nan_to_num(7.0), w.nan_to_num(7.0))
        assert torch.equal(k.isnan(), w.isnan())


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


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
        before = pyramid.launches
        with torch.inference_mode():
            gpu = model(x.cuda())["out"].cpu()
        assert pyramid.launches == before + 3
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert float((gpu - cpu).abs().max()) <= 1e-4
