"""chip_smoke.py's tables of the 1D pool calls of phases 33 and 35
(``_deep_calls``: UNet3P, R2UNet3P, SelfUNet3P, ConvMixerUNet3P and
MLMRSNet_V2 at depth 6 and 7, UNet4P at depth 7 and 8, UNet3P at depth 5
and 6 with ``d_s = 1``) against the calls the models make in one CPU train
step at a small size (W4, (2, 256, 1) signals), counted as multisets:
the phases hold each path's launches to the table's length, and phase 3
times every call in it.  Also the tables of config 1's depth: MLMRSNet_V2
and UNet4P at depth 3, whose calls phase 30 and 26 list by hand.  And the
2D tables of phase 34 (``_deep_2d_fwd``: KSSNet, UNet4P, UNet4PV2, AHNet
at depth 6, UNet3P with ``d_s = 1``, MultiResUNet3P, SelfUNet3P at depth
7) against one CPU step of each model at W2 on (1, 128, 128, 3)."""
import collections
from unittest import mock

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    prepare_train_dict)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    pyramid as data_pyramid)
from tf_1d_2d_segmentation_end2endpipelines_torch.models import (  # noqa: E402
    SegModel, model_selector_1d)
from tf_1d_2d_segmentation_end2endpipelines_torch.ops.kernels import (  # noqa: E402
    pool_backward, pyramid)

L, B, W = 256, 2, 4


def _recorded(arch, depth, ds):
    """The 1D pyramid and backward calls of one forward and backward of
    ``arch`` (and, with ``ds``, of its targets), as chip_smoke's tuples."""
    fwd, bwd = [], []
    pyr, back = pyramid.maxpool1d_pyramid, pool_backward.maxpool1d_backward

    def rec_fwd(x, levels, wanted=None):
        b, c, _, n = x.shape
        fwd.append((str(x.dtype)[6:], (b, n, c), levels,
                    tuple(pyramid._wanted(levels, wanted))))
        return pyr(x, levels, wanted)

    def rec_bwd(x, g, factor):
        b, c, _, n = x.shape
        bwd.append((str(x.dtype)[6:], (b, n, c), factor))
        return back(x, g, factor)

    model = model_selector_1d(arch, L, depth, 1, W, 3, ds=ds,
                              generator=torch.Generator().manual_seed(0))
    with mock.patch.object(pyramid, "maxpool1d_pyramid", rec_fwd), \
            mock.patch.object(data_pyramid, "maxpool1d_pyramid", rec_fwd), \
            mock.patch.object(pyramid, "maxpool1d_backward", rec_bwd):
        out = model(torch.randn(B, L, 1))
        sum(v.float().sum() for v in out.values()).backward()
        if ds:
            prepare_train_dict(torch.zeros(B, L, 1), depth, "UNet",
                               spatial_rank=1)
    return fwd, bwd


@pytest.mark.parametrize("arch,depth,ds", [
    *[(a, d, 0) for a, d in chip_smoke.DEEP_1D.values()],
    *[(a, d, kw.get("d_s", 0)) for a, d, kw in
      chip_smoke.DEEP_1D_VERBS.values()],
    ("MLMRSNet_V2", 3, 0), ("UNet4P", 3, 0),
    *[(a, d, 0) for a, d in chip_smoke.DEEPER_1D.values()],
    *[(a, d, kw.get("d_s", 0)) for a, d, kw in
      chip_smoke.DEEPER_1D_VERBS.values()]])
def test_deep_call_tables_equal_the_models_calls(arch, depth, ds):
    want_fwd, want_bwd = chip_smoke._deep_calls(arch, depth, ds, batch=B,
                                                length=L, width=W)
    got_fwd, got_bwd = _recorded(arch, depth, ds)
    assert collections.Counter(got_fwd) == collections.Counter(want_fwd)
    assert collections.Counter(got_bwd) == collections.Counter(want_bwd)


def test_phase_33_paths_are_in_the_tables():
    for path, (arch, depth) in chip_smoke.DEEP_1D.items():
        fwd, bwd = chip_smoke._deep_calls(arch, depth)
        assert chip_smoke.FWD_PATHS_1D[path] == fwd
        assert chip_smoke.BWD_PATHS_1D[path] == bwd
        assert max(lvl for c in fwd for lvl in c[3]) == 5
    (path, (arch, depth, kw)), = chip_smoke.DEEP_1D_VERBS.items()
    assert chip_smoke._SIG_DS_MASK5 in chip_smoke.FWD_PATHS_1D[path]


def test_phase_35_paths_are_in_the_tables():
    for path, (arch, depth) in chip_smoke.DEEPER_1D.items():
        fwd, bwd = chip_smoke._deep_calls(arch, depth)
        assert chip_smoke.FWD_PATHS_1D[path] == fwd
        assert chip_smoke.BWD_PATHS_1D[path] == bwd
        assert max(lvl for c in fwd for lvl in c[3]) == 6
        assert max(c[2] for c in bwd) == 64
    (path, (arch, depth, kw)), = chip_smoke.DEEPER_1D_VERBS.items()
    assert chip_smoke._SIG_DS_MASK6 in chip_smoke.FWD_PATHS_1D[path]


S2, W2 = 128, 2


def _recorded_2d(dec, depth, ds):
    """The 2D pyramid and backward calls of one forward and backward of
    ``dec`` at ``depth`` (and, with ``ds``, of its targets), as
    chip_smoke's tuples.  The model runs in float32 (bfloat16 is slow on
    the CPU) and its calls are recorded as the phase's bfloat16 ones, the
    targets' (one channel) as float32."""
    fwd, bwd = [], []
    pyr, back = pyramid.maxpool_pyramid, pyramid.maxpool_backward

    def dtype(c):
        return "float32" if c == 1 else "bfloat16"

    def rec_fwd(x, levels, wanted=None):
        b, c, h, w = x.shape
        fwd.append((dtype(c), (b, h, w, c), levels,
                    tuple(pyramid._wanted(levels, wanted))))
        return pyr(x, levels, wanted)

    def rec_bwd(x, g, factor):
        b, c, h, w = x.shape
        bwd.append((dtype(c), (b, h, w, c), factor))
        return back(x, g, factor)

    model = SegModel(dec, W2, depth, ds=ds,
                     generator=torch.Generator().manual_seed(0))
    with mock.patch.object(pyramid, "maxpool_pyramid", rec_fwd), \
            mock.patch.object(pyramid, "maxpool_backward", rec_bwd):
        out = model(torch.rand(1, S2, S2, 3) * 0.3)
        sum(v.float().sum() for v in out.values()).backward()
        if ds:
            prepare_train_dict(torch.zeros(1, S2, S2, 1), depth, "UNet")
    return fwd, bwd


@pytest.mark.parametrize("path", list(chip_smoke.DEEP_2D))
def test_deep_2d_call_tables_equal_the_models_calls(path):
    dec, depth, kw = chip_smoke.DEEP_2D[path]
    want_fwd = chip_smoke._deep_2d_fwd(path, batch=1, size=S2, width=W2)
    got_fwd, got_bwd = _recorded_2d(dec, depth, kw.get("ds", 0))
    assert collections.Counter(got_fwd) == collections.Counter(want_fwd)
    assert collections.Counter(got_bwd) == collections.Counter(
        chip_smoke._backward_of(want_fwd))
    assert chip_smoke.FWD_PATHS[path] == chip_smoke._deep_2d_fwd(path)
    assert max(lvl for c in want_fwd if c[1][-1] > 1 for lvl in c[3]) == 6
