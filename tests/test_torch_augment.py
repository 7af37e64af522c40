"""Augmentation and patchify in the port's input pipeline against the JAX
package, on the CPU: the host ``augment_pair`` and the loader with
``augment``, ``patchify``, ``cache`` and ``set_epoch`` give JAX's batches
bit for bit; each on-card transform of ``data/device_augment.py`` (the
shears, the per-axis resamples, the fast and the gather warps, the
quarter turns and the whole augmentation) matches JAX's on the same
drawn parameters: images within 1e-5, masks equal."""
import importlib.util

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tf_1d_2d_segmentation_end2endpipelines_tpu.data import (  # noqa: E402
    device_augment as jda, generators as jgen)
from tf_1d_2d_segmentation_end2endpipelines_torch.data import (  # noqa: E402
    device_augment as da, generators, synthetic)

IMG_TOL = 1e-5
# the host augment warps with OpenCV; the on-card augment needs none
needs_cv2 = pytest.mark.skipif(importlib.util.find_spec("cv2") is None,
                               reason="augment_pair warps with OpenCV")


@needs_cv2
@pytest.mark.parametrize("shape,hi,seed", [
    ((32, 32, 3), 1.0, 0), ((32, 32, 3), 255.0, 1), ((24, 40, 1), 1.0, 2),
    ((16, 16, 3), 1.0, 3)])
def test_augment_pair_equals_jax_bit_for_bit(shape, hi, seed):
    """Every seed of a stream: the same draws in the same order, the same
    flips, turns, cv2 warp and jitter."""
    rng = np.random.default_rng(100 + seed)
    img = (rng.uniform(size=shape) * hi).astype(np.float32)
    msk = (rng.uniform(size=shape[:2] + (1,)) > 0.5).astype(np.float32)
    for s in range(12):
        got = generators.augment_pair(img, msk, np.random.default_rng(
            (seed, s)))
        want = jgen.augment_pair(img, msk, np.random.default_rng((seed, s)))
        assert np.array_equal(got[0], want[0]) and np.array_equal(
            got[1], want[1])
        assert set(np.unique(got[1])) <= {0.0, 1.0}


@pytest.mark.parametrize("augment,patchify,cache", [
    pytest.param(True, False, True, marks=needs_cv2), (False, True, False),
    pytest.param(True, True, True, marks=needs_cv2)])
def test_loader_batches_equal_jax(tmp_path, augment, patchify, cache):
    """The loader with on-the-fly augmentation (keyed by seed, epoch and
    index) and patchify (augmented whole image, then its patches, all in
    its batch) gives JAX's batches over two epochs, and again after
    ``set_epoch``."""
    x, y = synthetic.synthetic_images(5, 32, seed=4)
    synthetic.write_image_folder(str(tmp_path), x, y)
    args = (str(tmp_path), (32, 32))
    kw = dict(shuffle=True, seed=6, augment=augment, patchify=patchify,
              patch_shape=(16, 16), overlap_ratio=0.25, cache=cache)
    loader = generators.PrefetchLoader(
        generators.SegmentationFolderDataset(*args), 2, **kw)
    jloader = jgen.PrefetchLoader(jgen.SegmentationFolderDataset(*args), 2,
                                  **kw)
    for epoch in (0, 1, 5):
        if epoch == 5:
            loader.set_epoch(epoch)
            jloader.set_epoch(epoch)
        got, want = list(loader()), list(jloader())
        assert len(got) == len(want) == 3
        for (gx, gy), (wx, wy) in zip(got, want):
            assert np.array_equal(gx, wx) and np.array_equal(gy, wy)
            if patchify:
                assert gx.shape[1:3] == (16, 16)


def test_drop_remainder_says_why_no_batch_came(tmp_path):
    x, y = synthetic.synthetic_images(2, 8, seed=0)
    synthetic.write_image_folder(str(tmp_path), x, y)
    ds = generators.SegmentationFolderDataset(str(tmp_path), (8, 8))
    with pytest.raises(ValueError, match="accumulation requires full"):
        generators.PrefetchLoader(ds, 3, drop_remainder=True)()


# ------------------------------------------------- the on-card augment

B, H = 3, 32
PAD = da.warp_pad((H, H))


def _images(seed=0, c=3, h=H, w=H):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(B, h, w, c)).astype(np.float32)
    msk = rng.integers(0, 3, size=(B, h, w, 1)).astype(np.float32) / 2
    return img, msk


def _per_sample(fn, *batches_and_params):
    """JAX's per-sample function over the batch, stacked."""
    return np.stack([np.asarray(fn(*[a[i] for a in batches_and_params]))
                     for i in range(B)])


def _params(seed, warp_mode="sample"):
    return da.draw_params(torch.Generator().manual_seed(seed), B,
                          warp_mode=warp_mode)


def _check(got, want, order):
    if order:
        np.testing.assert_allclose(got.numpy(), want, atol=IMG_TOL)
    else:
        assert np.array_equal(got.numpy(), want)


def test_pad_and_resample_pieces_equal_jax():
    assert PAD == 10  # the JAX module's pad at 32x32 (max angle 30)
    rng = np.random.default_rng(3)
    src = rng.uniform(-40, 70, size=(B, H)).astype(np.float32)
    for size in (H, 7):
        mirrored = da._mirror_coords(torch.from_numpy(src), size).numpy()
        np.testing.assert_array_equal(
            mirrored, np.asarray(jda._mirror_coords(jnp.asarray(src), size)))
        want1 = _per_sample(lambda s: jda._axis_resample_matrix(s, size, 1),
                            src)
        np.testing.assert_allclose(
            da._axis_resample_matrix(torch.from_numpy(src), size).numpy(),
            want1, atol=1e-6)
        want0 = _per_sample(lambda s: jda._axis_resample_matrix(s, size, 0),
                            src)
        assert np.array_equal(
            da._nearest_index(torch.from_numpy(src), size).numpy(),
            want0.argmax(-1))


@pytest.mark.parametrize("order", [1, 0])
@pytest.mark.parametrize("axis", [1, 0])
def test_shear_equals_jax(order, axis):
    img, msk = _images(1)
    x = img if order else msk
    m = np.array([-0.5, 0.123, 0.31], np.float32)
    got = da._shear(torch.from_numpy(x), torch.from_numpy(m), axis, order,
                    PAD)
    want = _per_sample(jax.jit(lambda t, s: jda._shear(t, s, axis, order,
                                                       PAD)), x, m)
    _check(got, want, order)


@pytest.mark.parametrize("order", [1, 0])
def test_scale_translate_equals_jax(order):
    img, msk = _images(2, h=24, w=40)
    x = img if order else msk
    p = _params(5)
    args = [p[k].numpy() for k in ("scale", "tx", "ty")]
    got = da._scale_translate(torch.from_numpy(x),
                              *[torch.from_numpy(a) for a in args], order)
    want = _per_sample(jax.jit(lambda t, s, a, b: jda._scale_translate(
        t, s, a, b, order)), x, *args)
    _check(got, want, order)


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "gather"])
@pytest.mark.parametrize("order", [1, 0])
def test_warp_equals_jax(fast, order):
    img, msk = _images(3)
    x = img if order else msk
    p = _params(7)
    args = [p[k].numpy() for k in ("angle", "scale", "tx", "ty")]
    targs = [torch.from_numpy(a) for a in args]
    if fast:
        got = da._warp_fast(torch.from_numpy(x), *targs, order, PAD)
        fn = jax.jit(lambda t, a, s, u, v: jda._warp_fast(t, a, s, u, v,
                                                          order, PAD))
    else:
        got = da._warp(torch.from_numpy(x), *targs, order)
        fn = jax.jit(lambda t, a, s, u, v: jda._warp(t, a, s, u, v, order))
    _check(got, _per_sample(fn, x, *args), order)
    if not order:
        assert set(np.unique(got.numpy())) <= set(np.unique(x))


def test_rot90s_equal_jax():
    img, _ = _images(4)
    k = np.array([1, 2, 3], np.int32)
    got = da._rot90s(torch.from_numpy(img), torch.from_numpy(k).long())
    want = _per_sample(jax.jit(jda._rot90s), img, k)
    assert np.array_equal(got.numpy(), want)


def _jax_apply(img, msk, p, value_range, fast):
    """JAX's per-sample ``one`` (device_augment.py:189-219) with the given
    draws instead of its key's."""
    out_i, out_m = [], []
    for i in range(B):
        im, ms = jnp.asarray(img[i]), jnp.asarray(msk[i])
        if p["flip_h"][i]:
            im, ms = im[:, ::-1], ms[:, ::-1]
        if p["flip_v"][i]:
            im, ms = im[::-1], ms[::-1]
        k = jnp.int32(int(p["k"][i]))
        im, ms = jda._rot90s(im, k), jda._rot90s(ms, k)
        a = [jnp.float32(float(p[n][i]))
             for n in ("angle", "scale", "tx", "ty")]
        if p["do_warp"][i]:
            if fast:
                im = jda._warp_fast(im, *a, 1, PAD)
                ms = jda._warp_fast(ms, *a, 0, PAD)
            else:
                im, ms = jda._warp(im, *a, 1), jda._warp(ms, *a, 0)
        if p["do_jit"][i]:
            gain, bias = (jnp.float32(float(p["gain"][i])),
                          jnp.float32(float(p["bias"][i])))
            im = jnp.clip(im * (0.8 + gain * 0.4)
                          + (bias * 0.1 - 0.05) * value_range,
                          0.0, value_range)
        out_i.append(np.asarray(im))
        out_m.append(np.asarray(ms))
    return np.stack(out_i), np.stack(out_m)


@pytest.mark.parametrize("seed,warp_mode,fast,value_range", [
    (0, "batch", True, 1.0), (1, "sample", True, 255.0),
    (2, "sample", False, 1.0)])
def test_apply_augment_equals_jax_on_the_same_draws(seed, warp_mode, fast,
                                                    value_range):
    img, msk = _images(10 + seed)
    img = img * np.float32(value_range)
    p = da.draw_params(torch.Generator().manual_seed(seed), B,
                       p_warp=0.7, p_jitter=0.7, warp_mode=warp_mode)
    if warp_mode == "batch":
        assert len(set(p["angle"].tolist())) == 1
    got_i, got_m = da.apply_augment(torch.from_numpy(img),
                                    torch.from_numpy(msk), p,
                                    value_range=value_range, fast_warp=fast)
    want_i, want_m = _jax_apply(img, msk, p, value_range, fast)
    np.testing.assert_allclose(got_i.numpy(), want_i,
                               atol=IMG_TOL * value_range)
    assert np.array_equal(got_m.numpy(), want_m)
    assert set(np.unique(got_m.numpy())) <= set(np.unique(msk))


def test_device_augment_stream_is_keyed_and_reproducible():
    """The same (seed, epoch, step) gives the same batch; another step
    another; the draws come from the host generator, not the batch."""
    img, msk = _images(20)
    fn = da.make_device_augment()
    a = fn(da.augment_stream_key(1, 2, 3), img, msk)
    b = fn(da.augment_stream_key(1, 2, 3), img, msk)
    c = fn(da.augment_stream_key(1, 2, 4), img, msk)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0])
    with pytest.raises(ValueError, match="warp_mode"):
        da.make_device_augment(warp_mode="pixel")


def test_stream_seeds_are_distinct():
    from tf_1d_2d_segmentation_end2endpipelines_torch.utils.rng import (
        stream_seed)
    seeds = {stream_seed(s, e, i) for s in range(3) for e in range(3)
             for i in range(3)}
    assert len(seeds) == 27 and all(0 <= s < 2 ** 63 for s in seeds)
