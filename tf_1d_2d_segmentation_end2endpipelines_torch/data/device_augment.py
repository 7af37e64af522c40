"""On-card training augmentation (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/data/device_augment.py): the op set of the host's
``augment_pair`` (horizontal and vertical flips, rot90 on square inputs,
shift-scale-rotate, brightness and contrast on the image) on a whole
(B, H, W, C) batch on the card, image and mask under the same geometry
(the mask sampled nearest, so its label values survive; the image
bilinear with reflect-101 borders).

The random draws run on the host: ``draw_params`` takes a CPU
``torch.Generator`` keyed by ``(seed, epoch, step)``
(``augment_stream_key``) and returns each sample's coins and warp
parameters, which ``apply_augment`` then applies to the batch on its
device.  So the card and the CPU give the same batch, and a resumed run
replays the stream.  (The JAX module draws from threefry keys, whose bits
the port cannot reproduce; the transforms are held to JAX's on the same
parameters.)  The warp's trigonometry runs on the host too, where the
parameters are: the card's ``tan`` and ``sin`` may round apart from the
CPU's, and a shear shift rounded the other way would move a mask pixel;
every other op is a correctly rounded one on either side.

Two warps, as in the JAX module: the fast one (default) is the rotation as
three shears, each a per-row ``gather`` of reflect-padded rows and a blend,
then the uniform scale and shift as two per-axis resamples, each an
``einsum`` with an interpolation matrix (a nearest-index ``gather`` for the
mask); ``fast_warp=False`` is the gather reference (``_warp``, the JAX
``map_coordinates`` warp).  ``warp_mode="batch"`` draws one angle, scale
and shift a call, ``"sample"`` one a sample.
"""
from __future__ import annotations

import math
import typing as tp

import torch
import torch.nn.functional as F

from ..utils.rng import generator as _keyed_generator

Params = tp.Dict[str, torch.Tensor]


def augment_stream_key(seed: int, epoch: int, step: int) -> torch.Generator:
    """The generator of step ``step`` of epoch ``epoch`` (JAX :242-246)."""
    return _keyed_generator(seed, epoch, step)


def _round_half_away(a: torch.Tensor) -> torch.Tensor:
    """``lax.round``'s default (half away from zero), exactly."""
    t = torch.trunc(a)
    return t + torch.where((a - t).abs() >= 0.5, torch.sign(a),
                           torch.zeros_like(a))


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, i, j, c] = x[b, i, idx[b, i, j], c]``."""
    return x.gather(2, idx[..., None].expand(*idx.shape, x.shape[3]))


def _warp(x: torch.Tensor, angle: torch.Tensor, scale: torch.Tensor,
          tx: torch.Tensor, ty: torch.Tensor, order: int) -> torch.Tensor:
    """Inverse-mapped affine (rotation about the centre, scale, shift as
    fractions of the canvas) of a (B, H, W, C) batch, per-sample (B,)
    parameters: each output pixel gathers its source taps, reflect-101 at
    the borders, summed in ``map_coordinates``'s order (JAX :46-66)."""
    b, h, w, c = x.shape
    dev = x.device
    theta = torch.deg2rad(angle)[:, None, None]
    cos, sin = torch.cos(theta).to(dev), torch.sin(theta).to(dev)
    scale, tx, ty = scale.to(dev), tx.to(dev), ty.to(dev)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device), indexing="ij")
    dy = yy - cy - ty[:, None, None] * h
    dx = xx - cx - tx[:, None, None] * w
    s = scale[:, None, None]
    src_y = (cos * dy - sin * dx) / s + cy
    src_x = (sin * dy + cos * dx) / s + cx

    def nodes(coord):
        if order == 0:
            return [(_round_half_away(coord).long(), None)]
        lower = torch.floor(coord)
        upper = coord - lower
        return [(lower.long(), 1 - upper), (lower.long() + 1, upper)]

    def mirror(index, size):
        s = size - 1
        return ((index + s) % (2 * s) - s).abs()

    flat = x.reshape(b, h * w, c)
    out = None
    for iy, wy in nodes(src_y):
        for ix, wx in nodes(src_x):
            idx = (mirror(iy, h) * w + mirror(ix, w)).reshape(b, h * w, 1)
            taps = flat.gather(1, idx.expand(b, h * w, c)).reshape(b, h, w, c)
            if wy is not None:
                taps = (wy * wx)[..., None] * taps
            out = taps if out is None else out + taps
    return out


def _mirror_coords(src: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect-101 source coordinates back into [0, size - 1] (JAX :69)."""
    period = 2.0 * (size - 1)
    src = torch.fmod(src.abs(), period)
    return torch.minimum(src, period - src)


def _axis_resample_matrix(src: torch.Tensor, size: int) -> torch.Tensor:
    """(B, out, in) bilinear interpolation matrices for source coordinates
    ``src`` (B, out) (JAX :77-90, order 1)."""
    if size == 1:
        return torch.ones(*src.shape, 1, device=src.device)
    src = _mirror_coords(src, size)
    grid = torch.arange(size, dtype=torch.float32, device=src.device)
    return torch.clamp_min(1.0 - (src[..., None] - grid).abs(), 0.0)


def _nearest_index(src: torch.Tensor, size: int) -> torch.Tensor:
    """The nearest tap of each source coordinate (JAX :88, order 0: the
    one-hot row's column), rounded half to even."""
    if size == 1:
        return torch.zeros(src.shape, dtype=torch.long, device=src.device)
    return torch.round(_mirror_coords(src, size)).long()


def _scale_translate(x: torch.Tensor, scale: torch.Tensor, tx: torch.Tensor,
                     ty: torch.Tensor, order: int) -> torch.Tensor:
    """Uniform scale about the centre and shift, as two per-axis resamples
    (JAX :93-104): ``einsum``s with the bilinear matrices, or gathers of
    the nearest taps for the mask."""
    b, h, w, _ = x.shape
    scale, tx, ty = scale.to(x.device), tx.to(x.device), ty.to(x.device)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    ar_h = torch.arange(h, dtype=torch.float32, device=x.device)
    ar_w = torch.arange(w, dtype=torch.float32, device=x.device)
    src_y = (ar_h - cy - ty[:, None] * h) / scale[:, None] + cy
    src_x = (ar_w - cx - tx[:, None] * w) / scale[:, None] + cx
    if order == 0:
        iy, ix = _nearest_index(src_y, h), _nearest_index(src_x, w)
        out = x.gather(1, iy[:, :, None, None].expand(b, h, w, x.shape[3]))
        return out.gather(2, ix[:, None, :, None].expand(b, h, w,
                                                         x.shape[3]))
    out = torch.einsum("boh,bhwc->bowc", _axis_resample_matrix(src_y, h), x)
    return torch.einsum("bpw,bowc->bopc", _axis_resample_matrix(src_x, w),
                        out)


def _shear(x: torch.Tensor, m: torch.Tensor, axis: int, order: int,
           pad: int) -> torch.Tensor:
    """``out[i, j] = in[i, j + m * (i - ci)]`` along ``axis`` of a (B, H, W,
    C) batch, per-sample shear ``m`` (B,): fractional per-row shifts from
    two gathers of reflect-padded rows and a blend (JAX :107-133).  The
    shift is clipped to +-(pad - 1)."""
    if axis == 0:  # shear along H: work transposed
        return _shear(x.transpose(1, 2), m, 1, order, pad).transpose(1, 2)
    b, h, w, c = x.shape
    ci = (h - 1) / 2.0
    t = m.to(x.device)[:, None] * (torch.arange(h, dtype=torch.float32,
                                   device=x.device) - ci)
    t = torch.clamp(t, -(pad - 1.0), pad - 1.0)
    k = torch.floor(t) if order else torch.round(t)
    f = t - k
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, 0, 0),
               mode="reflect").permute(0, 2, 3, 1)
    starts = (k + pad).long()[..., None] + torch.arange(w, device=x.device)
    lo = _gather_rows(xp, starts)
    if order == 0:
        return lo
    hi = _gather_rows(xp, starts + 1)
    return lo * (1.0 - f)[..., None, None] + hi * f[..., None, None]


def _warp_fast(x: torch.Tensor, angle: torch.Tensor, scale: torch.Tensor,
               tx: torch.Tensor, ty: torch.Tensor, order: int,
               pad: int) -> torch.Tensor:
    """The rotation as three shears (Paeth), then the uniform scale and
    shift (JAX :136-152): the geometry of ``_warp``, interpolated in 1D
    steps.  The shear factors are computed where ``angle`` is."""
    theta = -torch.deg2rad(angle)
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    out = _shear(x, a, 1, order, pad)
    out = _shear(out, b, 0, order, pad)
    out = _shear(out, a, 1, order, pad)
    return _scale_translate(out, scale, tx, ty, order)


def _rot90s(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each sample turned ``k`` (B,) quarter turns, as ``np.rot90`` turns
    an (H, W, C) array (JAX :155-159)."""
    out = x
    for turns in (1, 2, 3):
        out = torch.where((k == turns)[:, None, None, None],
                          torch.rot90(x, turns, dims=(1, 2)), out)
    return out


def _pick(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor
          ) -> torch.Tensor:
    return torch.where(cond[:, None, None, None], a, b)


def warp_pad(size: tp.Tuple[int, int], max_angle: float = 30.0) -> int:
    """The reflect pad of the fast warp's shears (JAX :186-192)."""
    bound = max(math.tan(math.radians(max_angle) / 2.0),
                math.sin(math.radians(min(max_angle, 90.0))))
    return max(2, int(math.ceil(bound * max(size) / 2.0)) + 2)


def _check_warp_mode(warp_mode: str) -> None:
    if warp_mode not in ("batch", "sample"):
        raise ValueError(f"warp_mode must be 'batch' or 'sample', "
                         f"got {warp_mode!r}")


def draw_params(gen: torch.Generator, batch: int, p_flip: float = 0.5,
                p_warp: float = 0.5, p_jitter: float = 0.3,
                max_angle: float = 30.0,
                scale_range: tp.Tuple[float, float] = (0.9, 1.1),
                max_shift: float = 0.0625,
                warp_mode: str = "batch") -> Params:
    """Each sample's draws, from ``gen`` on the CPU: the flips, the
    quarter turns, the warp coin and ``angle``/``scale``/``tx``/``ty``
    (one draw for the batch under ``warp_mode="batch"``), the jitter coin
    and ``gain``/``bias`` in [0, 1) (JAX :189-227)."""
    _check_warp_mode(warp_mode)

    def u(n: int) -> torch.Tensor:
        return torch.rand(n, generator=gen)

    p = {"flip_h": u(batch) < p_flip, "flip_v": u(batch) < p_flip,
         "k": torch.randint(0, 4, (batch,), generator=gen),
         "do_warp": u(batch) < p_warp}
    warp = u(4 * (batch if warp_mode == "sample" else 1)).reshape(-1, 4)
    warp = warp.expand(batch, 4)
    p["angle"] = (warp[:, 0] * 2.0 - 1.0) * max_angle
    p["scale"] = scale_range[0] + warp[:, 1] * (scale_range[1]
                                                - scale_range[0])
    p["tx"] = (warp[:, 2] * 2.0 - 1.0) * max_shift
    p["ty"] = (warp[:, 3] * 2.0 - 1.0) * max_shift
    p["do_jit"] = u(batch) < p_jitter
    p["gain"], p["bias"] = u(batch), u(batch)
    return p


_WARP_KEYS = ("angle", "scale", "tx", "ty")


def apply_augment(images: torch.Tensor, masks: torch.Tensor, p: Params,
                  value_range: float = 1.0, fast_warp: bool = True,
                  max_angle: float = 30.0
                  ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
    """The augmentation of a (B, H, W, C) image batch and its mask batch
    under the draws ``p`` (``draw_params``), on the batch's device, in
    float32 (JAX ``one``, :189-219).  ``value_range`` is the images'
    ceiling (1 for normalized inputs, 255 for raw)."""
    dev = images.device
    # the coins go to the batch's device; the warp parameters stay where
    # they were drawn (the warps compute their trigonometry there)
    p = {k: v if k in _WARP_KEYS else v.to(dev) for k, v in p.items()}
    img = images.float()
    msk = masks.float()
    img = _pick(p["flip_h"], img.flip(2), img)
    msk = _pick(p["flip_h"], msk.flip(2), msk)
    img = _pick(p["flip_v"], img.flip(1), img)
    msk = _pick(p["flip_v"], msk.flip(1), msk)
    if img.shape[1] == img.shape[2]:  # rot90 on square inputs only
        img, msk = _rot90s(img, p["k"]), _rot90s(msk, p["k"])
    args = tuple(p[k] for k in _WARP_KEYS)
    if fast_warp:
        pad = warp_pad(img.shape[1:3], max_angle)
        img_w = _warp_fast(img, *args, 1, pad)
        msk_w = _warp_fast(msk, *args, 0, pad)
    else:
        img_w, msk_w = _warp(img, *args, 1), _warp(msk, *args, 0)
    img = _pick(p["do_warp"], img_w, img)
    msk = _pick(p["do_warp"], msk_w, msk)
    gain = (0.8 + p["gain"] * 0.4)[:, None, None, None]
    bias = (p["bias"] * 0.1 - 0.05)[:, None, None, None]
    jittered = torch.clamp(img * gain + bias * value_range, 0.0,
                           value_range)
    return _pick(p["do_jit"], jittered, img), msk


def make_device_augment(p_flip: float = 0.5, p_warp: float = 0.5,
                        p_jitter: float = 0.3, max_angle: float = 30.0,
                        scale_range: tp.Tuple[float, float] = (0.9, 1.1),
                        max_shift: float = 0.0625,
                        value_range: float = 1.0,
                        fast_warp: bool = True,
                        warp_mode: str = "batch") -> tp.Callable:
    """``fn(gen, images, masks) -> (images, masks)``: ``draw_params`` from
    the CPU generator ``gen`` (``augment_stream_key``), then
    ``apply_augment`` on the batches' device (numpy batches go to the CPU
    as tensors).  The defaults are the host ``augment_pair``'s (JAX
    :162-239)."""
    _check_warp_mode(warp_mode)

    def augment(gen: torch.Generator, images, masks):
        images, masks = torch.as_tensor(images), torch.as_tensor(masks)
        p = draw_params(gen, images.shape[0], p_flip, p_warp, p_jitter,
                        max_angle, scale_range, max_shift, warp_mode)
        return apply_augment(images, masks, p, value_range, fast_warp,
                             max_angle)

    return augment
