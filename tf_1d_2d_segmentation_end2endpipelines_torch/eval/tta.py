"""Test-time augmentation: average the predictions over invertible views
of a batch: flips and quarter turns of an NHWC batch, the length reversal
of a 1D (B, L, C) one (JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/
eval/tta.py:1-121; ``TTA_1D`` :61-72, ``parse_tta(rank=1)`` :110).

The views are layout moves, so each prediction maps back exactly.  The
JAX package runs one forward per view inside one compiled program; here
the views are stacked into one batch and run as one forward (BatchNorm is
in eval mode, so each image's prediction does not depend on the others):
a batch with V views launches each kernel of the forward once, as a batch
without views does, on a batch (1 + V) times as large.
"""
from __future__ import annotations

import typing as tp

import torch

__all__ = ["TTA_1D", "TTA_2D", "make_tta_fn", "parse_tta"]

View = tp.Callable[[torch.Tensor], torch.Tensor]


def _flip(*dims: int) -> tp.Tuple[View, View]:
    def t(x: torch.Tensor) -> torch.Tensor:
        return torch.flip(x, dims=dims)
    return t, t


def _rot(k: int) -> tp.Tuple[View, View]:
    # the spatial axes of NHWC, turned k times forward and -k back
    def fwd(x: torch.Tensor) -> torch.Tensor:
        return torch.rot90(x, k, dims=(1, 2))

    def inv(x: torch.Tensor) -> torch.Tensor:
        return torch.rot90(x, -k, dims=(1, 2))
    return fwd, inv


#: name -> (forward, inverse) view of an NHWC tensor.  rot90 and rot270
#: need square inputs: on others they change the shape (parse_tta refuses
#: them there).
TTA_2D: tp.Dict[str, tp.Tuple[View, View]] = {
    "hflip": _flip(2),
    "vflip": _flip(1),
    "hvflip": _flip(1, 2),
    "rot90": _rot(1),
    "rot180": _rot(2),
    "rot270": _rot(3),
}


#: 1D signals (B, L, C): only the length reversal is geometric
TTA_1D: tp.Dict[str, tp.Tuple[View, View]] = {
    "flip": _flip(1),
}


def parse_tta(spec: str, square: bool = True, rank: int = 2
              ) -> tp.Tuple[str, ...]:
    """The views an INI ``tta`` value names (``'hflip, vflip'``; 1D,
    ``rank`` 1: ``'flip'``): ``''`` or ``'none'`` none, ``'all'`` every
    view the input shape allows.  Raises ``ValueError`` on an unknown
    name, and on rot90/rot270 when the input is not square."""
    table = TTA_2D if rank == 2 else TTA_1D
    spec = (spec or "").strip().lower()
    if spec in ("", "none", "0", "false"):
        return ()
    if spec in ("all", "1", "true"):
        return tuple(n for n in table if square or not n.startswith("rot"))
    names = []
    for part in spec.replace(";", ",").split(","):
        name = part.strip()
        if not name:
            continue
        if name not in table:
            raise ValueError(f"unknown TTA transform {name!r}; expected one "
                             f"of {sorted(table)} (rank {rank})")
        if name in ("rot90", "rot270") and not square:
            raise ValueError(
                f"TTA {name!r} requires square inputs (a 90-degree rotation "
                "of a non-square batch changes its shape)")
        names.append(name)
    return tuple(names)


def make_tta_fn(predict_fn: tp.Callable[[torch.Tensor],
                                        tp.Dict[str, torch.Tensor]],
                transforms: tp.Sequence[str], rank: int = 2
                ) -> tp.Callable[[torch.Tensor], tp.Dict[str, torch.Tensor]]:
    """Wrap ``predict_fn`` (an NHWC batch -> a dict of NHWC heads; at
    ``rank`` 1 (B, L, C)) so that each head is the mean over the identity
    and ``transforms``: the identity's prediction, plus each view's mapped
    back, in the order given, divided by ``1 + len(transforms)`` (the JAX
    order of sums).  Every view of the batch goes through one
    ``predict_fn`` call."""
    table = TTA_2D if rank == 2 else TTA_1D
    pairs = [table[name] for name in transforms]
    if not pairs:
        return predict_fn

    def fn(x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        b = x.shape[0]
        preds = predict_fn(torch.cat([x] + [fwd(x) for fwd, _ in pairs]))
        out = {}
        for key, p in preds.items():
            acc = p[:b]
            for v, (_, inv) in enumerate(pairs, 1):
                acc = acc + inv(p[v * b:(v + 1) * b])
            out[key] = acc / (1.0 + len(pairs))
        return out
    return fn
