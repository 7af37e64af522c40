"""The 1D model API of the port (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/models/api_1d.py): ``SegModel1D`` (:95), the
``UNet1D`` facade (:334) and ``model_selector_1d`` (:395).

Ported: the ``UNet1D`` archs ``UNet``, ``UNetE``, ``UNetP``, ``UNetPP``,
``UNet3P`` and ``MultiResUNet``, with deep supervision (``ds``), attention
gates (``ag``), transposed convs or nearest upsampling, any kernel size
and ``alpha``; and the special families ``BCDUNet``, ``SEDUNet``,
``IBAUNet`` and ``NABNet`` (models/specials_1d.py), with ``lstm``,
``dense_loop`` and ``se_ratio``.  The other archs and families, ``lstm =
1`` on a ``UNet1D`` arch and ``ae = 1`` raise ``NotImplementedError``
naming what is missing.

The 1D tree differs from the 2D one (JAX api_1d.py:1-13): two ConvBlocks
an encoder level and a decoder node (one for UNet3+ and MultiRes nodes),
*D* pools (after every encoder level), the latent on the last pool, the
2-wide transposed conv with BatchNorm and ReLU, nearest upsampling, and a
softmax head for ``Classification``, a linear one for ``Regression``.

Inside, a signal is a (B, C, 1, L) tensor in channels_last memory: the
JAX package's NLC buffer (ops/blocks.py).  The blocks are direct children
with flax's auto-names, as ``SegModel1D`` creates them inline:
``ConvBlock_0 .. ConvBlock_{2D+1}`` (encoder and latent) or
``MultiResBlock_<i>`` / ``ResPath_<i>``, then ``ChainDecoder_0``,
``GridDecoder_0`` or ``FullScaleDecoder_0``, then ``out``.
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import (ConvBlock, HeadConv, MultiResBlock, ResPath,
                   apply_activation, downsample_pool)
from .decoders import ChainDecoder, FullScaleDecoder, GridDecoder
from .specials_1d import (SPECIAL_ARCHS_1D, BCDUNet, IBAUNet, NABNet,
                          SEDUNet)

#: every arch name of the JAX ``UNet1D`` (api_1d.py:48-90)
ARCH_NAMES_1D = (
    "UNet", "UNetE", "UNetP", "UNetPP", "UNet3P", "UNet4P", "MultiResUNet",
    "MultiResUNet3P", "RUNet", "R2UNet", "R2UNetPP", "R2UNet3P",
    "SelfR2UNetPP", "SelfUNetPP", "SelfUNet3P", "ConvMixerUNet",
    "ConvMixerUNetE", "ConvMixerUNetP", "ConvMixerUNetPP", "ConvMixerUNet3P",
    "ConvMixerMultiResUNet")

#: the ported archs: decoder topology, node ConvBlocks, MultiRes blocks
_ARCHS: tp.Dict[str, tp.Dict[str, tp.Any]] = {
    "UNet": dict(topo="chain", reps=2),
    "UNetE": dict(topo="grid", variant="E", reps=2),
    "UNetP": dict(topo="grid", variant="P", reps=2),
    "UNetPP": dict(topo="grid", variant="PP", reps=2),
    "UNet3P": dict(topo="full", reps=1),
    "MultiResUNet": dict(topo="chain", reps=1, multires=True),
}

#: the names ``model_selector_1d`` builds: ``SegModel1D``'s archs and
#: the special families of models/specials_1d.py
PORTED_ARCHS_1D = tuple(_ARCHS) + SPECIAL_ARCHS_1D
_SPECIALS = {"BCDUNet": BCDUNet, "SEDUNet": SEDUNet, "IBAUNet": IBAUNet,
             "NABNet": NABNet}

#: the special 1D families' method names (JAX api_1d.py:420-480)
SPECIAL_NAMES_1D = (
    "BCDUNet", "SEDUNet", "IBAUNet", "NABNet", "MLMRSNet", "MLMRSNet_V2",
    "LDNet", "SAUNet", "SAMultiResUNet", "SelfSAUNet", "Dense_Inception_UNet",
    "TernausNet11", "TernausNet13", "TernausNet16", "TernausNet19",
    "AlbUNet18", "AlbUNet34", "AlbUNet50", "AlbUNet101", "AlbUNet152",
    "LinkNet", "LinkNetE", "LinkNetP", "LinkNetPP", "MultiResLinkNet", "FPN")


def check_arch_1d(arch: str, ae: int = 0, lstm: int = 0) -> None:
    """Raise for what ``model_selector_1d`` does not build:
    ``ValueError`` for a name the JAX package does not know either,
    ``NotImplementedError`` naming an arch, a special family, ``lstm =
    1`` on a ``UNet1D`` arch or ``ae = 1`` the port lacks."""
    if arch not in ARCH_NAMES_1D and arch not in SPECIAL_NAMES_1D:
        raise ValueError(
            f"unknown 1D architecture {arch!r}; expected one of "
            f"{sorted(ARCH_NAMES_1D)} or a special-family method name")
    if arch not in PORTED_ARCHS_1D:
        raise NotImplementedError(
            f"1D architecture {arch!r} is not ported yet (ported: "
            f"{', '.join(PORTED_ARCHS_1D)})")
    if lstm and arch in _ARCHS:
        raise NotImplementedError("1D models with lstm = 1 (ConvLSTM "
                                  "fusion) are not ported yet")
    if ae:
        raise NotImplementedError("1D models with ae = 1 (the autoencoder "
                                  "bottleneck) are not ported yet")


class SegModel1D(nn.Module):
    """Config-driven 1D segmentation network (JAX ``SegModel1D``).

    ``forward`` takes a (B, L, C) batch, as the JAX module does, casts it
    to ``dtype`` and returns ``{"out": (B, L, output_nums)}`` in ``dtype``
    (softmax over the channels for ``Classification``, linear for
    ``Regression``), plus ``level1`` .. ``levelD`` (the deep-supervision
    heads) when ``ds == 1``.  Parameters are float32 and drawn from
    ``generator``; BatchNorm in training mode uses the batch statistics.
    ``in_channels`` sizes the first conv (flax infers it from the input).
    ``init_kwargs`` keeps the constructor's arguments, so
    ``reinitialized`` can draw a fresh model of the same architecture."""

    def __init__(self, arch: str, model_width: int, model_depth: int,
                 kernel_size: int = 3, problem_type: str = "Regression",
                 output_nums: int = 1, ds: int = 0, ae: int = 0, ag: int = 0,
                 lstm: int = 0, alpha: float = 1.0, in_channels: int = 1,
                 is_transconv: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items()
                            if k not in ("self", "generator", "__class__")}
        check_arch_1d(arch, ae=ae, lstm=lstm)
        if arch not in _ARCHS:
            raise ValueError(f"{arch!r} is a special family: "
                             "model_selector_1d builds it")
        if model_depth < 1:
            raise ValueError("The depth of the model cannot be less than 1")
        cfg = _ARCHS[arch]
        W, D, k = model_width, model_depth, kernel_size
        self.arch = arch
        self.model_depth = D
        self.multires = cfg.get("multires", False)
        self.problem_type = problem_type
        self.dtype = dtype
        kw = dict(dtype=dtype, generator=generator, rank=1)
        cin = in_channels
        # encoder: D levels, each pooled; then the latent on the last pool
        for i in range(1, D + 1):
            feats = W * 2 ** (i - 1)
            if self.multires:
                block = MultiResBlock(cin, W, k, alpha=alpha,
                                      multiplier=feats // W, **kw)
                self.add_module(f"MultiResBlock_{i - 1}", block)
                self.add_module(f"ResPath_{i - 1}", ResPath(
                    block.out_features, D - i + 1, feats, k, **kw))
                cin = block.out_features
            else:
                self.add_module(f"ConvBlock_{2 * i - 2}",
                                ConvBlock(cin, feats, k, **kw))
                self.add_module(f"ConvBlock_{2 * i - 1}",
                                ConvBlock(feats, feats, k, **kw))
                cin = feats
        feats = W * 2 ** D
        if self.multires:
            self.add_module(f"MultiResBlock_{D}", MultiResBlock(
                cin, W, k, alpha=alpha, multiplier=2 ** D, **kw))
        else:
            self.add_module(f"ConvBlock_{2 * D}", ConvBlock(cin, feats, k, **kw))
            self.add_module(f"ConvBlock_{2 * D + 1}",
                            ConvBlock(feats, feats, k, **kw))
        common = dict(model_width=W, model_depth=D, D_S=ds, A_G=ag,
                      is_transconv=is_transconv, alpha=alpha, dtype=dtype,
                      generator=generator, kernel=k,
                      conv_repeats=cfg["reps"], dialect="1d")
        if cfg["topo"] == "chain":
            decoder: nn.Module = ChainDecoder(
                style="multires" if self.multires else "unet", **common)
        elif cfg["topo"] == "grid":
            decoder = GridDecoder(variant=cfg["variant"], **common)
        else:
            decoder = FullScaleDecoder(multires=False, **common)
        self._decoder_name = f"{type(decoder).__name__}_0"
        self.add_module(self._decoder_name, decoder)
        self.out = HeadConv(decoder.out_features, output_nums, dtype=dtype,
                            generator=generator)

    def reinitialized(self, generator: torch.Generator) -> "SegModel1D":
        """A new model of this architecture with weights drawn from
        ``generator``."""
        return type(self)(**self.init_kwargs, generator=generator)

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        D = self.model_depth
        # a fresh channels_last (B, C, 1, L) copy in the compute dtype:
        # (B, L, C) memory, whatever strides the caller's batch has
        x = x.permute(0, 2, 1).unsqueeze(2)
        x = torch.empty(x.shape, dtype=self.dtype, device=x.device,
                        memory_format=torch.channels_last).copy_(x)
        taps: tp.List[torch.Tensor] = []
        pool = x
        for i in range(1, D + 1):
            if self.multires:
                conv = getattr(self, f"MultiResBlock_{i - 1}")(pool)
                taps.append(getattr(self, f"ResPath_{i - 1}")(conv))
            else:
                conv = getattr(self, f"ConvBlock_{2 * i - 2}")(pool)
                conv = getattr(self, f"ConvBlock_{2 * i - 1}")(conv)
                taps.append(conv)
            pool = downsample_pool(conv, 2, op="max", rank=1)
        if self.multires:
            latent = getattr(self, f"MultiResBlock_{D}")(pool)
        else:
            latent = getattr(self, f"ConvBlock_{2 * D + 1}")(
                getattr(self, f"ConvBlock_{2 * D}")(pool))
        deconv, levels = getattr(self, self._decoder_name)(taps + [latent])
        out = self.out(deconv)
        if self.problem_type == "Classification":
            out = apply_activation(out, "softmax")
        outputs = {"out": out[:, :, 0].permute(0, 2, 1)}
        # the reference's order: out, then levelD .. level1
        for idx, lvl in enumerate(levels):
            outputs[f"level{D - idx}"] = lvl[:, :, 0].permute(0, 2, 1)
        return outputs


class UNet1D:
    """Facade with the reference's constructor and method names (JAX
    api_1d.py:334-356, 1DCNN/Models/unet_variants.py:222-253): each
    method returns a configured ``SegModel1D``; an arch the port lacks
    raises ``NotImplementedError``.  ``generator`` draws the weights."""

    def __init__(self, length, model_depth, num_channel, model_width,
                 kernel_size, problem_type="Regression", output_nums=1,
                 ds=1, ae=0, ag=0, lstm=0, alpha=1, t=2,
                 feature_number=1024, is_transconv=True, q=3,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        if (length == 0 or model_depth == 0 or model_width == 0
                or num_channel == 0 or kernel_size == 0):
            raise ValueError("Please Check the Values of the Input Parameters!")
        self.length = length
        self.num_channel = num_channel
        self._kw = dict(model_width=model_width, model_depth=model_depth,
                        kernel_size=kernel_size, problem_type=problem_type,
                        output_nums=output_nums, ds=ds, ae=ae, ag=ag,
                        lstm=lstm, alpha=alpha, in_channels=num_channel,
                        is_transconv=is_transconv, dtype=dtype,
                        generator=generator)

    def _build(self, arch: str) -> SegModel1D:
        return SegModel1D(arch=arch, **self._kw)


for _name in ARCH_NAMES_1D:
    setattr(UNet1D, _name, (lambda self, _n=_name: self._build(_n)))


def model_selector_1d(arch: str, length: int, model_depth: int,
                      num_channel: int, model_width: int, kernel_size: int,
                      problem_type: str = "Regression", output_nums: int = 1,
                      ds: int = 0, ae: int = 0, ag: int = 0, lstm: int = 0,
                      alpha: float = 1.0, t: int = 2, q: int = 3,
                      dense_loop: int = 2, feature_number: int = 1024,
                      is_transconv: bool = True, cardinality: int = 5,
                      pooling_type: str = "avg", se_ratio: int = 16,
                      block_size: int = 7, keep_prob: float = 0.9,
                      dtype: torch.dtype = torch.float32,
                      generator: tp.Optional[torch.Generator] = None
                      ) -> nn.Module:
    """Name-string dispatch over the 1D zoo with the JAX
    ``model_selector_1d``'s surface (api_1d.py:395).  The ported archs
    build a ``SegModel1D``, the four ported special families their model
    (``dense_loop``, ``se_ratio``, ``lstm`` and ``ag`` as JAX
    api_1d.py:424-434 passes them); the other names raise
    ``NotImplementedError`` naming them, and an unknown name raises the
    JAX package's ``ValueError``.  ``length`` is accepted for parity (the
    model takes any length); ``t``, ``q``, ``feature_number``,
    ``cardinality``, ``pooling_type``, ``block_size`` and ``keep_prob``
    configure only unported families."""
    if arch in _SPECIALS:
        check_arch_1d(arch, ae=ae, lstm=lstm)
        return _SPECIALS[arch](
            model_width=model_width, model_depth=model_depth,
            kernel_size=kernel_size, problem_type=problem_type,
            output_nums=output_nums, ds=ds, ae=ae, ag=ag, lstm=lstm,
            dense_loop=dense_loop, se_ratio=se_ratio,
            in_channels=num_channel, is_transconv=is_transconv, dtype=dtype,
            generator=generator)
    return UNet1D(length, model_depth, num_channel, model_width,
                  kernel_size, problem_type=problem_type,
                  output_nums=output_nums, ds=ds, ae=ae, ag=ag, lstm=lstm,
                  alpha=alpha, t=t, feature_number=feature_number,
                  is_transconv=is_transconv, q=q, dtype=dtype,
                  generator=generator)._build(arch)
