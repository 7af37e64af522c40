"""Top-level segmentation model of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/segmodel.py).

Every (decoder, encoder) pair of the JAX ``SegModel``: the UNet and FPN
genres, with or without deep supervision, with each of the 16 decoders
of ``decoders.build_decoder`` (UNet, UNetE, UNetP, UNet++, UNet3+,
UNet4P, UNet4PV2, AHNet, MultiResUNet, MultiResUNet3+, KSSNet, FPN and
the Self-ONN SelfUNet, SelfUNetPP, SelfUNet3P and SelfFPN), attention
gates and ConvLSTM fusion on the chains and grids, the autoencoder
bottleneck; the encoder from scratch or, ``train_mode =
"pretrained_encoder"``, any of the 33 backbones (``backbones``) with
every branch of the tap projectors, or the FPN genre's.
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import (ConvBlock, FeatureExtractionBlock, HeadConv, Oper,
                   apply_activation, pooled_size, set_block_remat)
from ..ops.kernels import pool_backward, pyramid
from .decoders import build_decoder
from .backbones import get_backbone
from .encoders import (DENSE_INPUT_FAMILIES, LatentLayer,
                       PretrainedTapProjector, ScratchEncoder)


#: the decoders that pool encoder tap 0 to level D - 1 (JAX
#: ``FullScaleDecoder``, ``SelfFullScaleDecoder``)
_FULL_SCALE = ("UNet3P", "UNet4PV2", "MultiResUNet3P", "SelfUNet3P")


def deepest_pool(decoder_name: str, depth: int, pretrained: bool) -> int:
    """The deepest level m of the max pools by 2**m the model runs: D for
    a from-scratch KSSNet, UNet4P, UNet4PV2 or AHNet encoder (tap 1 to
    the bottom), D - 1 for a full-scale decoder (tap 1 to the deepest
    step), else 1 (a pretrained model's gated projectors pool by 16 at
    most)."""
    level = 1
    if not pretrained and (decoder_name == "KSSNet"
                           or decoder_name in DENSE_INPUT_FAMILIES):
        level = depth
    if decoder_name in _FULL_SCALE:
        level = max(level, depth - 1)
    return level


class SegModel(nn.Module):
    """Config-driven segmentation network (JAX ``SegModel``).

    ``forward`` takes an NHWC batch, as the JAX module does, casts it to
    ``dtype`` and returns ``{"out": NHWC tensor}`` in ``dtype``, plus
    ``level1`` .. ``levelD`` (the deep-supervision heads, no activation)
    when ``ds == 1``.  Parameters are float32 and drawn from
    ``generator`` (a CPU ``torch.Generator``).
    In training mode BatchNorm uses the batch statistics, as the JAX
    module's ``__call__(train=True)`` does; the head's activation runs in
    ``dtype`` (bf16 under bf16), and a caller casts the outputs to float32
    before the loss (JAX: train/state.py:157).  ``alpha`` scales the
    MultiRes blocks' widths.  ``block_remat`` rematerializes the blocks
    one by one in training (``remat = blocks``; JAX segmodel.py:67-73),
    with the same ``state_dict`` keys.  ``init_kwargs`` keeps the
    constructor's arguments, so ``reinitialized`` can draw a fresh model
    of the same architecture.  ``ae = 1`` (from scratch) puts the
    autoencoder bottleneck after the latent (``FeatureExtractionBlock_0``,
    W * 2**D wide, ``feature_number`` features; JAX segmodel.py:141-143),
    sized by ``input_size``, the (H, W) of the images it takes (on a
    backbone, by the grid of its tap at depth D for such an image, found
    by one forward of a zero image through it when the model is built).

    ``train_mode = "pretrained_encoder"`` (depth 1 to 5) encodes with the
    ``backbone`` named (``<Backbone>_0``, its taps 0 .. min(D, 5)), each
    tap but the deepest at depth 5 projected to its level's width
    (``PretrainedTapProjector_<k>``, min(D + 1, 5) of them, each on the
    decoder's branch; the gated ones of KSSNet and UNet4P/UNet4PV2 read
    the shallower projected taps' max pools, each tap pooled to every
    level a deeper projector reads by one ``pyramid.maxpool_levels``
    launch, AHNet's the taps themselves); the latent reads projected tap
    D, or at depth 5 the backbone's raw top (JAX segmodel.py:76-125).
    ``backbone_trainable`` False keeps the backbone's BatchNorms on their
    running statistics in training (each backbone's ``trainable``); its
    parameters still train.

    ``genre = "FPN"`` has no latent layer: the decoder's bottleneck is the
    encoder's deepest output (JAX segmodel.py:133-140); on a pretrained
    backbone its taps are projected by 1x1 convs with ReLU and no
    BatchNorm (``ConvBlock_<k>``; ``Oper_<k>`` for a Self-ONN decoder)
    instead of the tap projectors (segmodel.py:109-118).  A Self-ONN
    decoder (``Self*``) makes the encoder, latent and projectors Self-ONN
    ones of order ``q``, and the head ``out`` an ``Oper(1, 1)`` with the
    final activation (segmodel.py:156-158)."""

    def __init__(self, decoder_name: str, model_width: int, model_depth: int,
                 in_channels: int = 3, output_nums: int = 1, ds: int = 0,
                 ae: int = 0, ag: int = 0, lstm: int = 0, dense_loop: int = 1,
                 is_transconv: bool = True, alpha: float = 1.0,
                 q: int = 3, feature_number: int = 1024,
                 input_size: tp.Optional[tp.Tuple[int, int]] = None,
                 final_activation: tp.Optional[str] = "sigmoid",
                 genre: str = "UNet", train_mode: str = "from_scratch",
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 block_remat: bool = False,
                 backbone: tp.Optional[str] = None,
                 backbone_trainable: bool = False):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items()
                            if k not in ("self", "generator", "__class__")}
        W, D = model_width, model_depth
        self.pretrained = train_mode == "pretrained_encoder"
        if self.pretrained:
            if not 1 <= D <= 5:
                raise ValueError(
                    "The depth of a pretrained-encoder model can only be "
                    "discretely varied from 1 to 5")
        elif train_mode != "from_scratch":
            raise ValueError(
                'train_mode must be "pretrained_encoder" or "from_scratch"')
        elif D < 1:
            raise ValueError("The depth of the model cannot be less than 1")
        if genre not in ("UNet", "FPN"):
            raise ValueError(f"Unknown model genre {genre!r}")
        level = deepest_pool(decoder_name, D, self.pretrained)
        if level > len(pool_backward.FACTORS):
            raise NotImplementedError(
                f"{decoder_name} at depth {D} pools by {2 ** level}; the "
                f"port's max pools go up to {pool_backward.FACTORS[-1]}")
        if ae and not input_size:
            raise ValueError("ae = 1 needs the input size: the autoencoder "
                             "bottleneck's Dense is sized by it")
        self.model_depth = D
        self.final_activation = final_activation
        self.dtype = dtype
        self.fpn = genre == "FPN"
        self_onn = decoder_name.startswith("Self")
        if self.pretrained:
            bb = get_backbone(backbone, dtype=dtype, max_tap=min(D, 5),
                              in_channels=in_channels, generator=generator,
                              trainable=backbone_trainable)
            self._encoder = f"{type(bb).__name__}_0"
            self.add_module(self._encoder, bb)
            self._projectors = []
            for lvl in range(1, min(D + 1, 5) + 1):
                cin, feats = bb.tap_features[lvl - 1], W * 2 ** (lvl - 1)
                if not self.fpn:
                    name = f"PretrainedTapProjector_{lvl - 1}"
                    proj: nn.Module = PretrainedTapProjector(
                        decoder_name, lvl, cin, W, D, alpha=alpha, q=q,
                        dtype=dtype, generator=generator)
                elif self_onn:
                    name, proj = f"Oper_{lvl - 1}", Oper(
                        cin, feats, 1, q=q, dtype=dtype, generator=generator)
                else:
                    name, proj = f"ConvBlock_{lvl - 1}", ConvBlock(
                        cin, feats, 1, use_bn=False, dtype=dtype,
                        generator=generator)
                self.add_module(name, proj)
                self._projectors.append(name)
            bottom = bb.tap_features[5] if D == 5 else W * 2 ** D
            #: KSSNet, UNet4P and UNet4PV2 pool each projected tap k to
            #: levels 1 .. n_proj - k for the deeper projectors
            self._tap_pyramids = (not self.fpn and decoder_name in (
                "KSSNet", "UNet4P", "UNet4PV2"))
        else:
            self._encoder = "ScratchEncoder_0"
            self.ScratchEncoder_0 = ScratchEncoder(
                decoder_name, in_channels, W, D, alpha=alpha, q=q,
                dtype=dtype, generator=generator)
            bottom = self.ScratchEncoder_0.out_features
        if not self.fpn:
            self.LatentLayer_0 = LatentLayer(
                decoder_name, W, D, dense_loop, alpha=alpha, q=q, dtype=dtype,
                generator=generator,
                in_features=bottom if self.pretrained else None)
            bottom = self.LatentLayer_0.out_features
        self.ae = bool(ae)
        if ae:
            grid = (self._backbone_grid(in_channels, input_size)
                    if self.pretrained
                    else tuple(pooled_size(n, D) for n in input_size))
            self.FeatureExtractionBlock_0 = FeatureExtractionBlock(
                bottom, grid, W * 2 ** D, feature_number, dtype=dtype,
                generator=generator)
            bottom = W * 2 ** D
        decoder = build_decoder(decoder_name, q=q, model_width=W,
                                model_depth=D, D_S=ds, A_G=ag, LSTM=lstm,
                                is_transconv=is_transconv, alpha=alpha,
                                dtype=dtype, generator=generator,
                                bottom_features=bottom)
        self.add_module(f"{type(decoder).__name__}_0", decoder)
        self._decoder_name = f"{type(decoder).__name__}_0"
        if self_onn:  # the final activation inside the Oper
            self.out: nn.Module = Oper(decoder.out_features, output_nums, 1,
                                       activation=final_activation, q=q,
                                       dtype=dtype, generator=generator)
            self._head_activation = None
        else:
            self.out = HeadConv(decoder.out_features, output_nums,
                                dtype=dtype, generator=generator)
            self._head_activation = final_activation
        set_block_remat(self, block_remat)

    def _backbone_grid(self, in_channels: int,
                       input_size: tp.Tuple[int, int]) -> tp.Tuple[int, int]:
        """The (H, W) of the backbone's tap min(D, 5) for an input of
        ``input_size``: its blocks' strides and paddings differ (SAME
        convs round up, VALID pools down)."""
        bb = getattr(self, self._encoder)
        was = bb.training
        nn.Module.train(bb, False)
        with torch.no_grad():
            x = torch.zeros((1, in_channels) + tuple(input_size)).contiguous(
                memory_format=torch.channels_last)
            shape = bb(x)[min(self.model_depth, 5)].shape
        nn.Module.train(bb, was)
        return int(shape[2]), int(shape[3])

    def reinitialized(self, generator: torch.Generator) -> "SegModel":
        """A new model of this architecture with weights drawn from
        ``generator``."""
        return type(self)(**self.init_kwargs, generator=generator)

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        # a fresh channels_last copy in the compute dtype: a batch of one
        # may come with any stride on its batch axis (numpy's x[None] gives
        # 0), and cuDNN then writes every conv output in the NCHW layout,
        # which the pool kernel refuses
        x = x.permute(0, 3, 1, 2)
        x = torch.empty(x.shape, dtype=self.dtype, device=x.device,
                        memory_format=torch.channels_last).copy_(x)
        if self.pretrained:
            raw = getattr(self, self._encoder)(x)
            taps: tp.List[torch.Tensor] = []
            pools: tp.List[tp.List[torch.Tensor]] = []
            n_proj = len(self._projectors)
            for lvl, (name, tap) in enumerate(zip(self._projectors, raw[:5]),
                                              1):
                proj = getattr(self, name)
                taps.append(proj(tap) if self.fpn else proj(tap, pools, taps))
                if self._tap_pyramids and lvl < n_proj:
                    pools.append(pyramid.maxpool_levels(taps[-1],
                                                        n_proj - lvl))
            bottom = raw[5] if self.model_depth == 5 else taps[-1]
        else:
            taps, bottom = self.ScratchEncoder_0(x)
        conv = bottom if self.fpn else self.LatentLayer_0(bottom)
        if self.ae:
            conv = self.FeatureExtractionBlock_0(conv)
        skips = taps[:self.model_depth] + [conv]
        deconv, levels = getattr(self, self._decoder_name)(skips)
        out = apply_activation(self.out(deconv), self._head_activation)
        outputs = {"out": out.permute(0, 2, 3, 1)}
        # the reference's order: out, then levelD .. level1
        for idx, lvl in enumerate(levels):
            outputs[f"level{self.model_depth - idx}"] = lvl.permute(0, 2, 3, 1)
        return outputs


def model_selector(
    model_genre: str,
    encoder_name: str,
    decoder_name: str,
    length: int,
    width: int = 1,
    model_width: int = 64,
    model_depth: int = 5,
    num_channels: int = 3,
    output_nums: int = 1,
    ds: int = 0,
    ae: int = 0,
    ag: int = 0,
    lstm: int = 0,
    dense_loop: int = 1,
    is_transconv: bool = True,
    alpha: float = 1.0,
    q: int = 3,
    feature_number: int = 1024,
    final_activation: str = "sigmoid",
    train_mode: str = "from_scratch",
    is_base_model_trainable: bool = False,
    dtype: torch.dtype = torch.float32,
    generator: tp.Optional[torch.Generator] = None,
    block_remat: bool = False,
) -> SegModel:
    """String-dispatch factory with the JAX ``model_selector``'s surface
    (segmodel.py:173).  ``num_channels`` sizes the first conv;
    ``encoder_name`` names the backbone of a ``pretrained_encoder``
    model; ``length`` and ``width``, the input's height and width, size
    the autoencoder bottleneck (``ae = 1``; without it the model takes
    any spatial size); ``q`` is the Self-ONN decoders' order."""
    if model_genre not in ("UNet", "FPN"):
        raise ValueError(f"Unknown model genre {model_genre!r}")
    pretrained = train_mode == "pretrained_encoder"
    return SegModel(
        decoder_name=decoder_name, model_width=model_width,
        model_depth=model_depth, in_channels=num_channels,
        output_nums=output_nums, ds=ds, ae=ae, ag=ag, lstm=lstm,
        dense_loop=dense_loop, is_transconv=is_transconv, alpha=alpha, q=q,
        feature_number=feature_number, input_size=(length, width),
        final_activation=final_activation, genre=model_genre,
        train_mode=train_mode, dtype=dtype, generator=generator,
        block_remat=block_remat,
        backbone=encoder_name if pretrained else None,
        backbone_trainable=is_base_model_trainable)
