"""Top-level segmentation model of the port
(JAX: tf_1d_2d_segmentation_end2endpipelines_tpu/models/segmodel.py).

Ported: the from-scratch UNet genre, with or without deep supervision,
without autoencoder mode, with any decoder that ``decoders.build_decoder``
has (UNet, UNetE, UNetP, UNet++, UNet3+, MultiResUNet, MultiResUNet3+ and
KSSNet so far), attention gates on the chains and grids.
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import HeadConv, apply_activation, set_block_remat
from .decoders import build_decoder
from .encoders import LatentLayer, ScratchEncoder


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
    of the same architecture."""

    def __init__(self, decoder_name: str, model_width: int, model_depth: int,
                 in_channels: int = 3, output_nums: int = 1, ds: int = 0,
                 ae: int = 0, ag: int = 0, lstm: int = 0, dense_loop: int = 1,
                 is_transconv: bool = True, alpha: float = 1.0,
                 final_activation: tp.Optional[str] = "sigmoid",
                 genre: str = "UNet", train_mode: str = "from_scratch",
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None,
                 block_remat: bool = False):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items()
                            if k not in ("self", "generator", "__class__")}
        if train_mode != "from_scratch":
            raise NotImplementedError(
                f"train_mode {train_mode!r} is not ported yet")
        if genre != "UNet" or ae:
            raise NotImplementedError(
                "only the UNet genre without autoencoder mode is ported")
        if model_depth < 1:
            raise ValueError("The depth of the model cannot be less than 1")
        W, D = model_width, model_depth
        self.model_depth = D
        self.final_activation = final_activation
        self.dtype = dtype
        self.ScratchEncoder_0 = ScratchEncoder(
            decoder_name, in_channels, W, D, alpha=alpha, dtype=dtype,
            generator=generator)
        self.LatentLayer_0 = LatentLayer(decoder_name, W, D, dense_loop,
                                         alpha=alpha, dtype=dtype,
                                         generator=generator)
        decoder = build_decoder(decoder_name, model_width=W, model_depth=D,
                                D_S=ds, A_G=ag, LSTM=lstm,
                                is_transconv=is_transconv, alpha=alpha,
                                dtype=dtype, generator=generator)
        self.add_module(f"{type(decoder).__name__}_0", decoder)
        self._decoder_name = f"{type(decoder).__name__}_0"
        self.out = HeadConv(decoder.out_features, output_nums, dtype=dtype,
                            generator=generator)
        set_block_remat(self, block_remat)

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
        taps, bottom = self.ScratchEncoder_0(x)
        conv = self.LatentLayer_0(bottom)
        skips = taps[:self.model_depth] + [conv]
        deconv, levels = getattr(self, self._decoder_name)(skips)
        out = apply_activation(self.out(deconv), self.final_activation)
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
    final_activation: str = "sigmoid",
    train_mode: str = "from_scratch",
    dtype: torch.dtype = torch.float32,
    generator: tp.Optional[torch.Generator] = None,
    block_remat: bool = False,
) -> SegModel:
    """String-dispatch factory with the JAX ``model_selector``'s surface
    (segmodel.py:173).  ``num_channels`` sizes the first conv; ``length``,
    ``width`` and ``encoder_name`` are accepted for parity (the model takes
    any spatial size; only the from-scratch encoder is ported)."""
    if model_genre not in ("UNet", "FPN"):
        raise ValueError(f"Unknown model genre {model_genre!r}")
    return SegModel(
        decoder_name=decoder_name, model_width=model_width,
        model_depth=model_depth, in_channels=num_channels,
        output_nums=output_nums, ds=ds, ae=ae, ag=ag, lstm=lstm,
        dense_loop=dense_loop, is_transconv=is_transconv, alpha=alpha,
        final_activation=final_activation, genre=model_genre,
        train_mode=train_mode, dtype=dtype, generator=generator,
        block_remat=block_remat)
