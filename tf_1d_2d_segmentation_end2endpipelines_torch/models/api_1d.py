"""The 1D model API of the port (JAX: tf_1d_2d_segmentation_
end2endpipelines_tpu/models/api_1d.py): ``SegModel1D`` (:95), the
``UNet1D`` facade (:334) and ``model_selector_1d`` (:395).

Ported: every ``UNet1D`` arch (UNet, UNetE, UNetP, UNetPP, UNet3P,
UNet4P, MultiResUNet, the 1D MultiResUNet3P, RUNet, R2UNet, R2UNetPP,
R2UNet3P, the Self-ONN SelfR2UNetPP, SelfUNetPP and SelfUNet3P of order
``q``, and the six ConvMixer archs, also through the ``ConvMixerUNet``
facade), and the LinkNet family's add-merge archs (LinkNet, LinkNetE,
LinkNetP, LinkNetPP, MultiResLinkNet: ``merge = "add"``, built through
the ``LinkNet`` facade of models/extra_1d.py), with deep supervision
(``ds``),
attention gates (``ag``), ConvLSTM fusion (``lstm``; UNet3+-type
decoders ignore it), the autoencoder bottleneck (``ae``), transposed
convs or nearest upsampling, any kernel size, ``alpha`` and ``t``; and
the special families ``BCDUNet``, ``SEDUNet``, ``IBAUNet`` and
``NABNet`` (models/specials_1d.py), with ``lstm``, ``ae``,
``dense_loop`` and ``se_ratio``, TernausNet, AlbUNet and the 1D FPN
(models/extra_1d.py), MLMRSNet, MLMRSNet_V2 and LDNet
(models/mlmrsnet.py, ``cardinality``, ``pooling_type``), SAUNet,
SAMultiResUNet and SelfSAUNet (models/saunet.py, ``block_size``,
``keep_prob``) and Dense_Inception_UNet (models/dense_inception.py):
every name of the JAX ``model_selector_1d``.  ``MultiResUNet3P`` with
``lstm = 1`` raises ``NotImplementedError``, as the JAX package refuses
it.  The Self-ONN decoders take no gates or ConvLSTM fusion: ``ag`` and
``lstm`` build them unchanged, as in the JAX package.

The 1D tree differs from the 2D one (JAX api_1d.py:1-13): two ConvBlocks
an encoder level and a decoder node (one for UNet3+ and MultiRes nodes),
*D* pools (after every encoder level), the latent on the last pool, the
2-wide transposed conv with BatchNorm and ReLU, nearest upsampling, and a
softmax head for ``Classification``, a linear one for ``Regression``.

Inside, a signal is a (B, C, 1, L) tensor in channels_last memory: the
JAX package's NLC buffer (ops/blocks.py).  The blocks are direct children
with flax's auto-names, per-type counters in the order ``SegModel1D``
creates them inline: ``ConvBlock_0 .. ConvBlock_{2D+1}`` (encoder and
latent), or ``RecurrentConvBlock_<k>``, ``ConvMixerBlock_<k>``,
``MultiResBlock_<i>`` / ``ResPath_<i>``, ``Oper_<k>``,
``SelfRecurrentConvBlock_<k>``, ``FeatureExtractionBlock_0``, then
``ChainDecoder_0``, ``GridDecoder_0``, ``FullScaleDecoder_0``,
``SelfGridDecoder_0`` or ``SelfFullScaleDecoder_0``, then ``out``.
"""
from __future__ import annotations

import typing as tp

import torch
from torch import nn

from ..ops import (AttentionGate, AutoNamed, ConvBlock, ConvMixerBlock,
                   FeatureExtractionBlock, HeadConv, MultiResBlock, Oper,
                   RecurrentConvBlock, ResPath, SelfRecurrentConvBlock,
                   TransConv, apply_activation, concat, downsample_pool,
                   pooled_size, upsample)
from ..ops.kernels import pyramid
from ..ops.kernels.pool_backward import FACTORS_1D
from .decoders import (ChainDecoder, FullScaleDecoder, GridDecoder,
                       SelfFullScaleDecoder, SelfGridDecoder)
from .dense_inception import Dense_Inception_UNet
from .extra_1d import LINKNET_NAMES, FPN, AlbUNet, LinkNet, TernausNet
from .mlmrsnet import MLMRSNet
from .saunet import SAUNet
from .specials_1d import BCDUNet, IBAUNet, NABNet, SEDUNet

#: every arch name of the JAX ``UNet1D`` (api_1d.py:48-90)
ARCH_NAMES_1D = (
    "UNet", "UNetE", "UNetP", "UNetPP", "UNet3P", "UNet4P", "MultiResUNet",
    "MultiResUNet3P", "RUNet", "R2UNet", "R2UNetPP", "R2UNet3P",
    "SelfR2UNetPP", "SelfUNetPP", "SelfUNet3P", "ConvMixerUNet",
    "ConvMixerUNetE", "ConvMixerUNetP", "ConvMixerUNetPP", "ConvMixerUNet3P",
    "ConvMixerMultiResUNet")

#: the ported archs (JAX api_1d.py:48-90): decoder topology and variant,
#: node family and its repeats, encoder and latent families
_ARCHS: tp.Dict[str, tp.Dict[str, tp.Any]] = {
    "UNet": dict(topo="chain", node="conv", reps=2),
    "UNetE": dict(topo="grid", variant="E", node="conv", reps=2),
    "UNetP": dict(topo="grid", variant="P", node="conv", reps=2),
    "UNetPP": dict(topo="grid", variant="PP", node="conv", reps=2),
    "UNet3P": dict(topo="full", node="conv", reps=1),
    "UNet4P": dict(topo="grid", variant="4P", node="conv", reps=2,
                   enc="dense4p"),
    "MultiResUNet": dict(topo="chain", node="multires", reps=1,
                         enc="multires", latent="multires"),
    "MultiResUNet3P": dict(topo="mr3p1d"),
    "RUNet": dict(topo="chain", node="recurrent", reps=2, enc="recurrent",
                  latent="recurrent"),
    "R2UNet": dict(topo="chain", node="r2", reps=2, enc="r2x2",
                   latent="r2x2"),
    "R2UNetPP": dict(topo="grid", variant="PP", node="r2", reps=1,
                     enc="r2x1", latent="r2x1"),
    "R2UNet3P": dict(topo="full", node="r2", reps=2, enc="r2x2",
                     latent="r2x2"),
    "SelfR2UNetPP": dict(topo="selfgrid", bare=True, enc="selfrec",
                         latent="selfrec_q1"),
    "SelfUNetPP": dict(topo="selfgrid", node_reps=2, enc="oper2",
                       latent="oper2"),
    "SelfUNet3P": dict(topo="selffull", enc="oper2", latent="oper2"),
    "ConvMixerUNet": dict(topo="chain", node="convmixer", reps=2,
                          enc="convmixer", latent="convmixer"),
    "ConvMixerUNetE": dict(topo="grid", variant="E", node="convmixer",
                           reps=2, enc="convmixer", latent="convmixer"),
    "ConvMixerUNetP": dict(topo="grid", variant="P", node="convmixer",
                           reps=2, enc="convmixer", latent="convmixer"),
    "ConvMixerUNetPP": dict(topo="grid", variant="PP", node="convmixer",
                            reps=2, enc="convmixer", latent="convmixer"),
    "ConvMixerUNet3P": dict(topo="full", node="convmixer", reps=1,
                            enc="convmixer", latent="convmixer"),
    "ConvMixerMultiResUNet": dict(topo="chain", node="multires_mixer",
                                  reps=1, enc="multires_mixer",
                                  latent="multires_mixer"),
    # the LinkNet family (JAX extra_1d.py:289-359): add-merge decoders
    "LinkNet": dict(topo="chain", node="conv", reps=2, merge="add"),
    "LinkNetE": dict(topo="grid", variant="E", node="conv", reps=2,
                     merge="add"),
    "LinkNetP": dict(topo="grid", variant="P", node="conv", reps=2,
                     merge="add"),
    "LinkNetPP": dict(topo="grid", variant="PP", node="conv", reps=2,
                      merge="add"),
    "MultiResLinkNet": dict(topo="chain", node="multires", reps=1,
                            enc="multires", latent="multires", merge="add"),
}

_SPECIALS = {"BCDUNet": BCDUNet, "SEDUNet": SEDUNet, "IBAUNet": IBAUNet,
             "NABNet": NABNet}

#: the special 1D families' method names (JAX api_1d.py:420-480)
SPECIAL_NAMES_1D = (
    "BCDUNet", "SEDUNet", "IBAUNet", "NABNet", "MLMRSNet", "MLMRSNet_V2",
    "LDNet", "SAUNet", "SAMultiResUNet", "SelfSAUNet", "Dense_Inception_UNet",
    "TernausNet11", "TernausNet13", "TernausNet16", "TernausNet19",
    "AlbUNet18", "AlbUNet34", "AlbUNet50", "AlbUNet101", "AlbUNet152",
    ) + LINKNET_NAMES + ("FPN",)

#: every name ``model_selector_1d`` builds: ``UNet1D``'s archs and the
#: special families' method names
PORTED_ARCHS_1D = ARCH_NAMES_1D + SPECIAL_NAMES_1D


def check_arch_1d(arch: str, lstm: int = 0) -> None:
    """Raise for what ``model_selector_1d`` does not build:
    ``ValueError`` for a name the JAX package does not know either, and
    ``NotImplementedError`` for ``MultiResUNet3P`` with ``lstm = 1``,
    whose reference branch crashes (JAX api_1d.py:203-206)."""
    if arch not in PORTED_ARCHS_1D:
        raise ValueError(
            f"unknown 1D architecture {arch!r}; expected one of "
            f"{sorted(ARCH_NAMES_1D)} or a special-family method name")
    if lstm and arch == "MultiResUNet3P":
        raise NotImplementedError(
            "the 1D MultiResUNet3P with lstm = 1: the reference's LSTM "
            "branch crashes (undefined 'model_depth', unet_variants.py:942),"
            " and the JAX package refuses it too")


def deepest_pool_1d(arch: str, depth: int) -> int:
    """The deepest level m of the 1D max pools by 2**m that ``arch`` runs
    at ``depth``: D - 1 where the decoder pools encoder tap 0 to every
    level a later step reads (the full-scale skips of UNet3P, R2UNet3P,
    SelfUNet3P and ConvMixerUNet3P, ``FullScaleDecoder`` and
    ``SelfFullScaleDecoder``; MLMRSNet_V2's decoder taps), D - 2 for
    UNet4P (its dense encoder pools tap 1 to the bottom), else 1."""
    if _ARCHS.get(arch, {}).get("topo") in ("full", "selffull") \
            or arch == "MLMRSNet_V2":
        return max(depth - 1, 1)
    if _ARCHS.get(arch, {}).get("enc") == "dense4p":
        return max(depth - 2, 1)
    return 1


def check_pools_1d(arch: str, depth: int, ds_targets: bool = False) -> None:
    """Raise ``NotImplementedError`` when ``arch`` at ``depth`` would run a
    1D max pool wider than the port's kernels take (``FACTORS_1D``); with
    ``ds_targets``, also for the deep-supervision targets that the train
    verb pools from the mask to level ``depth``.  The JAX package builds
    and trains these models; the port refuses them when they are built,
    before a verb writes anything."""
    level, what = deepest_pool_1d(arch, depth), f"{arch} at depth {depth}"
    if ds_targets and depth > level:
        level, what = depth, f"{what} with d_s = 1 (its targets)"
    if level > len(FACTORS_1D):
        raise NotImplementedError(
            f"{what} pools by {2 ** level}; the port's 1D max pools take "
            f"FACTORS_1D = {FACTORS_1D}")


class SegModel1D(AutoNamed):
    """Config-driven 1D segmentation network (JAX ``SegModel1D``).

    ``forward`` takes a (B, L, C) batch, as the JAX module does, casts it
    to ``dtype`` and returns ``{"out": (B, L, output_nums)}`` in ``dtype``
    (softmax over the channels for ``Classification``, linear for
    ``Regression``), plus ``level1`` .. ``levelD`` (the deep-supervision
    heads) when ``ds == 1``.  Parameters are float32 and drawn from
    ``generator``; BatchNorm in training mode uses the batch statistics.
    ``in_channels`` sizes the first conv (flax infers it from the input);
    ``length``, the signals' length, sizes the autoencoder bottleneck
    (``ae = 1``: ``FeatureExtractionBlock`` on the pooled bottleneck,
    before the latent, JAX api_1d.py:289-292), which fixes the length the
    model takes.  ``t`` is the recurrent blocks' iterations.
    ``init_kwargs`` keeps the constructor's arguments, so
    ``reinitialized`` can draw a fresh model of the same architecture.
    ``q`` is the Self-ONN archs' order.

    The encoder and latent families (JAX ``_enc_level``/``_latent``,
    api_1d.py:115-183): two ConvBlocks, RecurrentConvBlocks,
    ConvMixerBlocks or ``Oper``s (``oper2``) a level; ``selfrec``, one
    ``SelfRecurrentConvBlock`` (SelfR2UNetPP's latent, ``selfrec_q1``, at
    order 1: the reference's quirk); ``r2x1``/``r2x2``, a 1x1 ConvBlock added to
    one or two RecurrentConvBlocks; a MultiResBlock (ConvMixer units for
    ``multires_mixer``) and a ``ResPath`` tap; ``dense4p`` (UNet4P), two
    ConvBlocks whose input at level i also concatenates taps 1 .. i-2
    max-pooled to it (tap 0 skipped, the reference's indexing), each tap's
    pools from one ``maxpool1d_levels`` launch that also gives the
    encoder's own pool.  ``MultiResUNet3P`` is the 1D reference's own
    network (``_build_mr3p``)."""

    def __init__(self, arch: str, model_width: int, model_depth: int,
                 kernel_size: int = 3, problem_type: str = "Regression",
                 output_nums: int = 1, ds: int = 0, ae: int = 0, ag: int = 0,
                 lstm: int = 0, alpha: float = 1.0, in_channels: int = 1,
                 is_transconv: bool = True, t: int = 2, q: int = 3,
                 feature_number: int = 1024,
                 length: tp.Optional[int] = None,
                 dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__()
        self.init_kwargs = {k: v for k, v in locals().items()
                            if k not in ("self", "generator", "__class__")}
        check_arch_1d(arch, lstm=lstm)
        if arch not in _ARCHS:
            raise ValueError(f"{arch!r} is a special family: "
                             "model_selector_1d builds it")
        if model_depth < 1:
            raise ValueError("The depth of the model cannot be less than 1")
        if ae and not length:
            raise ValueError("ae = 1 needs the signals' length: the "
                             "autoencoder bottleneck's Dense is sized by it")
        cfg = _ARCHS[arch]
        W, D, k = model_width, model_depth, kernel_size
        self.arch = arch
        self.model_depth = D
        self.problem_type = problem_type
        self.dtype = dtype
        self.ds = ds
        self._kw = dict(dtype=dtype, generator=generator, rank=1)
        self.q = q
        self.mr3p = cfg["topo"] == "mr3p1d"
        if self.mr3p:
            self._build_mr3p(W, D, k, alpha, ag, is_transconv, in_channels,
                             output_nums)
            return
        self.family = cfg.get("enc", "conv")
        self.levels: tp.List[tp.Dict[str, tp.Any]] = []
        cin = in_channels
        for i in range(1, D + 1):
            if self.family == "dense4p" and i > 1:
                cin += sum(W * 2 ** kk for kk in range(1, i - 1))
            level, cin = self._add_level(
                cin, W * 2 ** (i - 1), self.family, D - i + 1, W, k, alpha,
                t)
            self.levels.append(level)
        self.ae = bool(ae)
        if ae:
            self._add(FeatureExtractionBlock(
                cin, (1, pooled_size(length, D)), W, feature_number,
                dtype=dtype, generator=generator))
            cin = W
        self.latent, bottom = self._add_level(
            cin, W * 2 ** D, cfg.get("latent", "conv"), 0, W, k, alpha, t)
        common = dict(model_width=W, model_depth=D, D_S=ds, A_G=ag,
                      LSTM=lstm, is_transconv=is_transconv, alpha=alpha,
                      dtype=dtype, generator=generator, kernel=k,
                      node=cfg.get("node", "conv"),
                      conv_repeats=cfg.get("reps", 1), t=t,
                      dialect="1d", bottom_features=bottom)
        selfs = dict(model_width=W, model_depth=D, D_S=ds,
                     is_transconv=is_transconv, q=q, dtype=dtype,
                     generator=generator, kernel=k, dialect="1d",
                     bottom_features=bottom)
        merge = cfg.get("merge", "concat")
        if cfg["topo"] == "chain":
            decoder: nn.Module = ChainDecoder(style="unet", merge=merge,
                                              **common)
        elif cfg["topo"] == "grid":
            decoder = GridDecoder(variant=cfg["variant"], merge=merge,
                                  **common)
        elif cfg["topo"] == "selfgrid":
            decoder = SelfGridDecoder(bare=cfg.get("bare", False),
                                      node_reps=cfg.get("node_reps", 1),
                                      **selfs)
        elif cfg["topo"] == "selffull":
            decoder = SelfFullScaleDecoder(**selfs)
        else:
            decoder = FullScaleDecoder(multires=False, **common)
        self._decoder_name = f"{type(decoder).__name__}_0"
        self.add_module(self._decoder_name, decoder)
        self.out = HeadConv(decoder.out_features, output_nums, dtype=dtype,
                            generator=generator)

    def _add_level(self, cin: int, feats: int, family: str, respath: int,
                   W: int, k: int, alpha: float, t: int
                   ) -> tp.Tuple[tp.Dict[str, tp.Any], int]:
        """One encoder level (``respath``: its ResPath's length) or the
        latent (``respath`` 0: no ResPath) of ``family``; returns its
        blocks and its output width.  The blocks: ``blocks`` run in a
        chain, ``raw`` (r2) a 1x1 ConvBlock of the level's input added to
        the chain's output, ``tap`` (MultiRes) the ResPath whose output is
        the level's tap while the pool reads the block's."""
        kw = self._kw
        level: tp.Dict[str, tp.Any] = {"raw": None, "tap": None}
        if family in ("multires", "multires_mixer"):
            block = self._add(MultiResBlock(
                cin, W, k, alpha=alpha, multiplier=feats // W,
                mixer=family == "multires_mixer", **kw))
            level["blocks"] = [block]
            if respath:
                level["tap"] = self._add(ResPath(block.out_features, respath,
                                                 feats, k, **kw))
            return level, block.out_features
        if family in ("selfrec", "selfrec_q1"):
            level["blocks"] = [self._add(SelfRecurrentConvBlock(
                cin, feats, k, t=t, q=1 if family == "selfrec_q1" else self.q,
                **kw))]
            return level, feats
        if family == "oper2":
            level["blocks"] = [self._add(Oper(c, feats, k, q=self.q, **kw))
                               for c in (cin, feats)]
            return level, feats
        if family in ("r2x1", "r2x2"):
            level["raw"] = self._add(ConvBlock(cin, feats, 1, **kw))
            n, unit = (1 if family == "r2x1" else 2), RecurrentConvBlock
        elif family == "recurrent":
            n, unit = 2, RecurrentConvBlock
        elif family == "convmixer":
            n, unit = 2, ConvMixerBlock
        else:  # conv, dense4p
            n, unit = 2, ConvBlock
        blocks = []
        for _ in range(n):
            extra = dict(t=t) if unit is RecurrentConvBlock else {}
            blocks.append(self._add(unit(cin, feats, k, **extra, **kw)))
            cin = feats
        level["blocks"] = blocks
        return level, feats

    @staticmethod
    def _run_level(level: tp.Dict[str, tp.Any], x: torch.Tensor
                   ) -> tp.Tuple[torch.Tensor, torch.Tensor]:
        """(tap, the tensor the encoder pools)."""
        conv = x
        for block in level["blocks"]:
            conv = block(conv)
        if level["raw"] is not None:
            conv = level["raw"](x) + conv
        tap = level["tap"](conv) if level["tap"] is not None else conv
        return tap, conv

    def _build_mr3p(self, W: int, D: int, k: int, alpha: float, ag: int,
                    is_transconv: bool, in_channels: int,
                    output_nums: int) -> None:
        """The 1D MultiResUNet3P (JAX ``_mr3p_1d``, api_1d.py:185-258; the
        reference's unet_variants.py:899-980), a network of its own: D + 1
        encoder levels, level i a MultiResBlock (multiplier 2**(i-1)) and
        a ``ResPath`` of length D - i + 1 (at least one unit) and width W *
        2**i; level i > 1 reads [sigmoid(p), p] of p, the last tap pooled
        by 2 (one pool, read twice).  Decoder step j: the previous output
        upsampled (``TransConv_<j>`` or nearest), tap D - j - 1 (gated by
        ``AttentionGate_<j>`` with ``ag``: JAX builds it without the 1D
        dialect, so it resamples by linear resize and a 4-wide transposed
        conv), then the sigmoids of the
        deepest tap and of every earlier step's output upsampled to this
        level, into a MultiResBlock (multiplier 2**(D-j-1)); deep
        supervision by stride-2 1x1 heads ``level<D-j>``.  The second
        bottleneck block the reference builds but does not connect is not
        built."""
        kw = self._kw
        taps = []  # the taps' widths
        cin = in_channels
        self.enc3p = []
        for i in range(1, D + 2):
            if i > 1:
                cin = 2 * taps[-1]
            block = self._add(MultiResBlock(cin, W, k, alpha=alpha,
                                            multiplier=2 ** (i - 1), **kw))
            self.enc3p.append((block, self._add(ResPath(
                block.out_features, D - i + 1, W * 2 ** i, k, **kw))))
            taps.append(W * 2 ** i)
        self.dec3p = []
        deconv, nodes = taps[D], []
        for j in range(D):
            feats = W * 2 ** (D - j - 1)
            step: tp.Dict[str, tp.Any] = {"ag": None, "up": None,
                                          "ds": None}
            if ag:  # the 2D dialect's gate, as JAX builds it (:231-233)
                step["ag"] = self._add(AttentionGate(
                    taps[D - j - 1], deconv, feats, dialect="2d", rank=1,
                    dtype=kw["dtype"], generator=kw["generator"]))
            if is_transconv:
                step["up"] = self._add(TransConv(
                    deconv, feats, dialect="1d", dtype=kw["dtype"],
                    generator=kw["generator"]))
                deconv = feats
            cin = deconv + taps[D - j - 1] + taps[D] + sum(nodes)
            step["node"] = self._add(MultiResBlock(
                cin, W, k, alpha=alpha, multiplier=2 ** (D - j - 1), **kw))
            deconv = step["node"].out_features
            nodes.append(deconv)
            if self.ds:
                step["ds"] = HeadConv(deconv, 1, stride=(1, 2),
                                      dtype=kw["dtype"],
                                      generator=kw["generator"])
                self.add_module(f"level{D - j}", step["ds"])
            self.dec3p.append(step)
        self.out = HeadConv(deconv, output_nums, dtype=kw["dtype"],
                            generator=kw["generator"])

    def _forward_mr3p(self, x: torch.Tensor
                      ) -> tp.Tuple[torch.Tensor, tp.List[torch.Tensor]]:
        D = self.model_depth
        taps: tp.List[torch.Tensor] = []
        for i, (block, respath) in enumerate(self.enc3p):
            if i:
                p = downsample_pool(taps[-1], 2, op="max", rank=1)
                x = concat(torch.sigmoid(p), p)
            taps.append(respath(block(x)))
        deconv, nodes, levels = taps[D], [], []
        for j, step in enumerate(self.dec3p):
            skip = taps[D - j - 1]
            if step["ag"] is not None:
                skip = step["ag"](skip, deconv)
            deconv = (step["up"](deconv) if step["up"] is not None
                      else upsample(deconv, 2, method="nearest", rank=1))
            deconv = concat(deconv, skip, *[
                torch.sigmoid(upsample(t, 2 ** (j - m + 1), method="nearest",
                                       rank=1))
                for m, t in enumerate([taps[D]] + nodes)])
            deconv = step["node"](deconv)
            nodes.append(deconv)
            if step["ds"] is not None:
                levels.append(step["ds"](deconv))
        return deconv, levels

    def reinitialized(self, generator: torch.Generator) -> "SegModel1D":
        """A new model of this architecture with weights drawn from
        ``generator``."""
        return type(self)(**self.init_kwargs, generator=generator)

    def _encode(self, x: torch.Tensor
                ) -> tp.Tuple[tp.List[torch.Tensor], torch.Tensor]:
        """The taps and the last pool.  ``dense4p``: tap kk's pools by
        2**l, l = 1 .. max(D - 1 - kk, 1) (tap 0: l = 1), come from one
        launch; level 1
        is the encoder's own pool of it, and the level-i input also reads
        level i - 1 - kk (the same tensor at kk = i - 2: its gradient is
        the sum of the two reads', as the separate pools' is, since the
        windows do not overlap)."""
        D = self.model_depth
        taps: tp.List[torch.Tensor] = []
        pools: tp.List[tp.List[torch.Tensor]] = []
        pool = x
        for i, level in enumerate(self.levels, start=1):
            if self.family == "dense4p" and i > 1:
                pool = concat(pool, *[pools[kk][i - 2 - kk]
                                      for kk in range(1, i - 1)])
            tap, conv = self._run_level(level, pool)
            taps.append(tap)
            if self.family == "dense4p":
                kk = i - 1  # this tap's index
                pools.append(pyramid.maxpool1d_levels(
                    conv, max(D - 1 - kk, 1) if kk else 1))
                pool = pools[-1][0]
            else:
                pool = downsample_pool(conv, 2, op="max", rank=1)
        return taps, pool

    def forward(self, x: torch.Tensor) -> tp.Dict[str, torch.Tensor]:
        D = self.model_depth
        # a fresh channels_last (B, C, 1, L) copy in the compute dtype:
        # (B, L, C) memory, whatever strides the caller's batch has
        x = x.permute(0, 2, 1).unsqueeze(2)
        x = torch.empty(x.shape, dtype=self.dtype, device=x.device,
                        memory_format=torch.channels_last).copy_(x)
        if self.mr3p:
            deconv, levels = self._forward_mr3p(x)
        else:
            taps, pool = self._encode(x)
            if self.ae:
                pool = self.FeatureExtractionBlock_0(pool)
            latent, _ = self._run_level(self.latent, pool)
            deconv, levels = getattr(self, self._decoder_name)(
                taps + [latent])
        out = self.out(deconv)
        if self.problem_type == "Classification":
            out = apply_activation(out, "softmax")
        outputs = {"out": out[:, :, 0].permute(0, 2, 1)}
        # the reference's order: out, then levelD .. level1
        for idx, lvl in enumerate(levels):
            outputs[f"level{D - idx}"] = lvl[:, :, 0].permute(0, 2, 1)
        return outputs


class _ArchFacade:
    """What the reference's facades share: their constructor's keywords,
    kept for ``_build(arch)``, which returns a configured ``SegModel1D``;
    ``_register`` names each facade method after the arch it builds."""

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
                        is_transconv=is_transconv, t=t, q=q,
                        feature_number=feature_number, length=length,
                        dtype=dtype, generator=generator)

    def _build(self, arch: str) -> SegModel1D:
        return SegModel1D(arch=arch, **self._kw)

    @classmethod
    def _register(cls, methods: tp.Mapping[str, str]) -> None:
        for name, arch in methods.items():
            setattr(cls, name, (lambda self, _a=arch: self._build(_a)))


class UNet1D(_ArchFacade):
    """Facade with the reference's constructor and method names (JAX
    api_1d.py:334-356, 1DCNN/Models/unet_variants.py:222-253): each
    method returns a configured ``SegModel1D``.  ``generator`` draws the
    weights; ``length`` sizes the autoencoder bottleneck with ``ae =
    1``."""


UNet1D._register({name: name for name in ARCH_NAMES_1D})


class ConvMixerUNet(_ArchFacade):
    """Facade for the reference ``ConvMixer_UNet`` class (JAX api_1d.py:
    359-384, convmixer_unet.py:141-162), with its constructor: its
    methods UNet, UNetE, UNetP, UNetPP, UNet3P and MultiResUNet build the
    ConvMixer archs."""

    def __init__(self, length, model_depth, num_channel, model_width,
                 kernel_size, problem_type="Regression", output_nums=1,
                 ds=1, ae=0, ag=0, lstm=0, alpha=1, feature_number=1024,
                 is_transconv=True, dtype: torch.dtype = torch.float32,
                 generator: tp.Optional[torch.Generator] = None):
        super().__init__(length, model_depth, num_channel, model_width,
                         kernel_size, problem_type, output_nums, ds, ae, ag,
                         lstm, alpha, feature_number=feature_number,
                         is_transconv=is_transconv, dtype=dtype,
                         generator=generator)


ConvMixerUNet._register({
    "UNet": "ConvMixerUNet", "UNetE": "ConvMixerUNetE",
    "UNetP": "ConvMixerUNetP", "UNetPP": "ConvMixerUNetPP",
    "UNet3P": "ConvMixerUNet3P", "MultiResUNet": "ConvMixerMultiResUNet"})


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
    (``dense_loop``, ``se_ratio``, ``lstm``, ``ag``, ``ae`` and
    ``feature_number`` as JAX api_1d.py:424-434 passes them), and the
    other families through their facades with the arguments JAX
    api_1d.py:435-480 passes them (``cardinality`` and ``pooling_type``
    to MLMRSNet, ``block_size``, ``keep_prob``, ``alpha`` and ``q`` to
    SAUNet, ``alpha`` and ``lstm`` to LinkNet); an unknown name raises
    the JAX package's ``ValueError``.  ``length`` sizes the autoencoder
    bottleneck (``ae = 1``; without it the model takes any length); ``q``
    is the Self-ONN archs' order.  A model that would pool by more than
    the port's 1D kernels take raises ``NotImplementedError`` here
    (``check_pools_1d``)."""
    check_arch_1d(arch, lstm=lstm)
    check_pools_1d(arch, model_depth)
    fam = dict(dtype=dtype, generator=generator)
    if arch in ("MLMRSNet", "MLMRSNet_V2", "LDNet"):
        return getattr(MLMRSNet(
            length, model_depth, num_channel, model_width, kernel_size,
            problem_type=problem_type, output_nums=output_nums, ds=ds,
            ae=ae, cardinality=cardinality, pooling_type=pooling_type,
            feature_number=feature_number, is_transconv=is_transconv,
            **fam), arch)()
    if arch in ("SAUNet", "SAMultiResUNet", "SelfSAUNet"):
        return getattr(SAUNet(
            length, model_depth, num_channel, model_width, kernel_size,
            output_nums=output_nums, ds=ds, ae=ae, alpha=alpha,
            feature_number=feature_number, block_size=block_size,
            keep_prob=keep_prob, is_transconv=is_transconv, q=q, **fam),
            arch)()
    if arch == "Dense_Inception_UNet":
        return Dense_Inception_UNet(
            length, model_depth, num_channel, model_width, kernel_size,
            problem_type=problem_type, output_nums=output_nums, ds=ds,
            ae=ae, ag=ag, feature_number=feature_number,
            **fam).Dense_Inception_UNet()
    if arch.startswith("TernausNet"):
        return getattr(TernausNet(
            length, num_channel, model_width, ds=ds, ae=ae, ag=ag,
            problem_type=problem_type, output_nums=output_nums,
            feature_number=feature_number, is_transconv=is_transconv,
            **fam), arch)()
    if arch.startswith("AlbUNet"):
        return getattr(AlbUNet(
            length, num_channel, model_width, ds=ds, ae=ae, ag=ag,
            problem_type=problem_type, output_nums=output_nums,
            feature_number=feature_number, **fam), arch)()
    if arch in LINKNET_NAMES:
        return getattr(LinkNet(
            length, model_depth, num_channel, model_width, kernel_size,
            problem_type=problem_type, output_nums=output_nums, ds=ds,
            ae=ae, ag=ag, lstm=lstm, alpha=alpha,
            feature_number=feature_number, is_transconv=is_transconv,
            **fam), arch)()
    if arch == "FPN":
        return FPN(length, model_depth, num_channel, model_width,
                   kernel_size, problem_type=problem_type,
                   output_nums=output_nums, ds=ds, ae=ae, ag=ag,
                   feature_number=feature_number,
                   is_transconv=is_transconv, **fam).FPN()
    if arch in _SPECIALS:
        return _SPECIALS[arch](
            model_width=model_width, model_depth=model_depth,
            kernel_size=kernel_size, problem_type=problem_type,
            output_nums=output_nums, ds=ds, ae=ae, ag=ag, lstm=lstm,
            dense_loop=dense_loop, se_ratio=se_ratio,
            feature_number=feature_number, length=length,
            in_channels=num_channel, is_transconv=is_transconv, dtype=dtype,
            generator=generator)
    return UNet1D(length, model_depth, num_channel, model_width,
                  kernel_size, problem_type=problem_type,
                  output_nums=output_nums, ds=ds, ae=ae, ag=ag, lstm=lstm,
                  alpha=alpha, t=t, feature_number=feature_number,
                  is_transconv=is_transconv, q=q, dtype=dtype,
                  generator=generator)._build(arch)
