"""tpuseg on PyTorch and CUDA: the port of
``tf_1d_2d_segmentation_end2endpipelines_tpu`` to an NVIDIA H100.

The JAX package stays the reference; each module here names its JAX
counterpart, and ``tests/test_torch_*.py`` hold the two against each other
on the CPU.  This package imports torch and never jax or flax.

- ``ops``      the block library and ``ops/kernels``: kernels written by
               hand for Hopper (``csrc/*.cu``), each beside its plain
               PyTorch version
- ``models``   the 2D UNet genre and MultiRes family, on a from-scratch
               or an EfficientNet encoder (``backbones``), and the 1D
               models (``api_1d``: ``SegModel1D``, ``model_selector_1d``;
               ``specials_1d``: BCDUNet, SEDUNet, IBAUNet, NABNet)
- ``train``    losses, Adam, the train/eval steps, metrics, callbacks,
               checkpoints and the ``Trainer``
- ``data``     the image-folder dataset, its threaded loader, ``.pt``
               signal sets and synthetic data
- ``drivers``  the ``train``, ``test`` and ``predict`` verbs and the model
               restore of ``serve``; ``drivers_1d`` the ``train1d``,
               ``test1d`` and ``predict1d`` verbs
- ``serve``    the HTTP inference server (Predictor, DynamicBatcher)
- ``utils``    the INI config and the flax-to-torch weight and Adam-state
               converter

Layout: public entry points (``SegModel.forward``, ``Predictor``,
``fused_maxpool_pyramid``) take NHWC as the JAX package does, and
``SegModel1D.forward`` (B, L, C); inside, activations are (B, C, H, W)
tensors in ``torch.channels_last`` memory, a 1D signal (B, C, 1, L).
"""

__version__ = "0.1.0"
