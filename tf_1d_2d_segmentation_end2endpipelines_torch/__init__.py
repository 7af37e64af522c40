"""tpuseg on PyTorch and CUDA: the port of
``tf_1d_2d_segmentation_end2endpipelines_tpu`` to an NVIDIA H100.

The JAX package stays the reference; each module here names its JAX
counterpart, and ``tests/test_torch_*.py`` hold the two against each other
on the CPU.  This package imports torch and never jax or flax.

- ``ops``      the block library and ``ops/kernels``: kernels written by
               hand for Hopper (``csrc/*.cu``), each beside its plain
               PyTorch version
- ``models``   the flagship UNet++ (from-scratch encoder, DenseBlock latent,
               nested grid decoder)
- ``train``    losses, Adam, the train/eval steps, metrics, callbacks,
               checkpoints and the ``Trainer``
- ``data``     the image-folder dataset, its threaded loader and synthetic
               data
- ``drivers``  the ``train`` verb's fold loop and the model restore of
               ``serve``
- ``serve``    the HTTP inference server (Predictor, DynamicBatcher)
- ``utils``    the INI config and the flax-to-torch weight and Adam-state
               converter

Layout: public entry points (``SegModel.forward``, ``Predictor``,
``fused_maxpool_pyramid``) take NHWC as the JAX package does; inside,
activations are (B, C, H, W) tensors in ``torch.channels_last`` memory.
"""

__version__ = "0.1.0"
