"""PyTorch/CUDA port of the LSS camera-to-BEV engine.

Mirrors the layout and names of the JAX package ``lss_carla_tpu`` (the
reference it is held against) but imports nothing from it: ``configs``,
``ops``, ``models``, ``data``, ``training``, ``utils``, ``serving`` and
``server`` each have a counterpart there; ``train`` is the training CLI
and ``trunk_probe`` the port of ``scripts/pretrained_trunk_probe.py``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
The TPU kernels run as hand-written CUDA kernels on CUDA tensors and as
their plain PyTorch versions on CPU tensors: the splat (``csrc/splat.cu``)
and the depthwise conv with its BN batch moments
(``csrc/dw_conv_stats.cu``, train mode with ``fused_dw``).
"""
