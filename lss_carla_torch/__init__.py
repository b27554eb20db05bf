"""PyTorch/CUDA port of the LSS camera-to-BEV engine.

Mirrors the layout and names of the JAX package ``lss_carla_tpu`` (the
reference it is held against) but imports nothing from it: ``configs``,
``ops``, ``models``, ``utils``, ``serving`` and ``server`` each have a
counterpart there. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the splat runs as the hand-written CUDA kernel in
``csrc/splat.cu`` on a CUDA tensor and as its plain PyTorch version on a
CPU tensor.
"""
