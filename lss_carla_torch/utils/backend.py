"""Device resolution for the port's entry points.

Counterpart of ``lss_carla_tpu/utils/backend.py``. Every entry point takes a
``device`` argument that defaults to ``"cuda"``. Without a GPU that default
raises: the port never moves to the CPU on its own. The CPU is used only
when the caller asks for it, as the tests do with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev
