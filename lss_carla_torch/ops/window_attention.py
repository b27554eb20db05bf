"""Attention inside windows: the Swin trunk's W-MSA and SW-MSA
(``models/swin.py``), through ``torch.nn.functional.scaled_dot_product_attention``
with the relative position bias, and on shifted windows the shift mask, as
one additive ``attn_mask``. PyTorch picks the kernel: a fused one where it
takes an additive bias with a gradient, else its plain math path.

Counters, kept here at the wrapper as the splat's launch counters are kept
at theirs: ``windows`` counts the windows (an image's window, all heads)
that calls of ``window_attention`` computed, by kind ("plain" or
"shifted"); ``captured`` counts those of calls made while a CUDA graph was
being captured, which computed nothing then; ``replayed`` those that the
train step's graph replays computed, each replay adding what its capture
recorded (``training/step.py``). ``computed()`` is every window computed
in this process since ``reset_windows()``. ``calls`` counts the calls made
outside a capture, by kind: an eager forward's calls, one a Swin block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

KINDS = ("plain", "shifted")
windows = {k: 0 for k in KINDS}
captured = {k: 0 for k in KINDS}
replayed = {k: 0 for k in KINDS}
calls = {k: 0 for k in KINDS}


def reset_windows() -> None:
    """Set every count of ``windows``, ``captured``, ``replayed`` and
    ``calls`` to 0."""
    for counts in (windows, captured, replayed, calls):
        for k in KINDS:
            counts[k] = 0


def add_replayed(held: dict) -> None:
    """Add one replay's windows, what its capture recorded, to ``replayed``."""
    for k, v in held.items():
        replayed[k] += v


def computed() -> dict:
    """{kind: windows computed}, eagerly and by replays."""
    return {k: windows[k] + replayed[k] for k in KINDS}


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, n_windows: int, shifted: bool) -> torch.Tensor:
    """Softmax attention of (G, H, T, d) queries, keys and values over the
    (1, H, T, T) additive ``bias``, scaled by d**-0.5; the batch of
    ``G x H`` groups holds ``n_windows`` windows of every head. Plain
    windows come as (images x windows, heads, T, d) with the position bias
    of each head; shifted ones as (images, windows x heads, T, d), whose
    bias holds each window's shift mask too."""
    key = KINDS[int(shifted)]
    if q.is_cuda and torch.cuda.is_current_stream_capturing():
        captured[key] += n_windows
    else:
        windows[key] += n_windows
        calls[key] += 1
    return F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
