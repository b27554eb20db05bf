"""Seeded weights for both sides, made on the device in a few large calls.

The rules are the port's initialisation (``init_weights``): bias-free
convolutions He-normal over fan-out, convolutions with a bias
LeCun-normal with a zero bias, BN scale 1 and shift 0 with running stats
0 and 1, and the zero-init residual (each BEV ``BasicBlock``'s ``bn2``
scale 0). ``random_bn`` draws every BN's scale, shift and running stats
instead (scale 0.5 + U, shift 0.1 N, mean 0.3 N, variance 0.5 + U), so
that an eval-mode forward tests every normalisation.

Every normal draw comes from one ``randn`` and every uniform draw from one
``rand`` of a ``torch.Generator`` on the device, seeded with the run's
seed, so the same seed gives the same weights on the same kind of card.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.reference.lss import param_shapes


def make_weights(cfg: dict, seed: int, device, random_bn: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """{name: tensor} of every parameter and BN running stat (f32; the
    BN counters int64) of the config's model."""
    shapes = param_shapes(cfg)
    names = {n for n, _ in shapes}
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal, uniform = [], []      # (name, shape, scale, shift)
    out = {}
    for name, shape in shapes:
        if name.endswith(".num_batches_tracked"):
            out[name] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        stem, leaf = name.rsplit(".", 1)
        if len(shape) == 4:
            if stem + ".bias" in names:
                fan_in = shape[1] * shape[2] * shape[3]
                normal.append((name, shape, fan_in ** -0.5, 0.0))
            else:
                fan_out = shape[0] * shape[2] * shape[3]
                normal.append((name, shape, (2.0 / fan_out) ** 0.5, 0.0))
        elif stem + ".running_mean" not in names:          # a conv bias
            out[name] = torch.zeros(shape, device=device)
        elif random_bn:
            if leaf in ("weight", "running_var"):
                uniform.append((name, shape, 1.0, 0.5))
            else:
                normal.append((name, shape, 0.1 if leaf == "bias" else 0.3, 0.0))
        else:
            zero_init = leaf == "weight" and stem.startswith("bevencode.layer") \
                and stem.endswith(".bn2")
            fill = 1.0 if leaf in ("weight", "running_var") and not zero_init else 0.0
            out[name] = torch.full(shape, fill, device=device)
    for draw, parts in ((torch.randn, normal), (torch.rand, uniform)):
        if not parts:
            continue
        sizes = [torch.Size(s).numel() for _, s, _, _ in parts]
        flat = draw(sum(sizes), generator=gen, device=device)
        for (name, shape, scale, shift), chunk in zip(parts, flat.split(sizes)):
            out[name] = chunk.view(shape).mul(scale).add_(shift)
    return {n: out[n] for n, _ in shapes}


@torch.no_grad()
def calibrate_bn(weights: Dict[str, torch.Tensor], cfg: dict, batch) -> None:
    """Set every BN's running stats, in place, to its batch moments over
    ``batch`` in a train-mode forward of the plain reference (f32): the
    eval-mode forward then normalises each layer as a trained model's
    does, on inputs like these, and is as well conditioned."""
    from benchmark.reference.lss import forward
    stats = {}
    forward(weights, cfg, batch, train=True, stats=stats)
    for name, (mean, var) in stats.items():
        weights[name + ".running_mean"].copy_(mean)
        weights[name + ".running_var"].copy_(var)
