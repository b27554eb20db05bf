"""Plain training steps for the reference model: the weighted BCE, the
gradients summed over microbatches and averaged, the global-norm clip
(scaled only where the norm reaches the limit, no epsilon), L2 weight
decay folded into the gradient, and Adam (0.9, 0.999, 1e-8) at the
schedule's learning rate: a linear warm-up from 0, then a cosine decay
to 0 (``lr_at``).

``gradient`` is one step's forward and backward from given weights: what
the comparison reads of a step. ``follow`` runs the steps on given
batches from given weights and returns the first step's ``gradient``,
each step's loss and each parameter's change after the last step.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from benchmark.reference.lss import Params, bce, forward, identity

BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def lr_at(opt: dict, count: int) -> float:
    """Learning rate of update ``count`` (0 for the first)."""
    lr, warm = opt["lr"], opt.get("warmup_steps", 0)
    if opt.get("schedule", "constant") == "constant":
        return lr * min(count, warm) / warm if warm else lr
    if count < warm:
        return lr * count / warm
    steps = opt["decay_steps"] - warm
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count - warm, steps) / steps))


def trainable(names) -> List[str]:
    return [n for n in names if not n.endswith(BUFFER_SUFFIXES)]


def gradient(p: Params, names, cfg: dict, opt: dict, micro, masks=None,
             quant=identity) -> Dict[str, object]:
    """One step's forward and backward over the microbatches ``micro``
    (each the 7-tuple (imgs, rots, trans, intrins, post_rots, post_trans,
    labels); ``masks[m]`` the dropout masks of microbatch m). Returns
    {"loss": the microbatches' mean, "grad": {name: the gradient as the
    optimizer takes it: averaged, clipped, with the decay term},
    "logits", "dlogits" (the loss's gradient by the logits) and "bev"
    (the pooled BEV): a list of one a microbatch}."""
    grads = {n: torch.zeros_like(p[n]) for n in names}
    out = {"logits": [], "dlogits": [], "bev": []}
    total = 0.0
    for i, mb in enumerate(micro):
        taps = {}
        logits = forward(p, cfg, mb, train=True, masks=None if masks is None else masks[i],
                         quant=quant, taps=taps)
        loss = bce(logits, mb[6].float(), cfg["pos_weight"])
        g = torch.autograd.grad(loss, [logits] + [p[n] for n in names], allow_unused=True)
        out["logits"].append(logits.detach())
        out["dlogits"].append(g[0])
        out["bev"].append(taps["bev"])
        for n, gi in zip(names, g[1:]):
            if gi is not None:
                grads[n] += gi
        total += float(loss.detach())
    grads = {n: g / len(micro) for n, g in grads.items()}
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values()]))
    scale = opt["max_grad_norm"] / norm if norm >= opt["max_grad_norm"] else 1.0
    with torch.no_grad():
        out["grad"] = {n: grads[n] * scale + opt["weight_decay"] * p[n] for n in names}
    out["loss"] = total / len(micro)
    return out


def follow(weights: Params, cfg: dict, opt: dict, steps, masks=None,
           quant=identity) -> Dict[str, object]:
    """Run ``len(steps)`` steps. ``steps[s]`` is a list of microbatches;
    ``masks[s][m]`` the dropout masks of microbatch m of step s
    (``lss.forward``). Returns {"loss": [per step], "first": the first
    step's ``gradient``, "grad1": {name: norm of its gradient}, "change":
    {name: norm}}."""
    names = trainable(weights)
    p = {n: t.detach().float().clone() for n, t in weights.items()}
    for n in names:
        p[n].requires_grad_(True)
    start = {n: p[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    for s, micro in enumerate(steps):
        step = gradient(p, names, cfg, opt, micro, None if masks is None else masks[s], quant)
        losses.append(step["loss"])
        if s == 0:
            first = step
        t, lr = s + 1, lr_at(opt, s)
        with torch.no_grad():
            for n in names:
                g = step["grad"][n]
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                p[n].addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))
    change = {n: float(torch.linalg.vector_norm(p[n].detach() - start[n]))
              for n in names}
    return {"loss": losses, "first": first,
            "grad1": {n: float(torch.linalg.vector_norm(g)) for n, g in first["grad"].items()},
            "change": change}


def one_step(weights: Params, cfg: dict, opt: dict, micro, masks=None,
             quant=identity) -> Dict[str, object]:
    """``gradient`` of one step from ``weights`` (a state that the program
    reached: the check of a step after the window)."""
    names = trainable(weights)
    p = {n: t.detach().float().clone() for n, t in weights.items()}
    for n in names:
        p[n].requires_grad_(True)
    return gradient(p, names, cfg, opt, micro, masks, quant)
