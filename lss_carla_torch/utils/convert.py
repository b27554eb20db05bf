"""Weights across: JAX variables and reference checkpoints -> port state dicts.

The port's module names are the reference torch state-dict names (those
``lss_carla_tpu/utils/convert.py:107-162`` builds), so two sources load
with ``load_state_dict``:

* ``jax_variables_to_state_dict(variables, variant)``: the JAX package's
  ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays.
  Conv kernels go (kh, kw, I, O) -> (O, I, kh, kw), depthwise kernels
  (kh, kw, 1, C) -> (C, 1, kh, kw); BN scale/bias/mean/var become
  weight/bias/running_mean/running_var, and ``num_batches_tracked`` is
  filled with 0. The map takes ``variant`` (the JAX map is hard-wired to
  B0).
* ``jax_ema_to_state_dict(ema_params, ema_batch_stats, variant)``: a JAX
  train state's EMA (``ema_params``, ``ema_batch_stats``) -> an
  ``ema_state_dict`` for the port's checkpoints, through the same map.
* ``reference_state_dict(state_dict)``: a reference LSS-Carla ``.pt``
  state dict, minus what the port does not hold (the unused trunk head
  ``_conv_head``/``_bn1``/``_fc`` and the ``dx``/``bx``/``nx``/``frustum``
  constants, which the port rebuilds from its config).

A map entry is torch name -> (flax path, collection).
"""

from __future__ import annotations

import re
from typing import Dict, Tuple

import numpy as np
import torch

from lss_carla_torch.models.efficientnet import block_plan

Path = Tuple[str, ...]
NameMap = Dict[str, Tuple[Path, str]]

_KERNEL = "kernel"


def _conv(m: NameMap, torch_name: str, path: Path, bias: bool = False):
    m[f"{torch_name}.weight"] = (path + (_KERNEL,), "params")
    if bias:
        m[f"{torch_name}.bias"] = (path + ("bias",), "params")


def _bn(m: NameMap, torch_name: str, path: Path):
    m[f"{torch_name}.weight"] = (path + ("scale",), "params")
    m[f"{torch_name}.bias"] = (path + ("bias",), "params")
    m[f"{torch_name}.running_mean"] = (path + ("mean",), "batch_stats")
    m[f"{torch_name}.running_var"] = (path + ("var",), "batch_stats")


def mbconv_name_map(expand: int, tp: str = "", fp: Path = ()) -> NameMap:
    """One ``MBConvBlock``: torch prefix ``tp``, flax path prefix ``fp``."""
    m: NameMap = {}
    if expand != 1:  # no expand conv when expand_ratio == 1
        _conv(m, f"{tp}_expand_conv", fp + ("expand_conv",))
        _bn(m, f"{tp}_bn0", fp + ("bn0",))
    _conv(m, f"{tp}_depthwise_conv", fp + ("depthwise_conv",))
    _bn(m, f"{tp}_bn1", fp + ("bn1",))
    _conv(m, f"{tp}_se_reduce", fp + ("se_reduce",), bias=True)
    _conv(m, f"{tp}_se_expand", fp + ("se_expand",), bias=True)
    _conv(m, f"{tp}_project_conv", fp + ("project_conv",))
    _bn(m, f"{tp}_bn2", fp + ("bn2",))
    return m


def trunk_name_map(variant: str, tp: str = "", fp: Path = ()) -> NameMap:
    m: NameMap = {}
    _conv(m, f"{tp}_conv_stem", fp + ("conv_stem",))
    _bn(m, f"{tp}_bn0", fp + ("bn_stem",))
    for i, args in enumerate(block_plan(variant)):
        m.update(mbconv_name_map(args["expand"], f"{tp}_blocks.{i}.",
                                 fp + (f"block_{i}",)))
    return m


def up_name_map(tp: str = "", fp: Path = ()) -> NameMap:
    """``Up``: conv.0/conv.1 and conv.3/conv.4 <- ConvBNReLU_0/_1."""
    m: NameMap = {}
    for i, j in ((0, 0), (3, 1)):
        _conv(m, f"{tp}conv.{i}", fp + (f"ConvBNReLU_{j}", "Conv_0"))
        _bn(m, f"{tp}conv.{i + 1}", fp + (f"ConvBNReLU_{j}", "BatchNorm_0"))
    return m


def camencode_name_map(variant: str, tp: str = "", fp: Path = ()) -> NameMap:
    m = trunk_name_map(variant, f"{tp}trunk.", fp + ("trunk",))
    m.update(up_name_map(f"{tp}up1.", fp + ("up1",)))
    _conv(m, f"{tp}depthnet", fp + ("depthnet",), bias=True)
    return m


def basicblock_name_map(downsample: bool, tp: str = "", fp: Path = ()) -> NameMap:
    m: NameMap = {}
    _conv(m, f"{tp}conv1", fp + ("Conv_0",))
    _bn(m, f"{tp}bn1", fp + ("BatchNorm_0",))
    _conv(m, f"{tp}conv2", fp + ("Conv_1",))
    _bn(m, f"{tp}bn2", fp + ("BatchNorm_1",))
    if downsample:
        _conv(m, f"{tp}downsample.0", fp + ("downsample_conv",))
        _bn(m, f"{tp}downsample.1", fp + ("downsample_bn",))
    return m


def bevencode_name_map(tp: str = "", fp: Path = ()) -> NameMap:
    m: NameMap = {}
    _conv(m, f"{tp}conv1", fp + ("conv1",))
    _bn(m, f"{tp}bn1", fp + ("bn1",))
    for layer in (1, 2, 3):
        for blk in (0, 1):
            m.update(basicblock_name_map(
                layer > 1 and blk == 0, f"{tp}layer{layer}.{blk}.",
                fp + (f"layer{layer}_{blk}",)))
    m.update(up_name_map(f"{tp}up1.", fp + ("up1",)))
    # up2 = Sequential(Upsample, conv3x3, bn, relu, conv1x1 head)
    _conv(m, f"{tp}up2.1", fp + ("up2_conv", "Conv_0"))
    _bn(m, f"{tp}up2.2", fp + ("up2_conv", "BatchNorm_0"))
    _conv(m, f"{tp}up2.4", fp + ("head",), bias=True)
    return m


def name_map(variant: str = "b0") -> NameMap:
    """The whole ``LiftSplatShoot``."""
    m = camencode_name_map(variant, "camencode.", ("camencode",))
    m.update(bevencode_name_map("bevencode.", ("bevencode",)))
    return m


def variables_to_state_dict(variables: dict, names: NameMap) -> dict:
    """Apply a name map to ``{"params", "batch_stats"}`` nested numpy dicts."""
    out = {}
    for torch_name, (path, collection) in names.items():
        node = variables[collection]
        for k in path:
            node = node[k]
        arr = np.asarray(node, dtype=np.float32)
        if path[-1] == _KERNEL:  # conv and depthwise kernels alike
            arr = np.transpose(arr, (3, 2, 0, 1))
        out[torch_name] = torch.from_numpy(np.ascontiguousarray(arr))
        if torch_name.endswith(".running_mean"):
            out[torch_name[:-len("running_mean")] + "num_batches_tracked"] = (
                torch.tensor(0, dtype=torch.long))
    return out


def jax_variables_to_state_dict(variables: dict, variant: str = "b0") -> dict:
    """JAX ``LiftSplatShoot`` variables -> the port's state dict."""
    return variables_to_state_dict(variables, name_map(variant))


def jax_ema_to_state_dict(ema_params: dict, ema_batch_stats: dict,
                          variant: str = "b0") -> dict:
    """A JAX ``TrainState``'s ``ema_params`` and ``ema_batch_stats``
    (nested numpy dicts) -> the port's ``ema_state_dict``."""
    return variables_to_state_dict(
        {"params": ema_params, "batch_stats": ema_batch_stats},
        name_map(variant))


_SKIP = re.compile(
    r"(trunk\._conv_head|trunk\._bn1\.|trunk\._fc|^dx$|^bx$|^nx$|^frustum$)")


def reference_state_dict(state_dict) -> dict:
    """Reference LSS-Carla state dict -> the port's (tensors, on the CPU).

    Drops the trunk head and the geometry constants, and fills
    ``num_batches_tracked`` where a checkpoint lacks it."""
    out = {}
    for k, v in state_dict.items():
        if _SKIP.search(k):
            continue
        out[k] = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                 else v).detach().cpu()
    for k in [k for k in out if k.endswith(".running_mean")]:
        nbt = k[:-len("running_mean")] + "num_batches_tracked"
        out.setdefault(nbt, torch.tensor(0, dtype=torch.long))
    return out
