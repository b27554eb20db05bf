"""Weights across: JAX variables and reference checkpoints -> port state dicts.

The port's module names are the reference torch state-dict names (those
``lss_carla_tpu/utils/convert.py:107-162`` builds), so two sources load
with ``load_state_dict``:

* ``jax_variables_to_state_dict(variables, variant)``: the JAX package's
  ``{"params": ..., "batch_stats": ...}`` as nested dicts of numpy arrays.
  Conv kernels go (kh, kw, I, O) -> (O, I, kh, kw), depthwise kernels
  (kh, kw, 1, C) -> (C, 1, kh, kw); BN scale/bias/mean/var become
  weight/bias/running_mean/running_var, and ``num_batches_tracked`` is
  filled with 0. The map takes ``variant``, EfficientNet b0-b4 or
  resnet18/34 (the JAX map is hard-wired to B0).
* ``jax_ema_to_state_dict(ema_params, ema_batch_stats, variant)``: a JAX
  train state's EMA (``ema_params``, ``ema_batch_stats``) -> an
  ``ema_state_dict`` for the port's checkpoints, through the same map.
* ``reference_state_dict(state_dict)``: a reference LSS-Carla ``.pt``
  state dict, minus what the port does not hold (the unused trunk head
  ``_conv_head``/``_bn1``/``_fc`` and the ``dx``/``bx``/``nx``/``frustum``
  constants, which the port rebuilds from its config).

The pretrained trunk (``train(pretrained_trunk=...)``, reference
``src/models.py:43``): ``trunk_state_dict_from_checkpoint(path, variant)``
reads an ``efficientnet_pytorch`` ImageNet file, a reference LSS ``.pt`` or
one of the port's checkpoints into the trunk's state dict
(``imagenet_trunk_state_dict``), and ``merge_trunk_state_dict`` copies it
into a model's ``camencode.trunk``. The trunk's module names are
``efficientnet_pytorch``'s, so no tensor is renamed or transposed.

A map entry is torch name -> (flax path, collection).
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Tuple

import numpy as np
import torch

from lss_carla_torch.models.efficientnet import (EfficientNetTrunk, VARIANTS,
                                                 block_plan, round_filters)
from lss_carla_torch.models.resnet import RESNET_LAYERS
from lss_carla_torch.utils.checkpoint import latest_checkpoint

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
    if variant.startswith("resnet"):
        return resnet_name_map(variant, tp, fp)
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


def resnet_name_map(variant: str, tp: str = "", fp: Path = ()) -> NameMap:
    """``ResNetTrunk`` (torchvision names) <- the JAX trunk's ``conv1``,
    ``bn1`` and ``layer{s}_{r}`` BasicBlocks; a stage's first block
    downsamples from layer2 on."""
    m: NameMap = {}
    _conv(m, f"{tp}conv1", fp + ("conv1",))
    _bn(m, f"{tp}bn1", fp + ("bn1",))
    for stage, reps in enumerate(RESNET_LAYERS[variant], start=1):
        for r in range(reps):
            m.update(basicblock_name_map(
                stage > 1 and r == 0, f"{tp}layer{stage}.{r}.",
                fp + (f"layer{stage}_{r}",)))
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


# ImageNet files from efficientnet_pytorch carry the classifier head
# (_conv_head/_bn1/_fc) that the reference never runs: skipped, with every
# num_batches_tracked. ^_bn1\. matches only the head's BN, not a block's
# _blocks.N._bn1.
_IMAGENET_SKIP = re.compile(
    r"(num_batches_tracked|^_conv_head\.|^_bn1\.|^_fc\.)")
_TRUNK = "camencode.trunk."


def imagenet_trunk_state_dict(state_dict, variant: str = "b0") -> dict:
    """A bare ``efficientnet_pytorch`` state dict (the file
    ``EfficientNet.from_pretrained`` downloads) -> the EfficientNet trunk's
    state dict without ``num_batches_tracked``, CPU tensors. A name that is
    neither skipped nor in ``trunk_name_map(variant)`` raises ``KeyError``
    (a file of a deeper variant); a missing one is the merge's to report."""
    names = trunk_name_map(variant)
    out, unmapped = {}, []
    for k, v in state_dict.items():
        if _IMAGENET_SKIP.search(k):
            continue
        if k not in names:
            unmapped.append(k)
            continue
        out[k] = torch.as_tensor(v).detach().cpu()
    if unmapped:
        raise KeyError(f"unmapped reference tensors: {unmapped[:10]}"
                       f"{'...' if len(unmapped) > 10 else ''}")
    return out


def trunk_state_dict_from_checkpoint(path: str, variant: str = "b0") -> dict:
    """The EfficientNet trunk's state dict from any supported source:

    * ``"auto"``: the last, sorted, of
      ``~/.cache/torch/hub/checkpoints/efficientnet-{variant}-*.pth``, where
      ``EfficientNet.from_pretrained`` stores its download;
    * a torch file holding a bare ImageNet state dict, or a reference LSS
      checkpoint or one of the port's (``camencode.trunk.`` keys, raw or
      under ``model_state_dict``; the trained weights, never
      ``ema_state_dict``);
    * a directory of the port's checkpoints (``ckpts/``): its newest
      (``utils/checkpoint.py::latest_checkpoint``).

    Files load with ``weights_only=True``."""
    if path == "auto":
        pattern = os.path.expanduser(
            f"~/.cache/torch/hub/checkpoints/efficientnet-{variant}-*.pth")
        hits = sorted(glob.glob(pattern))
        if not hits:
            raise FileNotFoundError(
                f"pretrained_trunk='auto': no file matches {pattern}")
        path = hits[-1]
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no checkpoint in {path}")
        path = found
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise ValueError(f"{path}: not a state dict or checkpoint "
                         f"({type(sd).__name__})")
    if "model_state_dict" in sd:
        sd = sd["model_state_dict"]
    if any(k.startswith(_TRUNK) for k in sd):
        sd = {k[len(_TRUNK):]: v for k, v in sd.items() if k.startswith(_TRUNK)}
    return imagenet_trunk_state_dict(sd, variant)


@torch.no_grad()
def merge_trunk_state_dict(model, trunk_sd: dict) -> None:
    """Copy ``trunk_sd`` into ``model.camencode.trunk`` in place, each value
    cast to the model tensor's dtype and device; the model's own
    ``num_batches_tracked`` and everything outside the trunk stay. Names
    and shapes are checked first: a mismatch (another variant) raises
    ``ValueError`` with both listings and changes nothing."""
    own = {k: v for k, v in model.camencode.trunk.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    own_shapes = {k: tuple(v.shape) for k, v in own.items()}
    new_shapes = {k: tuple(v.shape) for k, v in trunk_sd.items()}
    if own_shapes != new_shapes:
        diff = sorted(k for k in own_shapes.keys() | new_shapes.keys()
                      if own_shapes.get(k) != new_shapes.get(k))
        raise ValueError(
            "pretrained trunk does not match the model's trunk names/shapes "
            f"(first differences: {diff[:5]}):\nmodel: {own_shapes}\n"
            f"loaded: {new_shapes}")
    for k, v in own.items():
        v.copy_(trunk_sd[k])


def synthetic_imagenet_state_dict(variant: str = "b0", seed: int = 0) -> dict:
    """A seeded stand-in for an ``efficientnet_pytorch`` ImageNet file, for
    tests and the chip script: every trunk tensor under its name and
    layout, plus what the import skips (``num_batches_tracked`` and the
    classifier head ``_conv_head``, ``_bn1``, ``_fc``). Its values keep an
    eval forward finite and in range: He-scaled convs, BN scales in [0.5,
    1.5], running variances in [0.5, 2] (a normal draw, as JAX's test
    file makes, gives negative variances and a NaN forward)."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in
              EfficientNetTrunk(variant).state_dict().items()}
    head = round_filters(1280, VARIANTS[variant][0])
    shapes.update({"_conv_head.weight": (head, block_plan(variant)[-1]["cout"],
                                         1, 1),
                   "_fc.weight": (1000, head), "_fc.bias": (1000,)})
    for k in ("weight", "bias", "running_mean", "running_var",
              "num_batches_tracked"):
        shapes[f"_bn1.{k}"] = () if k == "num_batches_tracked" else (head,)
    sd = {}
    for k, shape in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(int(rng.integers(1, 10 ** 6)))
            continue
        if len(shape) == 4:  # conv: He-scaled over its fan-in
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        elif k.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif k.endswith(".weight") and len(shape) == 1:  # a BN scale
            a = rng.uniform(0.5, 1.5, shape)
        else:  # biases, running means, the classifier
            a = rng.normal(0.0, 0.1, shape)
        sd[k] = torch.from_numpy(a.astype(np.float32))
    return sd
