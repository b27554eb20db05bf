"""The parallel modes end to end on the CPU: the sharded loaders against
the JAX ``DataLoader``, ``train()`` on spawned gloo ranks (data parallel,
camera parallel, a resume), the multi-host launch (``python -m
lss_carla_torch.parallel.dryrun --cli``: ``train(multihost=True)`` under a
launcher's environment, a SIGTERM on one rank) and ``dryrun_multichip``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lss_carla_tpu.data import loader as JLd

from lss_carla_torch.configs import DataAugConf, GridConf
from lss_carla_torch.data import fixtures as F
from lss_carla_torch.data.loader import DataLoader, compile_data
from lss_carla_torch.parallel.dryrun import dryrun_multichip
from lss_carla_torch.training.loop import train
from lss_carla_torch.utils.checkpoint import load_checkpoint
from lss_carla_torch.utils.convert import (imagenet_trunk_state_dict,
                                           synthetic_imagenet_state_dict)

REPO = Path(__file__).resolve().parent.parent


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.array([i]),)


class _Fixed:
    """Stands in for numpy's generator in the JAX loader: its shuffle
    writes the port's permutation, so both loaders shard one order."""

    def __init__(self, perm):
        self.perm = perm

    def shuffle(self, order):
        order[:] = self.perm


@pytest.mark.parametrize("n,bsz,shards,mode,shuffle", [
    (19, 2, 3, "drop_last", True), (19, 2, 3, "pad_last", False),
    (24, 4, 2, "drop_last", True), (24, 3, 4, "pad_last", True),
    (17, 1, 2, "pad_last", False), (16, 2, 4, None, True)])
def test_sharded_loader_indices_match_jax(monkeypatch, n, bsz, shards, mode,
                                          shuffle):
    """Every shard of the port's loader yields the JAX loader's batches of
    that shard (indices and validity masks), epoch by epoch, given the
    same global order (the port shuffles with torch.randperm, JAX with
    numpy: the port's order is handed to JAX)."""
    kw = {mode: True} if mode else {}
    for epoch in (0, 1):
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(
            13 + epoch)).numpy()
        monkeypatch.setattr(JLd.np.random, "default_rng",
                            lambda seed: _Fixed(perm))
        seen = []
        for k in range(shards):
            ours = DataLoader(_Range(n), bsz, shuffle=shuffle, num_workers=0,
                              shard_index=k, num_shards=shards, **kw)
            theirs = JLd.DataLoader(_Range(n), bsz, shuffle=shuffle,
                                    num_workers=0, shard_index=k,
                                    num_shards=shards, **kw)
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            assert len(ours) == len(theirs)
            got, want = ours._batch_indices(), theirs._batch_indices()
            assert len(got) == len(want) == len(ours)
            for (gi, gv), (wi, wv) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gv, wv)
            seen += [i for idx, v in got for i, ok in zip(idx, v) if ok]
        if mode == "pad_last" or mode is None:  # every sample once
            assert sorted(seen) == list(range(n))
        else:
            assert len(seen) == len(set(seen)) == (n // (bsz * shards)) * bsz * shards


def test_sharded_loader_refuses_uneven_shards():
    """The deadlock guard: without drop_last or pad_last, shards of a set
    that is not a multiple of the global batch would yield different
    batch counts; both loaders refuse it."""
    for cls in (DataLoader, JLd.DataLoader):
        with pytest.raises(ValueError, match="not a multiple of"):
            cls(_Range(19), 2, shard_index=0, num_shards=3)
        assert len(cls(_Range(18), 2, shard_index=2, num_shards=3)) == 3


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return F.generate_fixture(tmp_path_factory.mktemp("simbev"), num_scenes=5,
                              samples_per_scene=3, H=64, W=128, grid=16)


def test_compile_data_shards(fixture_root):
    """compile_data's shards: one global shuffle, the train dataset's
    draws seeded seed + shard, a padded val set split over the shards."""
    kw = dict(version="unused", dataroot=fixture_root,
              data_aug_conf=DataAugConf(H=64, W=128, final_dim=(32, 64)),
              grid_conf=GridConf(xbound=(-50.0, 50.0, 6.25),
                                 ybound=(-50.0, 50.0, 6.25)),
              bsz=2, nworkers=0, seed=5)
    loaders = [compile_data(**kw, shard_index=k, num_shards=2) for k in (0, 1)]
    train0, val0 = loaders[0]
    assert (len(train0), len(val0)) == (3, 1)  # 12 train, 3 val samples
    assert [t.shard_index for t, _ in loaders] == [0, 1]
    g = torch.Generator().manual_seed(6)
    assert torch.equal(loaders[1][0].dataset.generator.get_state(), g.get_state())
    masks = [next(iter(v))[7] for _, v in loaders]
    assert [m.tolist() for m in masks] == [[1.0, 1.0], [1.0, 0.0]]


TINY = dict(nepochs=3, H=64, W=128, final_dim=(32, 64), xbound=(-50.0, 50.0, 6.25),
            ybound=(-50.0, 50.0, 6.25), dbound=(4.0, 36.0, 8.0), bsz=2,
            nworkers=1, iou_log_step=1, variant="slim", device="cpu")


def _records(logdir):
    return [json.loads(line) for line in open(os.path.join(logdir, "metrics.jsonl"))]


@pytest.mark.parametrize("mode", [
    {"fused_dw": True, "ema_decay": 0.9, "ema_bn_recal": 2},
    {"cam_devices": 2, "ema_decay": 0.9, "ema_bn_recal": 2}])
def test_train_on_two_ranks(fixture_root, tmp_path, mode):
    """train(n_devices=2, device="cpu") spawns two gloo ranks: data
    parallel (fused_dw) or camera parallel (2 cam ranks, figures on: their
    prediction is a collective), each validating its EMA after a
    recalibration across the ranks (with fused_dw, through the depthwise
    kernel's averaged sums). Only rank 0 writes: one metrics line a step
    and name, the checkpoint files once; the returned weights are rank 0's
    final checkpoint; a resume continues at the saved counter."""
    logdir = str(tmp_path / "run")
    out = train(fixture_root, **TINY, n_devices=2, **mode, max_steps=4,
                val_step=2, save_step=2, viz_step=2, logdir=logdir)
    assert out["counter"] == 4 and out["state"] is None
    recs = _records(logdir)
    keys = [(r["step"], k) for r in recs for k in r if k not in ("step", "time")]
    assert len(keys) == len(set(keys))
    assert [r["step"] for r in recs if "val/iou" in r] == [2, 4]
    assert sorted(r["step"] for r in recs if "train/iou" in r) == [1, 2, 3, 4]
    ckpts = os.path.join(logdir, "ckpts")
    assert sorted(os.listdir(ckpts)) == ["model_000002.pt", "model_000004.pt",
                                         "model_best.pt", "model_final.pt"]
    final = load_checkpoint(os.path.join(ckpts, "model_final.pt"))
    for k, v in final["model_state_dict"].items():
        assert torch.equal(out["model_state_dict"][k], v), k
    assert [r["step"] for r in recs if "val/iou_raw" in r] == [2, 4]
    for k, v in final["ema_state_dict"].items():
        assert torch.equal(out["ema_state_dict"][k], v), k
    if "fused_dw" in mode:
        resumed = train(fixture_root, **TINY, n_devices=2, **mode, max_steps=6,
                        val_step=0, save_step=0, logdir=str(tmp_path / "r"),
                        resume=ckpts)
        assert resumed["start_counter"] == 4 and resumed["counter"] == 6
        assert sorted(os.listdir(tmp_path / "r" / "ckpts")) == ["model_final.pt"]


def test_two_ranks_start_from_the_pretrained_trunk(fixture_root, tmp_path):
    """train(n_devices=2, pretrained_trunk=file) on two gloo ranks of one
    group (``fused_dw``): each rank merges the file itself, to the same
    trunk, before rank 0's weights are broadcast; after a step at lr 0
    both ranks hold the file's trunk and every parameter and buffer is
    bit-equal across them."""
    from torch_parallel_ranks import run_ranks
    sd = synthetic_imagenet_state_dict("slim", seed=21)
    path = tmp_path / "efficientnet-slim-imagenet.pth"
    torch.save(sd, path)
    kwargs = dict(dataroot=str(fixture_root), **TINY, n_devices=2,
                  fused_dw=True, lr=0.0, weight_decay=0.0, max_steps=1,
                  val_step=0, save_step=0, viz_step=0,
                  pretrained_trunk=str(path), logdir=str(tmp_path / "run"))
    outs = run_ranks(tmp_path / "ranks", 2, "pretrained_train",
                     {"kwargs": kwargs})
    assert [len(o["merged"]) for o in outs] == [1, 1]
    assert outs[0]["merged"] == outs[1]["merged"]
    assert outs[0]["digest"] == outs[1]["digest"]
    want = imagenet_trunk_state_dict(sd, "slim")
    for out in outs:
        for k, v in out["trunk"].items():
            assert torch.equal(v, want[k]), k


def test_multihost_launch_agrees_on_a_signal():
    """The launcher's environment on 2 nodes x 2 ranks (localhost):
    train(multihost=True) with validation and rank-0 checkpoints, a
    resume, and a SIGTERM on rank 1 alone after which every rank stops at
    the same step, the replicas bit-equal."""
    out = subprocess.run(
        [sys.executable, "-m", "lss_carla_torch.parallel.dryrun", "--cli",
         "--timeout", "240"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert "MULTIHOST CLI DRYRUN OK" in out.stdout


def test_dryrun_multichip():
    losses = dryrun_multichip(4)
    assert set(losses) == {"data", "camera", "grid"}
    assert all(np.isfinite(v) for v in losses.values())
    with pytest.raises(ValueError, match="unknown flavours"):
        dryrun_multichip(4, flavours=("data", "pipeline"))
