"""The port's stall watchdog (``training/watchdog.py``) and supervisor
(``utils/supervise.py``), mirroring ``tests/test_watchdog.py`` and
``tests/test_supervise.py`` with the port's file checkpoints and its
``python -m lss_carla_torch.train`` child; the trainer's watchdog, figure,
profiler and background-save options on a tiny CPU run; and the whole
drill (a stall at step 3, the watchdog's exit 42, a supervised restart
that resumes) through the CLI."""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from lss_carla_torch.data.fixtures import generate_fixture
from lss_carla_torch.training import loop
from lss_carla_torch.training.watchdog import WATCHDOG_EXIT, StallWatchdog
from lss_carla_torch.utils.checkpoint import CheckpointManager, load_checkpoint
from lss_carla_torch.utils.logging import MetricLogger
from lss_carla_torch.utils.supervise import (child_argv, has_checkpoint,
                                             run_supervised, strip_flag)

REPO = Path(__file__).resolve().parent.parent


def _collector():
    msgs = []
    return msgs, msgs.append


# --- the watchdog (tests/test_watchdog.py)


def test_not_armed_until_first_beat():
    msgs, warn = _collector()
    wd = StallWatchdog(0.2, warn_fn=warn).start()
    time.sleep(0.7)      # far past the timeout, but no beat ever arrived
    wd.stop()
    assert msgs == []    # step 1 can take long: silent until armed


def test_warns_on_stall_and_recovers_on_beat():
    msgs, warn = _collector()
    # a generous threshold over the heartbeat (~7x): a loaded machine can
    # stall the test thread for hundreds of ms between beats
    wd = StallWatchdog(1.0, warn_fn=warn).start()
    wd.beat()
    for _ in range(4):          # steady heartbeats: no warning
        time.sleep(0.15)
        wd.beat()
    assert msgs == []
    time.sleep(2.2)             # stall
    assert len(msgs) == 1 and "no step progress" in msgs[0]
    wd.beat()                   # progress resumes
    time.sleep(1.8)             # stall again -> warns again (flag reset)
    wd.stop()
    assert len(msgs) == 2


def test_abort_fires_after_threshold():
    msgs, warn = _collector()
    codes = []
    wd = StallWatchdog(0.2, abort_after=0.4, abort_fn=codes.append,
                       warn_fn=warn).start()
    wd.beat()
    time.sleep(1.2)
    wd.stop()
    assert codes and codes[0] == WATCHDOG_EXIT == 42
    assert any("hard-exiting" in m for m in msgs)


def test_pause_disarms_until_next_beat():
    """pause() silences the watchdog through a slow checkpoint write."""
    msgs, warn = _collector()
    codes = []
    wd = StallWatchdog(0.3, abort_after=2.0, abort_fn=codes.append,
                       warn_fn=warn).start()
    wd.beat()
    wd.pause()              # entering a long save
    time.sleep(1.0)         # far past the warn timeout
    assert msgs == [] and codes == []
    wd.beat()               # save done, re-armed
    time.sleep(0.7)         # past warn, below abort
    wd.stop()
    assert len(msgs) == 1 and codes == []   # detection works after re-arm


def test_abort_after_must_cover_timeout():
    with pytest.raises(ValueError):
        StallWatchdog(10.0, abort_after=5.0)


# --- the supervisor (tests/test_supervise.py)


def test_strip_flag_forms():
    argv = ["--a", "1", "--supervise", "3", "--b", "--supervise=2", "--c", "x"]
    assert strip_flag(argv, "--supervise") == ["--a", "1", "--b", "--c", "x"]


def test_first_attempt_keeps_user_resume(tmp_path):
    argv = ["--logdir", "L", "--supervise", "2", "--resume", "/old/ckpts"]
    assert child_argv(argv, 0, str(tmp_path / "ckpts")) == \
        ["--logdir", "L", "--resume", "/old/ckpts"]


@pytest.mark.parametrize("name", ["model_000100.pt", "model_final.pt"])
def test_retry_points_resume_at_logdir_ckpts(tmp_path, name):
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    (ckpts / name).touch()
    argv = ["--logdir", "L", "--supervise", "2", "--resume", "/old/ckpts"]
    assert child_argv(argv, 1, str(ckpts)) == \
        ["--logdir", "L", "--resume", str(ckpts)]


def test_retry_without_checkpoint_starts_fresh(tmp_path):
    """Before the first save a retry starts afresh: resuming a directory
    without a numbered or final checkpoint would fail. model_best.pt
    alone does not count (``--resume DIR`` reads numbered and final
    files), nor do temporary files of a write cut short."""
    ckpts = tmp_path / "ckpts"  # does not exist
    argv = ["--logdir", "L", "--supervise", "2"]
    assert child_argv(argv, 1, str(ckpts)) == ["--logdir", "L"]
    ckpts.mkdir()
    for name in ("metrics.txt", "model_best.pt", ".model_000004.pt.77.tmp"):
        (ckpts / name).touch()
    assert not has_checkpoint(str(ckpts))
    assert child_argv(argv, 1, str(ckpts)) == ["--logdir", "L"]


STUB = textwrap.dedent("""\
    import os, sys
    marker = sys.argv[sys.argv.index("--marker") + 1]
    n = len(open(marker).readlines()) if os.path.exists(marker) else 0
    with open(marker, "a") as f:
        f.write(" ".join(sys.argv[1:]) + "\\n")
    sys.exit(42 if n < %d else %d)
""")


def _run_stub(tmp_path, fail_times, final_rc, retries):
    script = tmp_path / "stub.py"
    script.write_text(STUB % (fail_times, final_rc))
    marker = tmp_path / "marker.txt"
    logdir = tmp_path / "log"
    (logdir / "ckpts").mkdir(parents=True)
    (logdir / "ckpts" / "model_000002.pt").touch()
    rc = run_supervised(
        retries, str(logdir),
        argv=["--marker", str(marker), "--supervise", str(retries)],
        command=[sys.executable, str(script)])
    lines = marker.read_text().splitlines() if marker.exists() else []
    return rc, lines


@pytest.mark.parametrize("fail_times,final_rc,retries,want_rc,runs", [
    (2, 0, 3, 0, 3),               # restarts on 42, then succeeds
    (0, 7, 3, 7, 1),               # a crash does not restart
    (99, 0, 2, WATCHDOG_EXIT, 3),  # gives up: 1 run + 2 retries
])
def test_run_supervised(tmp_path, fail_times, final_rc, retries, want_rc, runs):
    rc, lines = _run_stub(tmp_path, fail_times, final_rc, retries)
    assert rc == want_rc
    assert len(lines) == runs
    assert "--supervise" not in lines[0] and "--resume" not in lines[0]
    for line in lines[1:]:  # retries resume from the logdir checkpoints
        assert line.endswith(os.path.join("log", "ckpts")) and "--resume" in line


def test_default_child_is_the_trainer_module(tmp_path, capfd):
    """The child is ``python -m lss_carla_torch.train``: under -m,
    sys.argv[0] is the module's file, which cannot run as a script."""
    rc = run_supervised(0, str(tmp_path), argv=["--help"])
    out = capfd.readouterr().out
    assert rc == 0
    assert f"{sys.executable} -m lss_carla_torch.train --help" in out
    assert "--watchdog_secs" in out and "--supervise" in out


TERM_CHILD = textwrap.dedent("""\
    import signal, sys, time
    marker = sys.argv[sys.argv.index("--marker") + 1]
    def on_term(s, f):
        with open(marker, "a") as fh:
            fh.write("child-sigterm\\n")
        sys.exit(42)  # even a 42 must not restart after a forwarded signal
    signal.signal(signal.SIGTERM, on_term)
    with open(marker, "a") as fh:
        fh.write("child-started\\n")
    time.sleep(120)
""")

TERM_RUNNER = textwrap.dedent("""\
    import sys
    from lss_carla_torch.utils.supervise import run_supervised
    sys.exit(run_supervised(3, sys.argv[1], argv=["--marker", sys.argv[2]],
                            command=[sys.executable, sys.argv[3]]))
""")


def test_sigterm_forwards_to_child_and_stops_retrying(tmp_path):
    """timeout, slurm or k8s SIGTERM the supervisor: the child must get it
    (checkpoint and exit) and no restart may follow, so no child is left
    holding the GPU."""
    import signal as _signal
    runner = tmp_path / "runner.py"
    runner.write_text(TERM_RUNNER)
    child = tmp_path / "child.py"
    child.write_text(TERM_CHILD)
    marker = tmp_path / "marker.txt"
    logdir = tmp_path / "log"
    (logdir / "ckpts").mkdir(parents=True)
    (logdir / "ckpts" / "model_000002.pt").touch()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(REPO), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.Popen(
        [sys.executable, str(runner), str(logdir), str(marker), str(child)],
        cwd=REPO, env=env)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        if marker.exists() and "child-started" in marker.read_text():
            break
        time.sleep(0.1)
    else:
        proc.kill()
        raise AssertionError("child never started")
    proc.send_signal(_signal.SIGTERM)
    rc = proc.wait(timeout=30)
    lines = marker.read_text().splitlines()
    assert "child-sigterm" in lines           # the signal was forwarded
    assert lines.count("child-started") == 1  # and nothing restarted
    assert rc == 42                           # the child's own exit code


# --- the trainer's options on the CPU


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    return generate_fixture(tmp_path_factory.mktemp("simbev"), num_scenes=5,
                            samples_per_scene=2, H=64, W=128, grid=16)


TINY = dict(nepochs=3, H=64, W=128, final_dim=(32, 64),
            xbound=(-50.0, 50.0, 6.25), ybound=(-50.0, 50.0, 6.25),
            dbound=(4.0, 36.0, 8.0), bsz=2, nworkers=1, iou_log_step=1,
            variant="slim", device="cpu")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_with_watchdog_figures_profile_and_async_save(
        fixture_root, tmp_path, monkeypatch, one_thread):
    """train() with every new option finishes: the watchdog never fires
    (it is stopped at the end), a train figure every viz_step steps and a
    val figure after each validation reach the logger, the profiler trace
    is written, and the background periodic saves are on disk, whole."""
    figures = []
    monkeypatch.setattr(MetricLogger, "figure",
                        lambda self, step, tag, fig: figures.append((step, tag)))
    logdir = tmp_path / "run"
    out = loop.train(fixture_root, **TINY, max_steps=4, val_step=2,
                     save_step=2, viz_step=3, watchdog_secs=60,
                     profile_dir=str(tmp_path / "prof"), async_save=True,
                     logdir=str(logdir))
    assert out["counter"] == 4
    assert figures == [(2, "val/visualization"), (3, "train/visualization"),
                       (4, "val/visualization")]
    traces = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    ckpts = logdir / "ckpts"
    assert {"model_000002.pt", "model_000004.pt", "model_best.pt",
            "model_final.pt"} <= {p.name for p in ckpts.iterdir()}
    assert load_checkpoint(ckpts / "model_000004.pt")["counter"] == 4


def test_figure_errors_are_reported_but_predictions_are_not_guarded(
        fixture_root, tmp_path, monkeypatch, capsys, one_thread):
    """Only the rendering and logging of a figure are guarded: a figure
    that fails is reported and training goes on; a failing prediction
    (the model's forward, the splat kernel on the card) stops the run."""
    import lss_carla_torch.utils.viz as viz

    def broken_figure(*a, **k):
        raise RuntimeError("no display")

    monkeypatch.setattr(viz, "make_bev_figure", broken_figure)
    out = loop.train(fixture_root, **TINY, max_steps=2, val_step=2,
                     save_step=0, viz_step=1, logdir=str(tmp_path / "a"))
    assert out["counter"] == 2
    assert "train/visualization failed: RuntimeError: no display" in \
        capsys.readouterr().out

    def broken_predict(model, device="cuda"):
        def predict(state, inputs):
            raise RuntimeError("device fault")
        return predict

    monkeypatch.setattr(loop, "make_predict_step", broken_predict)
    with pytest.raises(RuntimeError, match="device fault"):
        loop.train(fixture_root, **TINY, max_steps=2, val_step=0,
                   save_step=0, viz_step=1, logdir=str(tmp_path / "b"))


def test_async_save_writes_a_snapshot(tmp_path):
    """A background periodic save holds the weights and optimizer state of
    the moment it was asked for, not of later steps; synchronous saves wait
    for it first."""
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    want = {k: v.clone() for k, v in model.state_dict().items()}
    moment = opt.state_dict()["state"][0]["exp_avg"].clone()
    mgr = CheckpointManager(tmp_path, async_save=True)
    path = mgr.save(1, model, opt, 0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    opt.step()
    mgr.save_best(1, model, opt, 0, 0.5)
    mgr.close()
    ck = load_checkpoint(path)
    for k, v in want.items():
        torch.testing.assert_close(ck["model_state_dict"][k], v, rtol=0, atol=0)
    torch.testing.assert_close(ck["optimizer_state_dict"]["state"][0]["exp_avg"],
                               moment, rtol=0, atol=0)
    assert not list(tmp_path.glob(".*.tmp"))


def test_supervised_watchdog_drill_through_the_cli(fixture_root, tmp_path):
    """The drill on the CPU: ``--supervise 1 --watchdog_secs 2
    --debug_stall_at 3 --save_step 2 --max_steps 6``. The first child
    hangs at step 3, dumps its stacks and exits 42 after 2 x 2 s; the
    second starts with --resume <logdir>/ckpts, continues from step 2 and
    ends at step 6; the supervisor returns 0."""
    logdir = tmp_path / "drill"
    cmd = [sys.executable, "-m", "lss_carla_torch.train", "--dataroot",
           str(fixture_root), "--device", "cpu", "--H", "64", "--W", "128",
           "--final_h", "32", "--final_w", "64", "--xbound", "-50", "50",
           "6.25", "--ybound", "-50", "50", "6.25", "--dbound", "4", "36",
           "8", "--bsz", "2", "--nworkers", "1", "--nepochs", "3",
           "--variant", "b0", "--val_step", "0", "--viz_step", "0",
           "--iou_log_step", "1", "--logdir", str(logdir), "--supervise", "1",
           "--watchdog_secs", "2", "--debug_stall_at", "3", "--save_step",
           "2", "--max_steps", "6"]
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=240, env=env)
    log = out.stdout + out.stderr
    assert out.returncode == 0, log[-4000:]
    assert "injected stall at step 3" in log
    assert "no step progress" in log and "Current thread" in log  # stacks
    assert "child exited rc=42" in log and "child exited rc=0" in log
    attempts = [ln for ln in out.stdout.splitlines()
                if ln.startswith("[supervise] attempt")]
    assert len(attempts) == 2 and "--resume" not in attempts[0]
    assert attempts[1].endswith(f"--resume {logdir / 'ckpts'}")
    assert "Resumed from step 2" in out.stdout
    assert load_checkpoint(logdir / "ckpts" / "model_final.pt")["counter"] == 6
