"""The port's out-of-process handler fleet (``repro_torch.core.workers``)
on the CPU: twins of the reference's ``tests/test_workers.py`` — real
worker processes over the cloud's embedded tuple-space server reproduce
the thread fleet bit for bit, the registry guard refuses programs the
workers cannot resolve, and SIGKILL-mid-round revival keeps exactly-once
training (identical final weights, zero schema violations, zero leaks,
the checked sanitizer hosted server-side) — then what the port adds: a
worker asked for CUDA without a card exits non-zero and says why, a
worker that stops cleanly writes its launch counts, and a running worker
writes them as they change, so a SIGKILLed one leaves them behind.

Parameters that differ from the reference's: every config runs on
``device="cpu"``; the SIGKILL twin kills every 5 s (the reference: 1 s)
with ``time_scale`` 2.5e-3 (5e-4), because a port worker imports torch
and boots in about 1.5-2 s here against the reference's 0.5 s — at a 1 s
interval every generation would die before it took a task.
"""

import json
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

from repro_torch.core import ACANCloud, CloudConfig, FaultPlan, LayerSpec
from repro_torch.core.program import GLOBAL_OPS, OpRegistry
from repro_torch.core import workers
from repro_torch.core.workers import HandlerProcess, ProcessCrashEvent, launch_counts
from repro_torch.kernels import _count
from repro_torch.programs.mlp import MLPProgram

N_LAYERS = 2


def _cfg(**kw):
    base = dict(layers=[LayerSpec(16, 16), LayerSpec(16, 1)],
                n_handlers=2, epochs=1, n_samples=6, task_cap=64.0,
                pouch_size=50, lr=0.05, time_scale=1e-6,
                initial_timeout=0.2, wall_limit=180.0, seed=0,
                ts_backend="checked+sharded:4",
                fault_plan=FaultPlan(interval=1e9), device="cpu")
    base.update(kw)
    return CloudConfig(**base)


def _final_weights(cloud):
    return [cloud.ts.try_read(("w", layer))[1] for layer in range(N_LAYERS)]


@pytest.fixture(scope="module")
def thread_baseline():
    """One fault-free thread-fleet run: the bit-exact reference both
    process-fleet runs must reproduce."""
    cloud = ACANCloud(_cfg(fleet="thread"))
    res = cloud.run()
    assert res.ledger_ok and res.ts_violations == 0
    return [l for _, l in res.loss_history], _final_weights(cloud)


def test_process_fleet_matches_thread_fleet(thread_baseline):
    base_losses, base_w = thread_baseline
    cloud = ACANCloud(_cfg(fleet="process"))
    res = cloud.run()
    assert [l for _, l in res.loss_history] == base_losses
    for got, want in zip(_final_weights(cloud), base_w):
        assert got.device == want.device and torch.equal(got, want)
    assert res.ledger_ok
    assert res.ts_violations == 0, res.ts_violation_samples
    assert res.ts_leaks == {}
    # The workers that stopped cleanly wrote their counters: on the CPU
    # every product takes the plain version, so none launched a kernel.
    counts = res.worker_launches
    assert counts["workers"] >= 1
    assert counts["tile_matmul"]["launches"] == 0
    assert set(counts) == {"workers", "killed"} | set(launch_counts())


def test_sigkill_revival_identical_weights(thread_baseline):
    """Every 5 s the daemon SIGKILLs the whole worker fleet mid-round
    (p=1.0) and respawns real processes — the re-issue/commit-window
    machinery must still apply each sample exactly once: loss trajectory
    and final weights bit-identical to the fault-free reference."""
    base_losses, base_w = thread_baseline
    cloud = ACANCloud(_cfg(
        fleet="process", time_scale=2.5e-3,
        fault_plan=FaultPlan(interval=5.0, p_handler_crash=1.0, seed=1)))
    res = cloud.run()
    assert res.handler_revivals >= 1
    # The killed incarnations' last interval of counts is lost: the sum
    # is a lower bound.
    assert res.worker_launches["killed"] >= 1
    assert len(res.loss_history) == len(base_losses)
    assert [l for _, l in res.loss_history] == base_losses
    for got, want in zip(_final_weights(cloud), base_w):
        assert torch.equal(got, want)
    assert res.ledger_ok
    assert res.ts_violations == 0, res.ts_violation_samples
    assert res.ts_leaks == {}


def test_process_fleet_rejects_custom_registry():
    """Workers resolve ops in the builtin GLOBAL_OPS only — a program
    carrying a private registry can't ship its callables to another
    process, so the cloud must refuse up front, not hang at runtime."""
    prog = MLPProgram([LayerSpec(4, 4)], epochs=1, n_samples=1, device="cpu")
    prog.registry = OpRegistry(parent=GLOBAL_OPS)
    with pytest.raises(ValueError, match="built-in op"):
        ACANCloud(_cfg(fleet="process"), program=prog)


def test_process_crash_event_kills_current_incarnation():
    """ProcessCrashEvent.set() must SIGKILL whatever process it points
    at *now* — the daemon re-points ``proc`` at each respawn."""
    p = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(60)"])
    hp = HandlerProcess(p, name="h0")
    ev = ProcessCrashEvent()
    ev.proc = hp
    assert hp.is_alive()
    ev.set()
    hp.join(5.0)
    assert not hp.is_alive()
    assert ev.kills == 1
    # Event semantics the daemon relies on: never reads as "already set".
    assert not ev.is_set()
    ev.clear()


@pytest.mark.parametrize("device_flag", [["--device", "cuda"], []])
def test_a_worker_asked_for_cuda_without_a_card_exits_and_says_why(device_flag):
    """No fallback: the worker resolves its device (CUDA unless told
    otherwise) before it connects anywhere and exits non-zero, naming
    CUDA, rather than running its ops on the CPU."""
    import os
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=src + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-m", "repro_torch.core.workers",
                          "--addr", "127.0.0.1:9", "--name", "h0", *device_flag],
                         capture_output=True, text=True, timeout=120, env=env)
    assert res.returncode != 0
    assert "CUDA" in res.stderr and "h0" in res.stderr


def test_the_cloud_refuses_a_cuda_process_fleet_without_a_card(monkeypatch):
    """The fleet's device (``CloudConfig.device``, None = CUDA) is resolved
    when the cloud is built, even for a program of its own on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prog = MLPProgram([LayerSpec(4, 4)], epochs=1, n_samples=1, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ACANCloud(_cfg(fleet="process", device=None), program=prog)
    ACANCloud(_cfg(fleet="thread", device=None), program=prog)


def _read_when(path, want, timeout=10.0):
    """The counts file at ``path`` once it holds ``want`` launches of the
    fake kernel (None if it never does within ``timeout``)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if path.exists():
            counts = json.loads(path.read_text())
            if counts["k"]["launches"] == want:
                return counts
        time.sleep(0.005)
    return None


def test_a_running_worker_writes_its_counts_as_they_change(monkeypatch, tmp_path):
    """The flusher a worker runs beside its handler writes the counters
    before any clean stop, again after each change, and only whole files:
    what a SIGKILL finds on disk is the count up to the last interval."""
    fake = types.SimpleNamespace(launches=0, paths={"a": 0, "b": 0})
    monkeypatch.setattr(workers, "_kernel_wrappers", lambda: {"k": fake})
    path = tmp_path / "h0-1.json"
    stop = threading.Event()
    flusher = threading.Thread(target=workers._flush_counts, args=(str(path), stop, 0.01))
    flusher.start()
    try:
        _count.launch(fake, paths="a")
        assert _read_when(path, 1) == {"k": {"launches": 1, "paths": {"a": 1, "b": 0}}}
        _count.launch(fake, paths="b")
        _count.launch(fake, paths="b")
        assert _read_when(path, 3) == {"k": {"launches": 3, "paths": {"a": 1, "b": 2}}}
    finally:
        stop.set()
        flusher.join(timeout=10)
    assert not flusher.is_alive()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["h0-1.json"]
    assert launch_counts() == {"k": {"launches": 3, "paths": {"a": 1, "b": 2}}}
