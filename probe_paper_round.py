#!/usr/bin/env python3
"""Where a round of the paper's MLP experiment goes, on the card and on the
CPU.

Runs experiment 1 at the paper's width (N = 256 -> 256 -> 1, task cap 256,
pouch 100, 4 handler threads; one epoch of ``n_samples`` samples, 8 by
default) through the port's ``ACANCloud`` three ways:

- on the card under ``torch.profiler``: the device's kernel time, its busy
  share of the traced run's wall time, and the kernels that took it;
- on the card untraced, with the five op bodies (on the handler threads)
  and the program's combines (on the Manager thread) timed on the host
  clock: their seconds beside the run's wall time and the handlers'
  emulated compute (``handler_busy_time``);
- on the CPU, the same, with tile_matmul's plain version for the products.

Usage (from the repository root; the card needs the CUDA toolkit)::

    python3 probe_paper_round.py [n_samples]

Prints one JSON object and writes it to ``chiprun_out/probe_paper_round.json``.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OPS = ("forward", "activation", "loss", "backward", "update")


def _timed_cloud(n_samples: int, device: str):
    """A cloud running exp 1 whose op bodies and combines add their host
    seconds to the returned dict."""
    from repro_torch.configs import paper_mlp
    from repro_torch.core import ACANCloud, MLPProgram
    from repro_torch.core.program import GLOBAL_OPS, OpRegistry

    cfg = paper_mlp.feasibility_config(epochs=1, n_samples=n_samples, device=device)
    prog = MLPProgram(cfg.layers, epochs=1, n_samples=n_samples, seed=cfg.seed,
                      device=device)
    secs: dict = defaultdict(float)
    calls: dict = defaultdict(int)
    lock = threading.Lock()

    def timed(name, fn):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                with lock:
                    secs[name] += time.perf_counter() - t0
                    calls[name] += 1
        return run

    prog.registry = OpRegistry(parent=GLOBAL_OPS)
    for op in OPS:
        spec = GLOBAL_OPS.resolve(op)
        prog.registry.register(dataclasses.replace(spec, batch_fn=timed(f"op {op}",
                                                                        spec.batch_fn)))
    combine = prog.combine
    prog.combine = lambda ts, rnd, stage, mgr: timed(
        f"combine {stage.partition('_')[0]}", combine)(ts, rnd, stage, mgr)
    return ACANCloud(cfg, program=prog), secs, calls


def _untraced(n_samples: int, device: str) -> dict:
    cloud, secs, calls = _timed_cloud(n_samples, device)
    t0 = time.perf_counter()
    res = cloud.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    assert len(res.loss_history) == n_samples and res.ledger_ok, res
    return dict(wall_s=wall, round_s=wall / n_samples, pouches=res.pouches,
                emulated_compute_s=cloud.handler_busy_time(),
                host_s=dict(secs), calls=dict(calls),
                op_bodies_s=sum(v for k, v in secs.items() if k.startswith("op ")),
                combines_s=sum(v for k, v in secs.items() if k.startswith("combine ")))


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_paper_round: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 1
    n_samples = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build_all(("tile_matmul",))
    _untraced(2, "cuda")                           # warm: load, first launches

    cloud, _, _ = _timed_cloud(n_samples, "cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cloud.run()
        torch.cuda.synchronize()
        traced_wall = time.perf_counter() - t0
    kern = sorted(((e.key, getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count)
                   for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in kern)
    out = dict(nvidia_smi=smi, n_samples=n_samples,
               traced=dict(wall_s=traced_wall, device_ms=device_ms,
                           busy_share=device_ms / (traced_wall * 1e3),
                           kernel_launches=sum(r[2] for r in kern),
                           top_kernels=[dict(name=k[:80], ms=t, calls=c)
                                        for k, t, c in kern[:8]]),
               cuda=_untraced(n_samples, "cuda"),
               cpu=_untraced(n_samples, "cpu"))
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe_paper_round.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
