#!/usr/bin/env python3
"""Where a process-fleet worker's boot goes, on the card.

A worker (``python -m repro_torch.core.workers``) boots from its spawn to
its first ``take_batch`` at the cloud's tuple-space server. This probe
times, each in a fresh interpreter with the port's source root on
``PYTHONPATH`` (``repeats`` times, 3 by default; the median is kept), the
steps that boot is made of, each one including the ones before it:

- ``interpreter``: ``python -c pass``;
- ``import torch``;
- ``import workers``: also ``import repro_torch.core.workers`` (the
  control plane, the tuple-space client, the kernels' wrappers);
- ``import programs``: also ``repro_torch.programs`` (the MLP and MoE
  ops the worker's registry resolves);
- ``cuda context``: also a first tensor on the card;
- ``tile_matmul load``: also the ``ctypes`` load of the built library;

then the whole boot as ``chip_smoke.py`` measures it (``_worker_boot_s``:
spawn to the first ``take_batch`` at a server in this process).

Usage (from the repository root, on a host with a CUDA device)::

    python3 probe_worker_boot.py [repeats]

Prints one JSON object and writes it to ``chiprun_out/probe_worker_boot.json``.
Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "probe_worker_boot.json"

STEPS = (
    ("interpreter", "pass"),
    ("import torch", "import torch"),
    ("import workers", "import torch, repro_torch.core.workers"),
    ("import programs", "import torch, repro_torch.core.workers, repro_torch.programs"),
    ("cuda context", "import torch, repro_torch.core.workers, repro_torch.programs; "
                     "torch.zeros(1, device='cuda')"),
    ("tile_matmul load", "import torch, repro_torch.core.workers, repro_torch.programs; "
                         "from repro_torch.kernels.tile_matmul import kernel; "
                         "torch.zeros(1, device='cuda'); kernel._lib()"),
)


def _run_s(code: str, env: dict) -> float:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=300)
    return time.perf_counter() - t0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_worker_boot: no CUDA device", file=sys.stderr)
        return 1
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import workers
    from repro_torch.kernels import _build

    _build.build_all(("tile_matmul",))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    out: dict = {"device": smi, "repeats": repeats, "steps_s": {}}
    for name, code in STEPS:
        times = [_run_s(code, env) for _ in range(repeats)]
        out["steps_s"][name] = dict(median=statistics.median(times), all=times)
    boots = [chip_smoke._worker_boot_s(workers) for _ in range(repeats)]
    out["boot_s"] = dict(median=statistics.median(boots), all=boots)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
