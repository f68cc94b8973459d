#!/usr/bin/env python3
"""Where an ACAN step's time goes: full-width smollm_360m trained by the
ACAN runner (``repro_torch.ts_exec.step_runner``), bf16, 4 microbatches of
2 x 512 tokens a step, on one CUDA device.

Times one microbatch gradient on this thread alone (host clock around work
that ends in ``torch.cuda.synchronize()``, median of 5 after a warm-up),
the combine's mean-and-update over four gradient trees alone, and then
runs the runner with 1, 2 and 4 handler threads (5 steps each, no crashes,
``local`` backend) and reports the median of steps 2-5 (host clock between
committed versions, from the space's ledger) and its re-issues. The
handlers are threads of one process, so their gradients share one GIL:
the step of n handlers against n = 1 shows what the threads cost or save.
Imports neither JAX nor the JAX package.

Usage (from the repository root, on a host with a CUDA device)::

    python3 probe_acan_step.py

Results go to ``chiprun_out/probe_acan_step.json`` as well.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
RUN = dict(n_micro=4, micro_batch=2, seq=512, steps=5, lr=0.05, ts_backend="local")


def _wall_ms(fn, n: int = 5) -> float:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2] * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_acan_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import model as M
    from repro_torch.ts_exec.step_runner import ACANStepRunner, ACANTrainConfig, step_seconds

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all()
    cfg = get_config("smollm_360m")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    out: dict = {"device": smi}

    runner = ACANStepRunner(cfg, ACANTrainConfig(n_handlers=1, **RUN))
    runner.ts.put(("params", 0), params)
    runner.warm_up()
    prog = runner.program
    batch = prog.batch(0, 0)
    out["grad_ms"] = _wall_ms(lambda: prog.grad(params, batch))
    grads = [prog.grad(params, prog.batch(0, m))[1] for m in range(RUN["n_micro"])]
    out["combine_ms"] = _wall_ms(lambda: prog.update(params, grads))
    del grads
    print(f"one microbatch gradient {out['grad_ms']:.1f} ms, combine {out['combine_ms']:.1f} ms",
          flush=True)

    out["handlers"] = {}
    for n in (1, 2, 4):
        runner = ACANStepRunner(cfg, ACANTrainConfig(n_handlers=n, **RUN))
        runner.ts.put(("params", 0), params)
        runner.warm_up()
        torch.cuda.synchronize()
        t0 = time.time()
        res = runner.run()
        steps = step_seconds(runner, t0)
        rec = dict(step_s=steps, median_step_s=float(np.median(steps[1:])),
                   reissues=res.reissues, losses=res.losses)
        out["handlers"][n] = rec
        print(f"{n} handler(s): median step {rec['median_step_s']:.4f} s, steps {steps}, "
              f"re-issues {res.reissues}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe_acan_step.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
