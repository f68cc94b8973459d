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

Then four handlers run ``--steps`` steps with the program's gradient lock
and with it taken out (each gradient free to interleave with the others, as
before the lock), ``--reps`` times each, on an idle host and beside
``--load`` processes that spin a CPU core each (a host shared with other
work). For each run: every round's seconds, the GSS deadline it had and
their largest ratio (a round re-issues its tasks once the ratio reaches 1),
the re-issues and the median step. The spinning processes are stopped
before the probe ends. Imports neither JAX nor the JAX package.

Usage (from the repository root, on a host with a CUDA device)::

    python3 probe_acan_step.py [--steps 12] [--reps 2] [--load 8]

Results go to ``chiprun_out/probe_acan_step.json`` as well.
"""

from __future__ import annotations

import argparse
import contextlib
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


def _rounds(runner) -> list[dict]:
    """Each round's seconds and the deadline it ran under (the timeout the
    previous round left, the configured one for the first), in order."""
    from repro_torch.core.space import ANY

    hist = sorted((k[2], runner.ts.try_read(k)[1])
                  for k in runner.ts.keys(("thist", ANY, ANY)))
    deadline = runner.tcfg.timeout
    out = []
    for _, h in hist:
        out.append(dict(elapsed=h["elapsed"], deadline=deadline, done_frac=h["done_frac"]))
        deadline = h["timeout"]
    return out


def _spinners(n: int) -> list:
    return [subprocess.Popen([sys.executable, "-c", "while True: pass"]) for _ in range(n)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--load", type=int, default=8)
    args = ap.parse_args()
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

    out["lock"] = []
    for load in (0, args.load):
        for locked in (True, False):
            for rep in range(args.reps):
                runner = ACANStepRunner(cfg, ACANTrainConfig(n_handlers=4, **(RUN | {
                    "steps": args.steps})))
                runner.ts.put(("params", 0), params)
                runner.warm_up()
                if not locked:
                    runner.program._grad_lock = contextlib.nullcontext()
                torch.cuda.synchronize()
                procs = _spinners(load)
                try:
                    t0 = time.time()
                    res = runner.run()
                finally:
                    for pr in procs:
                        pr.kill()
                        pr.wait()
                steps = step_seconds(runner, t0)
                rounds = _rounds(runner)
                rec = dict(load=load, locked=locked, rep=rep, reissues=res.reissues,
                           median_step_s=float(np.median(steps[1:])), step_s=steps,
                           max_round_over_deadline=max(r["elapsed"] / r["deadline"]
                                                       for r in rounds),
                           rounds=rounds, losses=res.losses)
                out["lock"].append(rec)
                print(f"load {load}, lock {locked}, rep {rep}: median step "
                      f"{rec['median_step_s']:.4f} s, re-issues {res.reissues}, largest round "
                      f"over its deadline {rec['max_round_over_deadline']:.3f}, steps {steps}",
                      flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "probe_acan_step.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
