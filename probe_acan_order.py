"""Whether the dense-attention training phases or the allocator setting
slow ``chip_smoke.py``'s ACAN phase into re-issuing tasks without crashes.

Runs ``chip_smoke.acan_path`` (full-width smollm_360m through the ACAN
runner, without and with handler crashes) ``--reps`` times in each of four
fresh processes: alone, and right after ``chip_smoke.dense_train`` of
h2o_danube_1_8b and gemma3_12b as the script orders them, each with
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True`` and without it. For
each run it records the crash-free run's re-issues, its step seconds and
the seconds of its rounds that ended at their deadline, the crash run's,
the allocator's device allocations, frees and retries during the run, the
memory reserved and allocated before it, the objects the garbage collector
tracks and the seconds of a full collection before it, and the host seconds
of a fixed pure-Python loop (the host's speed). A failed train phase (an
out-of-memory error without the setting) is recorded and the ACAN runs go
on.

Usage::

    python3 probe_acan_order.py [--reps 2] [--out chiprun_out/probe_acan_order.json]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
VARIANTS = (("alone", True), ("alone", False), ("after_dense", True), ("after_dense", False))
ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def _host_s() -> float:
    """Seconds of a fixed pure-Python loop."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(3_000_000):
        acc += i * i % 7
    return time.perf_counter() - t0


def _variant(order: str, reps: int) -> dict:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.tile_matmul import kernel as tm_kernel
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.ts_exec import step_runner

    _build.build_all()
    counters = {"tile_matmul": tm_kernel.tile_matmul,
                "flash_attention": fa_kernel.flash_attention,
                "flash_attention_bwd": fa_kernel.flash_attention_bwd,
                "ssd_scan": ssd_kernel.ssd_scan, "ssd_scan_bwd": ssd_kernel.ssd_scan_bwd}
    out: dict = {"alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"), "order": order,
                 "host_s_start": _host_s(), "trains": {}}
    if order == "after_dense":
        for arch in ("h2o_danube_1_8b", "gemma3_12b"):
            t0 = time.perf_counter()
            try:
                rec = cs.dense_train(train, M, steps_mod, get_config, arch, counters)
                out["trains"][arch] = dict(median_step_s=rec["median_step_s"],
                                           peak_mem_bytes=rec["peak_mem_bytes"],
                                           alloc_retries=rec.get("alloc_retries"))
            except Exception as e:  # noqa: BLE001 - a failed phase is a reading here
                out["trains"][arch] = {"error": repr(e)[:400]}
                del e
            out["trains"][arch]["seconds"] = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache()
    cfg = get_config("smollm_360m")
    out["runs"] = []
    for _ in range(reps):
        t0 = time.perf_counter()
        gc.collect()
        before = dict(gc_s=time.perf_counter() - t0, gc_objects=len(gc.get_objects()),
                      reserved=torch.cuda.memory_reserved(),
                      allocated=torch.cuda.memory_allocated(), host_s=_host_s())
        stats = torch.cuda.memory_stats()
        try:
            rec, failed = cs.acan_path(step_runner, M, cfg, counters), None
        except AssertionError as e:
            rec = e.args[0] if e.args and isinstance(e.args[0], dict) else {}
            failed = repr(e)[:300] if not rec else "assertion on the record"
        after = torch.cuda.memory_stats()
        run = dict(before=before, failed=failed,
                   alloc={k: after.get(k, 0) - stats.get(k, 0) for k in ALLOC_KEYS})
        run |= {k: rec.get(k) for k in ("reissues", "crashes", "reissues_crash", "crashes_crash",
                                        "step_s", "median_step_s", "step_s_crash",
                                        "timeout_wait_s_clean", "timeout_wait_s")}
        out["runs"].append(run)
        print(json.dumps(run), flush=True)
        torch.cuda.empty_cache()
    out["host_s_end"] = _host_s()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "probe_acan_order.json"))
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.variant:
        print("RESULT " + json.dumps(_variant(args.variant, args.reps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_acan_order: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = {"nvidia_smi": smi, "variants": []}
    for order, expandable in VARIANTS:
        env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=f"expandable_segments:{expandable}")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, __file__, "--variant", order,
                               "--reps", str(args.reps)], env=env, capture_output=True,
                              text=True, cwd=ROOT)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        rec = json.loads(lines[-1][7:]) if lines else {"stderr": proc.stderr[-2000:]}
        rec |= dict(expandable_segments=expandable, rc=proc.returncode,
                    seconds=time.perf_counter() - t0)
        out["variants"].append(rec)
        print(f"{order} expandable_segments={expandable}: rc {proc.returncode}, "
              f"{json.dumps(rec)[:3000]}", flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
