#!/usr/bin/env python3
"""Where ``chip_smoke.py``'s time goes: its ``main()`` run with host-clock
timers around its parts, by device.

Every check, time and phase function of ``chip_smoke.py``, the model's
``init_params`` / ``prefill`` / ``decode_step`` / ``train_loss``, the
optimizer's ``init_opt_state``, the train step's ``adamw_update``,
``torch.autograd.grad`` and ``chip_smoke._to`` are wrapped: each call's
seconds (the card synchronized before and after) are summed under its name
and the device of its first tensor argument (``prefill@cpu``), grouped by
the ``{"phase": ...}`` record printed last before the call. Nested calls
are counted in each wrapper, so the parts of one group overlap. The
script's own ``phase seconds:`` line is printed as usual; the synchronizing
makes them somewhat longer than an untimed run's.

With ``--host-copy`` it first times copies of a 4 GiB float32 card tensor
to the host: pageable (``.to("cpu")``), into host pages touched first,
into pinned memory, and in runs through a 256 MB pinned buffer (as
``chip_smoke._host_copy``).

Usage (GPU host, from the repository root; about as long as
``chip_smoke.py``)::

    python3 probe_smoke_split.py [--host-copy]

Writes ``chiprun_out/probe_smoke_split.json``: {group: {part: seconds}}.
"""

from __future__ import annotations

import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "probe_smoke_split.json"

PARTS = ("serve_path", "profile_steps", "parity_f32", "parity_moe_f32", "_f32_logits",
         "train_path", "profile_train_step", "_train_steps_f32", "_compare_train_steps",
         "remat_determinism", "acan_path", "acan_deepseek", "profile_acan_step",
         "parity_acan_f32", "paper_path", "parity_mlp_f32", "cloud_tenants", "process_fleet",
         "moe_path", "check_tile_matmul", "check_flash", "check_ssd", "check_tile_matmul_grad",
         "check_flash_bwd", "check_dense_projections", "check_ssd_bwd", "check_moe_batched",
         "check_mlp_ops", "check_moe_ops", "time_tile_matmul", "time_flash", "time_ssd",
         "time_tile_matmul_grad", "time_flash_bwd", "time_ssd_bwd", "time_moe_batched",
         "time_moe_batched_grad", "kernel_build_report")


def host_copy_times(torch) -> dict:
    """Seconds of each way to copy a 4 GiB float32 card tensor to the host,
    twice each."""
    t = torch.randn(1 << 30, device="cuda")

    def timed(fn):
        torch.cuda.synchronize()
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - start

    def touched():
        d = torch.empty(t.shape)
        d.zero_()
        d.copy_(t)

    def pinned():
        torch.empty(t.shape, pin_memory=True).copy_(t)

    def runs():
        buf = torch.empty(1 << 26, pin_memory=True)
        d = torch.empty(t.shape)
        for i in range(0, t.numel(), buf.numel()):
            n = min(buf.numel(), t.numel() - i)
            buf[:n].copy_(t[i:i + n])
            d[i:i + n].copy_(buf[:n])

    ways = {"pageable": lambda: t.to("cpu"), "touched_first": touched, "pinned": pinned,
            "through_256MB_pinned": runs}
    return {name: [timed(fn) for _ in range(2)] for name, fn in ways.items()}


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import model as M
    from repro_torch.optim import optimizer as opt_mod

    times: dict = {}
    group = ["start"]
    inside_to = [False]

    def device_of(args, kwargs) -> str:
        for x in (*args, *kwargs.values()):
            for v in (x.values() if isinstance(x, dict) else
                      x if isinstance(x, (list, tuple)) else (x,)):
                if isinstance(v, torch.Tensor):
                    return v.device.type
        return ""

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            dev = device_of(args, kwargs)
            key = f"{name}@{dev}" if dev else name
            torch.cuda.synchronize()
            start = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                part = times.setdefault(group[0], {})
                part[key] = part.get(key, 0.0) + time.perf_counter() - start
        return wrapper

    if "--host-copy" in argv:
        times["host_copy_4GiB_s"] = host_copy_times(torch)
        print("host copies of 4 GiB (s):", times["host_copy_4GiB_s"], flush=True)
    for name in PARTS:  # an older tree may lack some
        if hasattr(cs, name):
            setattr(cs, name, timed(name, getattr(cs, name)))
    for name in ("init_params", "train_loss", "prefill", "decode_step"):
        setattr(M, name, timed(name, getattr(M, name)))
    opt_mod.init_opt_state = timed("init_opt_state", opt_mod.init_opt_state)
    steps_mod.adamw_update = timed("adamw_update", steps_mod.adamw_update)
    torch.autograd.grad = timed("autograd.grad", torch.autograd.grad)
    to, to_timed = cs._to, timed("_to", cs._to)

    def outer_to(tree, device):  # a tree's copy once, not each leaf's
        if inside_to[0]:
            return to(tree, device)
        inside_to[0] = True
        try:
            return to_timed(tree, device)
        finally:
            inside_to[0] = False

    cs._to = outer_to
    record = cs._record

    def regroup(phase, out):
        record(phase, out)
        group[0] = "after " + phase

    cs._record = regroup
    try:
        return cs.main()
    finally:
        OUT.parent.mkdir(exist_ok=True)
        OUT.write_text(json.dumps(times, indent=1))


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
