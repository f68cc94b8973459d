#!/usr/bin/env python3
"""Where a train step's time goes: full-width smollm_360m, 8 x 512 tokens,
bf16, on one CUDA device.

Times (host clock around work that ends in ``torch.cuda.synchronize()``,
median of 3 after one warm-up step) the whole train step, AdamW alone, the
loss with its gradients alone, and the forward alone without autograd; then
traces the gradient pass and AdamW with ``torch.profiler`` and prints each
one's device kernel time and the host operations that take the most of
their own time (traced, so inflated). Imports neither JAX nor the JAX
package.

Usage (from the repository root, on a host with a CUDA device)::

    python3 probe_train_step.py

Results go to ``chiprun_out/probe_train_step.json`` as well.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def _wall_ms(fn, n: int = 3) -> float:
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2] * 1e3


def _trace(fn) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA) / 1e3
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:15]
    return {"device_ms": device_ms,
            "top_host": [{"name": e.key[:60], "self_ms": e.self_cpu_time_total / 1e3,
                          "calls": e.count} for e in host]}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_train_step: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels import _build
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import (OptConfig, adamw_update, init_opt_state,
                                             tree_leaves, tree_map)

    _build.build_all()
    cfg = get_config("smollm_360m")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    opt = OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=5, weight_decay=0.0)
    state = init_opt_state(params, opt)
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=8, seq=512,
                                         mode="cyclic")).batch_at(0)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    step = make_train_step(cfg, opt)
    grads = tree_map(torch.clone, params)

    def adamw():
        adamw_update(params, grads, state, opt)

    def loss_and_grads():
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = M.train_loss(leaves, cfg, batch)
        torch.autograd.grad(loss, tree_leaves(leaves))

    def forward():
        with torch.no_grad():
            M.train_loss(params, cfg, batch)

    step(params, state, batch)
    out = {"device": torch.cuda.get_device_name(0),
           "step_ms": _wall_ms(lambda: step(params, state, batch)),
           "adamw_ms": _wall_ms(adamw), "loss_and_grads_ms": _wall_ms(loss_and_grads),
           "forward_ms": _wall_ms(forward),
           "trace": {"loss_and_grads": _trace(loss_and_grads), "adamw": _trace(adamw)}}
    for k in ("step_ms", "adamw_ms", "loss_and_grads_ms", "forward_ms"):
        print(f"{k}: {out[k]:.3f}")
    for name, tr in out["trace"].items():
        print(f"{name}: device {tr['device_ms']:.3f} ms; host top "
              + ", ".join(f"{h['name']} {h['self_ms']:.2f} ms x{h['calls']}"
                          for h in tr["top_host"][:8]))
    path = ROOT / "chiprun_out" / "probe_train_step.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
