"""Training runner (port of ``repro/launch/train.py``): journal replay,
checkpoint restore, each step under the watchdog, checkpoints every
``ckpt_every`` steps, a journal record and a log line a step.

Runs on CUDA unless ``device="cpu"`` is passed; with no card it raises.
Data comes from :class:`~repro_torch.data.pipeline.TokenPipeline`, the same
batches the reference reads for a seed, and checkpoints and journal are the
reference's formats, so either package resumes the other's run. One device
needs no sharding rules or mesh: ``model_axis`` must be 1.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm_360m --full \\
        --steps 5 --batch 8 --seq 512
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.checkpoint.journal import TrainJournal
from repro_torch.configs.base import get_config
from repro_torch.data.frontend import pipeline_for
from repro_torch.device import resolve_device
from repro_torch.distributed.watchdog import StepWatchdog
from repro_torch.kernels import _build
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as M
from repro_torch.optim.optimizer import OptConfig, init_opt_state


def train(arch: str, *, reduced: bool = True, steps: int = 20, batch: int = 8,
          seq: int = 64, ckpt_dir: str = "runs", ckpt_every: int = 10,
          model_axis: int = 1, resume: bool = True, seed: int = 0,
          data_mode: str = "cyclic", opt: OptConfig | None = None,
          log=print, device=None, params: dict | None = None) -> dict:
    """``params`` (optional) replaces the seeded random init, e.g. weights
    carried over with :mod:`repro_torch.checkpoint.convert`; the model runs
    at their depth (a model too deep for one card, cut in depth)."""
    if model_axis != 1:
        raise NotImplementedError("model_axis > 1 needs sharding, which is not "
                                  "ported yet (ROADMAP.md, 'Sharding')")
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if params is not None:
        cfg = M.at_depth_of(cfg, params)
    opt = opt or OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=steps,
                           weight_decay=0.0)

    run_dir = os.path.join(ckpt_dir, f"{arch}{'_reduced' if reduced else ''}")
    os.makedirs(run_dir, exist_ok=True)
    journal = TrainJournal(os.path.join(run_dir, "journal.jsonl"))

    pipe = pipeline_for(cfg, batch, seq, seed=seed, mode=data_mode)

    if params is None:
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    opt_state = init_opt_state(params, opt)
    start_step = 0

    # --- recovery: journal replay → (step cursor, checkpoint) -------------
    last = journal.latest() if resume else None
    if last is not None:
        ck = last.get("ckpt")
        if ck and os.path.exists(os.path.join(ck, "manifest.json")):
            _, params, opt_state = load_checkpoint(ck, params, opt_state)
        start_step = int(last["step"]) + 1
        log(f"[recover] resume at step {start_step} "
            f"(journal: {last['step']}, ckpt: {ck})")

    if dev.type == "cuda":
        _build.build_all()   # nvcc's time stays out of the first watched step
    step_fn = make_train_step(cfg, opt)
    watchdog = StepWatchdog()
    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        batch_np = pipe.batch_at(step)
        batch_t = {k: torch.as_tensor(v, device=dev) for k, v in batch_np.items()}
        params, opt_state, metrics = watchdog.run(step_fn, params, opt_state, batch_t)
        loss = metrics["loss"]
        losses.append(loss)
        ckpt = None
        if ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt = save_checkpoint(
                os.path.join(run_dir, f"ckpt_{step}"), step, params, opt_state)
        journal.append({"step": step, "loss": loss, "ckpt": ckpt,
                        "data_cursor": step})
        log(f"step {step:4d} loss {loss:.4f} "
            f"lr {metrics['lr']:.2e} "
            f"gnorm {metrics['grad_norm']:.3f}")
    return {"losses": losses, "params": params, "opt_state": opt_state,
            "wall": time.time() - t0, "start_step": start_step,
            "watchdog": {"timeouts": watchdog.timeouts_fired,
                         "retries": watchdog.retries_used}}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default="runs")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--no-resume", dest="resume", action="store_false")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the plain path)")
    args = ap.parse_args()
    out = train(args.arch, reduced=args.reduced, steps=args.steps,
                batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, resume=args.resume,
                device=args.device)
    if out["losses"]:
        print(f"done: {len(out['losses'])} steps in {out['wall']:.1f}s; "
              f"first loss {out['losses'][0]:.4f} → last {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
