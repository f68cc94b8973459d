"""Torch training as a :class:`WorkloadProgram` (port of
``repro/programs/jax_sgd.py``): data-parallel SGD of a zoo model on the
generic Manager/Handler plane, every microbatch gradient one ACAN task.

- each round is one SGD step; the single ``grad`` stage holds one
  ``torchgrad`` task per microbatch (``out_lo`` = microbatch index);
- the op computes the loss and its gradient by ``torch.autograd.grad``
  over the parameter leaves (as :mod:`repro_torch.launch.steps` does) on
  the *deterministic* microbatch ``batch_at(step·M + micro)`` and
  publishes the gradient tree keyed by content — duplicate execution
  rewrites identical values (the port's kernels use no atomics);
- the combine averages exactly one gradient per micro key, applies the
  update, and commits the new param version through the §5.4 sliding
  window (handlers read params by version — a handler that crashed
  mid-task never corrupts anything; its task simply re-appears).

Gradients stay on the device: the op puts the gradient tensors
themselves into the space (the in-process backends hold references and
the ledger hashes keys only, so nothing is copied), and ``float(loss)``
is the one read that waits for the device. Handlers compute gradients
one at a time: the launches of one gradient hold a lock (see ``grad``).
The combine takes the mean of the microbatch gradients in micro order in
float32 on the device, then applies ``p - lr * g`` in float32 and casts
to the parameter's dtype. In float32 that is the reference's
arithmetic; for bf16 parameters the reference's ``np.mean`` rounds every
partial sum to bf16, where this one keeps them in float32 (PERF.md,
"Numerics").

The op closes over the model config and the data pipeline, so it
registers in a **program-private** registry chained to the global one.

TS data-plane keys: ``("params", step)`` (current param tree),
``("gpart", step, micro)`` ((loss, grad tree) per microbatch) — the
reference's protocol, with one repair: the handler is a declared consumer
of ``gpart``. A duplicate execution that finishes after its round closed
reads its ``gpart`` back before deleting it (``Handler._undo_stale``), as
the MLP program's schemas allow for their results; the reference declares
the handler a deleter of ``gpart`` but not a consumer, so that read is a
protocol violation under a ``CheckedBackend``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from repro_torch.core.executor import ExecContext, PreconditionUnmet
from repro_torch.core.program import (FINISH_STAGE, OpRegistry, OpSpec,
                                      StageEffect, WorkloadProgram, deletes,
                                      ensure_builtin_ops, reads, record_loss,
                                      writes)
from repro_torch.core.space import ANY
from repro_torch.core.space.schema import KeySchema, int_field
from repro_torch.core.tasks import TaskDesc
from repro_torch.data.frontend import pipeline_for
from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim.optimizer import tree_leaves, tree_map

TORCHGRAD = "torchgrad"

# Declared data-plane key protocol. ("params", steps) — the final
# committed version — intentionally survives shutdown: persistent.
KEY_SCHEMAS: tuple[KeySchema, ...] = (
    KeySchema(subject="params", fields=(int_field("step"),),
              producers=frozenset({"manager"}),
              consumers=frozenset({"manager", "executor"}),
              deleters=frozenset({"manager"}), lifecycle="persistent",
              description="committed param tree at version step"),
    KeySchema(subject="gpart", fields=(int_field("step"),
                                       int_field("micro")),
              producers=frozenset({"executor"}),
              # handler: the late-write undo reads before it deletes
              consumers=frozenset({"manager", "handler"}),
              deleters=frozenset({"manager", "handler"}),
              lifecycle="round_scoped",
              description="(loss, grad tree) per microbatch"),
)


class TorchSGDProgram(WorkloadProgram):
    """One microbatch-gradient task per handler trip; SGD combine."""

    name = "torch_sgd"

    def __init__(self, cfg: "M.ModelConfig", steps: int, n_micro: int = 4,
                 micro_batch: int = 2, seq: int = 64, lr: float = 0.05,
                 handler_crash_prob: float = 0.0, data_mode: str = "cyclic",
                 seed: int = 0, device=None) -> None:
        self.cfg = cfg
        self.steps = steps
        self.n_micro = n_micro
        self.lr = lr
        self.seed = seed
        self.device = resolve_device(device)
        self.handler_crash_prob = handler_crash_prob
        self.crashes = 0
        self._crash_rng = np.random.default_rng(seed + 7)
        # The op runs on every Handler thread; Generator is not
        # thread-safe and the counter would undercount unsynchronized.
        self._crash_lock = threading.Lock()
        # One gradient at a time, whichever handler runs it. Handler
        # threads launch on one stream, so the device runs their work in
        # turn anyway; interleaved, they only fight for the GIL, which made
        # a step of four handlers 2.7x one handler's and its rounds erratic
        # enough to outlast the GSS timeout with no crash (a re-issue).
        self._grad_lock = threading.Lock()
        self.pipe = pipeline_for(cfg, micro_batch, seq, seed=seed, mode=data_mode)
        self.registry = OpRegistry(parent=ensure_builtin_ops())
        self.registry.register(OpSpec(
            TORCHGRAD, self._grad_parts,
            cost_fn=lambda t: 1.0,  # noqa: ARG005  uniform, indivisible
            split_fn=lambda t: [t]))

    # ---------------------------------------------------------------- setup
    def setup(self, ts) -> None:
        if ts.try_read(("params", ANY)) is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)
            ts.put(("params", 0), M.init_params(self.cfg, gen, self.device))

    # ---------------------------------------------------------- stage graph
    def n_rounds(self) -> int:
        return self.steps

    def stage_names(self, rnd: int) -> list[str]:  # noqa: ARG002
        return ["grad"]

    def stage_deps(self, rnd: int) -> dict[str, list]:  # noqa: ARG002
        # A pure chain: the grad op reads ("params", step), which only
        # exists once the previous round's combine committed it
        # (synchronous SGD).
        return {"grad": [("grad", -1)]}

    def stage_tasks(self, ts, rnd: int, stage: str) -> list[TaskDesc]:  # noqa: ARG002
        return [TaskDesc(TORCHGRAD, 0, rnd, rnd, 0, 0, m, m + 1)
                for m in range(self.n_micro)]

    # ------------------------------------------------------------------- op
    def batch(self, step: int, micro: int) -> dict:
        """Microbatch ``micro`` of ``step`` on the program's device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in
                self.pipe.batch_at(step * self.n_micro + micro).items()}

    def grad(self, params, batch) -> tuple[float, dict]:
        """(loss, gradient tree shaped like ``params``) of one microbatch;
        the gradients stay where the params are. Its launches hold the
        program's gradient lock; the loss is read after it is released."""
        with self._grad_lock, torch.enable_grad():
            leaves = tree_map(lambda t: t.detach().requires_grad_(True),
                              params)
            loss = M.train_loss(leaves, self.cfg, batch)[0]
            grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
        return float(loss.detach()), tree_map(lambda _: next(grads), params)

    def _grad_parts(self, ctx: ExecContext, tasks: list[TaskDesc]):
        hit = ctx.ts.try_read(("params", ANY))
        if hit is None:
            raise PreconditionUnmet("params")
        params = hit[1]
        items = []
        for t in tasks:
            with self._crash_lock:
                crash = self._crash_rng.random() < self.handler_crash_prob
                if crash:
                    self.crashes += 1
            if crash:
                # Emulated crash while holding the task: the group is
                # discarded with nothing written, and the Manager's
                # timeout re-issues it (paper §5.1).
                raise PreconditionUnmet("injected handler crash")
            micro = t.out_lo
            items.append((("gpart", t.step, micro),
                          self.grad(params, self.batch(t.step, micro))))
        return items

    # -------------------------------------------------------------- combine
    def update(self, params, grads: list):
        """``p - lr * mean(grads)`` leaf by leaf: the gradients summed in
        list (micro) order in float32, the update in float32, one rounding
        to the parameter's dtype."""
        def leaf(p, *gs):
            acc = gs[0].float()
            for g in gs[1:]:
                acc = acc + g.float()
            return (p.float() - self.lr * (acc / len(gs))).to(p.dtype)
        return tree_map(leaf, params, *grads)

    def combine(self, ts, rnd: int, stage: str, mgr) -> None:  # noqa: ARG002
        if not mgr.window.can_commit(0, rnd):
            return                       # already committed before a crash
        hit = ts.try_read(("params", rnd))
        if hit is None:
            return
        parts = [ts.try_read(("gpart", rnd, m)) for m in range(self.n_micro)]
        if any(p is None for p in parts):
            return                       # stage incomplete (stopped early)
        parts = [p[1] for p in parts]
        mean_loss = float(np.mean([p[0] for p in parts]))
        new_params = self.update(hit[1], [p[1] for p in parts])
        record_loss(ts, rnd, mean_loss, mgr.cfg.history_limit)
        if mgr.window.commit(0, rnd):    # §5.4 exactly-once
            ts.put(("params", rnd + 1), new_params)
            ts.delete(("params", rnd))

    # -------------------------------------------------------------- cleanup
    def finish_round(self, ts, rnd: int) -> None:
        ts.delete(("gpart", rnd, ANY))
        ts.delete(("done", ANY, ANY, rnd, ANY, ANY, ANY, ANY, ANY))

    # ------------------------------------------------------------- protocol
    def key_schemas(self) -> tuple[KeySchema, ...]:
        return KEY_SCHEMAS

    def stage_effects(self, rnd: int) -> dict[str, tuple[StageEffect, ...]]:
        # The grad op reads ("params", ANY) — any committed version — so
        # the read is declared unpinned and conservatively aliases every
        # params version; the combine's commit pins the versions it
        # writes/deletes. With the ("grad", -1) chain edge the WW on
        # params between consecutive rounds is always ordered.
        return {
            "grad": (
                reads("params"),
                writes("gpart", step=rnd), reads("gpart", step=rnd),
                writes("params", step=rnd + 1),
                deletes("params", step=rnd),
            ),
            FINISH_STAGE: (deletes("gpart", step=rnd),),
        }
