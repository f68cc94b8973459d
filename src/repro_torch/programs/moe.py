"""Non-regular workload: MoE expert routing as a :class:`WorkloadProgram`
(port of ``repro/programs/moe.py``).

A numpy mixture-of-experts regression in the formulation of
the reference's ``repro/models/moe.py`` (top-k routing with renormalised gate probs,
per-expert FFN experts, frozen router): each round draws a token
minibatch, routes it, and trains the experts — and because routing is
**data-dependent**, the per-expert task sizes are *irregular*: a hot
expert's forward/grad task costs several times a cold expert's, and the
load re-draws every round. That is exactly the non-regular regime the
paper claims feasibility for — irregular stage durations exercise the
GSS timeout adaptation, and the multi-size tasks exercise partitioning
and the Handler capability ("store") path, all on the *same*
Manager/Handler plane as the paper's MLP.

Stage DAG per round (minibatch) — **per-expert stages**::

    route                       — regular: one task per token block,
      |                           computes top-k + gates; depends on
      |                           NOTHING of the previous round (the
      |                           router is frozen), so round k+1's
      |                           routing overlaps round k's tail
    expert_0 ... expert_{E-1}   — IRREGULAR, mutually INDEPENDENT: one
      |                           stage per expert with ≥1 routed token,
      |                           sized by its data-dependent dispatch
      |                           list; expert_e of round k+1 depends
      |                           only on grad_e of round k (its own
      |                           weight commit)
    dy                          — a zero-task pure COMBINE BARRIER:
      |                           scatter-adds the gate-weighted expert
      |                           outputs into the shared loss + dY
    grad_0 ... grad_{E-1}       — IRREGULAR, mutually INDEPENDENT:
                                  expert weight gradients; each commits
                                  its own expert's SGD update exactly
                                  once per (expert, round) through the
                                  §5.4 window

Under a sequential Manager (``max_inflight_stages=1``) the DAG executes
in ``stage_names`` order; a pipelined Manager runs the per-expert
stages concurrently and overlaps adjacent rounds — same combines, same
trajectory. The router stays frozen (the teacher shares it), so the
loss decreases as the experts learn the teacher mixture.

TS data-plane key conventions (all per *round* — one minibatch; under a
multi-tenant cloud every subject is scoped to ``moe_routing::<subject>``
by the program's :class:`~repro_torch.core.space.ScopedSpace`, so the MoE
tenant's ``("dy", rnd)`` can never collide with e.g. the MLP tenant's
``("dy", l, d)`` on a shared space):

==========================================  =================================
key                                          value
==========================================  =================================
``("moecfg",)``                              program geometry dict (consumed
                                             by the stateless op kernels)
``("xtok",)`` / ``("ylab",)``                token inputs (T, d_in) /
                                             teacher targets (T, d_out)
``("wr",)``                                  frozen router (E, d_in)
``("we1", e)`` / ``("we2", e)``              expert weights (d_h, d_in) /
                                             (d_out, d_h)
``("wever", e)``                             committed expert version: 1 +
                                             the last round committed (0
                                             before the first)
``("route", rnd, lo, hi)``                   block routing: top-k expert ids
                                             + gates for minibatch slots
``("disp", rnd, e)``                         dispatch list: token ids +
                                             gates routed to expert ``e``
``("efwd", rnd, e, lo, hi)``                 gate-weighted expert outputs
                                             for slots lo:hi of e's list
``("gw1", rnd, e, lo, hi)``                  ∂W1 partial / slot slice
``("gw2", rnd, e, lo, hi)``                  ∂W2 partial / slot slice
``("dy", rnd)``                              combined dLoss/dYhat (B, d_out)
==========================================  =================================

**On the device.** Every value the program writes is a tensor on its
``device`` (float32; token ids int64), as for the port's MLP program; the
config dict and the expert version stay Python values, and
``record_loss`` gets the loss as a Python float. Setup draws the
reference's numpy values from the same seeds (teacher targets included)
and moves them there. Every product of the three ops is one
``tile_matmul`` launch a task (:func:`repro_torch.kernels.tile_matmul.ops.product`;
the plain version for CPU tensors): the route's logits ``x @ Wr^T`` and
the experts' ``x @ W1^T`` (``relu`` fused) and ``h @ W2^T`` read the
weight transposed where it lies (``x@w^T``), ``dy^T @ h`` and
``dh^T @ x`` read the activations transposed (``x^T@w``), and
``dy @ W2`` is the plain layout. A task's rows are its slice of the
round's dispatch list, so a re-issued task takes the same path with the
same row count and gives the same bits, whatever else shares its handler
batch. Routing uses a stable ``torch.argsort``; the minibatch ids stay a
numpy function of (cfg, round) on the host. The route combine moves each
routing block to the host once before it walks the gates.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.conflict import tiles_cover
from repro_torch.core.executor import ExecContext
from repro_torch.core.program import (FINISH_STAGE, GLOBAL_OPS, OpSpec,
                                      StageEffect, WorkloadProgram, deletes,
                                      reads, record_loss, writes)
from repro_torch.core.space import ANY
from repro_torch.core.space.schema import KeySchema, int_field
from repro_torch.core.tasks import TaskDesc
from repro_torch.device import resolve_device
from repro_torch.kernels.tile_matmul.ops import product

ROUTE = "moe_route"
EXPERT_FWD = "moe_fwd"
EXPERT_GRAD = "moe_grad"

#: Cost units (same scale as the MLP MAC proxy): routing a token scores
#: logits against every expert; an expert slot runs the two FFN matmuls.
ROUTE_COST_PER_TOKEN = 4.0
EXPERT_COST_PER_SLOT = 16.0


def _relu_np(z: np.ndarray) -> np.ndarray:
    return np.maximum(z, 0.0)


def minibatch_ids(cfg: dict, rnd: int) -> np.ndarray:
    """The round's token minibatch — a pure function of (cfg, round), so
    ops and combines recompute it instead of persisting it (idempotent
    under revival by construction). Host numpy, as in the reference."""
    rng = np.random.default_rng(cfg["seed"] * 1_000_003 + rnd + 17)
    return rng.choice(cfg["T"], size=cfg["B"], replace=False)


def _topk_route_np(x: np.ndarray, wr: np.ndarray, k: int):
    """The reference's numpy routing, for the teacher targets in setup."""
    logits = x @ wr.T                                     # (n, E)
    order = np.argsort(-logits, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(logits, order, axis=1)
    top = np.exp(top - top.max(axis=1, keepdims=True))
    gates = top / np.maximum(top.sum(axis=1, keepdims=True), 1e-9)
    return order.astype(np.int64), gates.astype(np.float32)


def _topk_route(x: torch.Tensor, wr: torch.Tensor, k: int):
    """Top-k expert ids + renormalised softmax gates per token (the
    ``norm_topk`` discipline of the reference's MoE layer); the logits
    are one tile_matmul launch, ``x @ wr^T``."""
    logits = product(x, wr, trans_w=True)                 # (n, E)
    order = torch.argsort(-logits, dim=1, stable=True)[:, :k]
    top = torch.gather(logits, 1, order)
    top = torch.exp(top - top.max(dim=1, keepdim=True).values)
    gates = top / torch.clamp(top.sum(dim=1, keepdim=True), min=1e-9)
    return order, gates


def _on(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _slot_inverse(cfg: dict, rnd: int) -> np.ndarray:
    """token id -> row in the round's minibatch (-1 if absent)."""
    ids_mb = minibatch_ids(cfg, rnd)
    inv = np.full(cfg["T"], -1, dtype=np.int64)
    inv[ids_mb] = np.arange(len(ids_mb))
    return inv


def _expert_hidden(x: torch.Tensor, W1: torch.Tensor) -> torch.Tensor:
    return product(x, W1, activation="relu", trans_w=True)    # relu(x @ W1^T)


# --------------------------------------------------------------------------
# Op kernels
# --------------------------------------------------------------------------

def route_parts(ctx: ExecContext, tasks: list[TaskDesc]):
    cfg = ctx.require(("moecfg",))
    X = ctx.require(("xtok",))
    wr = ctx.require(("wr",))
    items = []
    for t in tasks:
        ids = minibatch_ids(cfg, t.step)[t.out_lo:t.out_hi]
        experts, gates = _topk_route(X[_on(ids, X.device)], wr, cfg["k"])
        items.append((("route", t.step, t.out_lo, t.out_hi),
                      {"experts": experts, "gates": gates}))
    return items


def expert_fwd_parts(ctx: ExecContext, tasks: list[TaskDesc]):
    X = ctx.require(("xtok",))
    t0 = tasks[0]
    disp = ctx.require(("disp", t0.step, t0.layer))
    W1 = ctx.require(("we1", t0.layer))
    W2 = ctx.require(("we2", t0.layer))
    items = []
    for t in tasks:
        tok = disp["ids"][t.out_lo:t.out_hi]
        g = disp["gates"][t.out_lo:t.out_hi]
        h = _expert_hidden(X[tok], W1)                    # (n, d_h)
        y = product(h, W2, trans_w=True) * g[:, None]     # gate-weighted
        items.append((("efwd", t.step, t.layer, t.out_lo, t.out_hi), y))
    return items


def expert_grad_parts(ctx: ExecContext, tasks: list[TaskDesc]):
    cfg = ctx.require(("moecfg",))
    X = ctx.require(("xtok",))
    t0 = tasks[0]
    disp = ctx.require(("disp", t0.step, t0.layer))
    dY = ctx.require(("dy", t0.step))                     # (B, d_out)
    W1 = ctx.require(("we1", t0.layer))
    W2 = ctx.require(("we2", t0.layer))
    inv = _on(_slot_inverse(cfg, t0.step), X.device)
    items = []
    for t in tasks:
        tok = disp["ids"][t.out_lo:t.out_hi]
        g = disp["gates"][t.out_lo:t.out_hi]
        x = X[tok]                                        # (n, d_in)
        h = _expert_hidden(x, W1)                         # (n, d_h)
        dy_tok = dY[inv[tok]] * g[:, None]                # (n, d_out)
        gW2 = product(dy_tok, h, trans_x=True)            # (d_out, d_h)
        dh = product(dy_tok, W2) * (h > 0)                # (n, d_h)
        gW1 = product(dh, x, trans_x=True)                # (d_h, d_in)
        items.append((("gw1", t.step, t.layer, t.out_lo, t.out_hi), gW1))
        items.append((("gw2", t.step, t.layer, t.out_lo, t.out_hi), gW2))
    return items


# unit_time_prior: the default Handler emulates cost×time_scale/speed
# seconds per unit (time_scale=2e-6 at speed 1) — the cold-start prior
# the online cost model refines from observed (op, handler) samples.
for _spec in (
    OpSpec(ROUTE, route_parts,
           lambda t: ROUTE_COST_PER_TOKEN * t.n,
           unit_time_prior=2e-6),
    OpSpec(EXPERT_FWD, expert_fwd_parts,
           lambda t: EXPERT_COST_PER_SLOT * t.n,
           unit_time_prior=2e-6),
    OpSpec(EXPERT_GRAD, expert_grad_parts,
           lambda t: EXPERT_COST_PER_SLOT * t.n,
           unit_time_prior=2e-6),
):
    GLOBAL_OPS.register(_spec)


# --------------------------------------------------------------------------
# Declared data-plane key protocol — the docstring table, checkable
# --------------------------------------------------------------------------

_MGR = frozenset({"manager"})
_MGR_HDL = frozenset({"manager", "handler"})     # handler: late-write undo
_EXEC = frozenset({"executor"})
_RW = frozenset({"manager", "executor"})


def _ks(subject: str, fields: list, producers: frozenset,
        consumers: frozenset, lifecycle: str,
        deleters: frozenset = _MGR, description: str = "") -> KeySchema:
    return KeySchema(subject=subject, fields=tuple(fields),
                     producers=producers, consumers=consumers,
                     deleters=deleters, lifecycle=lifecycle,
                     description=description)


KEY_SCHEMAS: tuple[KeySchema, ...] = (
    _ks("moecfg", [], _MGR, _RW, "persistent",
        description="program geometry dict"),
    _ks("xtok", [], _MGR, _RW, "persistent",
        description="token inputs (T, d_in)"),
    _ks("ylab", [], _MGR, _RW, "persistent",
        description="teacher targets (T, d_out)"),
    _ks("wr", [], _MGR, _RW, "persistent",
        description="frozen router (E, d_in)"),
    _ks("we1", [int_field("expert")], _MGR, _RW, "persistent",
        description="expert FFN W1 (d_h, d_in)"),
    _ks("we2", [int_field("expert")], _MGR, _RW, "persistent",
        description="expert FFN W2 (d_out, d_h)"),
    _ks("wever", [int_field("expert")], _MGR,
        frozenset({"manager", "executor", "cloud"}), "persistent",
        description="committed expert version"),
    _ks("route", [int_field("round"), int_field("lo"), int_field("hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="block routing: top-k ids + gates"),
    _ks("disp", [int_field("round"), int_field("expert")], _MGR, _RW,
        "round_scoped", description="per-expert dispatch list"),
    _ks("efwd", [int_field("round"), int_field("expert"),
                 int_field("lo"), int_field("hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="gate-weighted expert outputs"),
    _ks("gw1", [int_field("round"), int_field("expert"),
                int_field("lo"), int_field("hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="dW1 partial"),
    _ks("gw2", [int_field("round"), int_field("expert"),
                int_field("lo"), int_field("hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="dW2 partial"),
    _ks("dy", [int_field("round")], _MGR, _RW, "round_scoped",
        description="combined dLoss/dYhat (B, d_out)"),
)


# --------------------------------------------------------------------------
# The program
# --------------------------------------------------------------------------

class MoERoutingProgram(WorkloadProgram):
    """Train MoE experts under a frozen shared router (teacher/student),
    its tensors on ``device`` (``None`` means CUDA, which raises without a
    card; pass ``"cpu"`` for the plain path)."""

    name = "moe_routing"

    def __init__(self, n_tokens: int = 128, minibatch: int = 32,
                 d_in: int = 16, d_hidden: int = 16, d_out: int = 8,
                 n_experts: int = 4, top_k: int = 2, steps: int = 10,
                 block: int = 8, lr: float = 0.3, seed: int = 0,
                 device=None) -> None:
        self.T, self.B = n_tokens, minibatch
        self.d_in, self.d_h, self.d_out = d_in, d_hidden, d_out
        self.E, self.k = n_experts, top_k
        self.steps = steps
        self.block = block
        self.lr = lr
        self.seed = seed
        self.device = resolve_device(device)
        self._cfg = {"T": self.T, "B": self.B, "E": self.E, "k": self.k,
                     "d_in": d_in, "d_h": d_hidden, "d_out": d_out,
                     "seed": seed}

    # ---------------------------------------------------------------- setup
    def setup(self, ts) -> None:
        if ts.try_read(("moecfg",)) is not None:
            return
        rng = np.random.default_rng(self.seed + 4321)
        X = rng.standard_normal((self.T, self.d_in)).astype(np.float32)
        wr = (rng.standard_normal((self.E, self.d_in))
              / np.sqrt(self.d_in)).astype(np.float32)
        # Teacher experts — same routing, same architecture; the student
        # experts below must learn this mixture.
        tW1 = rng.standard_normal((self.E, self.d_h, self.d_in)).astype(
            np.float32) / np.sqrt(self.d_in)
        tW2 = rng.standard_normal((self.E, self.d_out, self.d_h)).astype(
            np.float32) / np.sqrt(self.d_h)
        experts, gates = _topk_route_np(X, wr, self.k)
        Y = np.zeros((self.T, self.d_out), dtype=np.float32)
        for j in range(self.k):
            for e in range(self.E):
                mask = experts[:, j] == e
                if not mask.any():
                    continue
                h = _relu_np(X[mask] @ tW1[e].T)
                Y[mask] += (h @ tW2[e].T) * gates[mask, j][:, None]
        dev = self.device
        ts.put(("xtok",), _on(X, dev))
        ts.put(("ylab",), _on(Y, dev))
        ts.put(("wr",), _on(wr, dev))
        srng = np.random.default_rng(self.seed + 77)
        for e in range(self.E):
            ts.put(("we1", e), _on((srng.standard_normal((self.d_h, self.d_in))
                                    / np.sqrt(self.d_in)).astype(np.float32), dev))
            ts.put(("we2", e), _on((srng.standard_normal((self.d_out, self.d_h))
                                    / np.sqrt(self.d_h)).astype(np.float32), dev))
            ts.put(("wever", e), 0)
        # Config last: ops require it, so its presence implies the rest.
        ts.put(("moecfg",), dict(self._cfg))

    # ---------------------------------------------------------- stage graph
    def n_rounds(self) -> int:
        return self.steps

    def stage_names(self, rnd: int) -> list[str]:
        return (["route"]
                + [f"expert_{e}" for e in range(self.E)]
                + ["dy"]
                + [f"grad_{e}" for e in range(self.E)])

    def stage_deps(self, rnd: int) -> dict[str, list]:
        deps: dict[str, list] = {"route": []}   # frozen router: no deps
        for e in range(self.E):
            # expert_e needs this round's dispatch AND its own expert's
            # previous-round weight commit — nothing from sibling experts.
            deps[f"expert_{e}"] = ["route", (f"grad_{e}", -1)]
        deps["dy"] = [f"expert_{e}" for e in range(self.E)]
        for e in range(self.E):
            deps[f"grad_{e}"] = ["dy"]
        return deps

    def round_overlap(self) -> int:
        # Every data-plane key is rnd-keyed, so adjacent rounds are
        # disjoint by construction; the cross-round expert_e -> grad_e
        # edges express the only true inter-round hazard.
        return 2

    def stage_tasks(self, ts, rnd: int, stage: str) -> list[TaskDesc]:
        if stage == "route":
            return [TaskDesc(ROUTE, 0, rnd, rnd, 0, 0,
                             lo, min(lo + self.block, self.B))
                    for lo in range(0, self.B, self.block)]
        if stage == "dy":
            return []                    # pure combine barrier
        # expert_e / grad_e: one prototype sized by expert e's dispatch
        # list — DATA-DEPENDENT (read from TS, written by the route
        # combine; a revived Manager re-derives identical tasks). An
        # expert nothing routed to this round is an empty stage.
        kind, _, e_s = stage.partition("_")
        op = EXPERT_FWD if kind == "expert" else EXPERT_GRAD
        e = int(e_s)
        hit = ts.try_read(("disp", rnd, e))
        if hit is None:
            raise RuntimeError(
                f"dispatch for expert {e} missing in round {rnd} — "
                f"stage {stage!r} scheduled before route combined")
        n_e = len(hit[1]["ids"])
        return [TaskDesc(op, e, rnd, rnd, 0, 0, 0, n_e)] if n_e else []

    def expert_stage_tasks(self, ts, rnd: int) -> list[TaskDesc]:
        """All per-expert forward prototypes of one round — the
        irregularity probe's unit."""
        return [t for e in range(self.E)
                for t in self.stage_tasks(ts, rnd, f"expert_{e}")]

    # -------------------------------------------------------------- combine
    def combine(self, ts, rnd: int, stage: str, mgr) -> None:
        if stage == "route":
            self._combine_route(ts, rnd)
        elif stage == "dy":
            self._combine_expert(ts, rnd, mgr.cfg.history_limit)
        elif stage.startswith("grad_"):
            self._commit_expert(ts, rnd, int(stage[5:]), mgr.window)
        # expert_<e>: nothing to combine — the dy barrier fuses the
        # per-expert forward partials once every expert stage closed.

    def _combine_route(self, ts, rnd: int) -> None:
        if ts.try_read(("disp", rnd, 0)) is not None:
            return
        ids_mb = minibatch_ids(self._cfg, rnd)
        by_expert: dict[int, list[tuple[int, float]]] = {e: [] for e in range(self.E)}
        for key in sorted(ts.keys(("route", rnd, ANY, ANY))):
            lo, hi = key[2], key[3]
            blk = ts.try_read(key)[1]
            # One copy to the host a block: element reads of a CUDA
            # tensor would each synchronise.
            experts, gates = blk["experts"].cpu().numpy(), blk["gates"].cpu().numpy()
            for slot in range(hi - lo):
                tok = int(ids_mb[lo + slot])
                for j in range(self.k):
                    by_expert[int(experts[slot, j])].append(
                        (tok, float(gates[slot, j])))
        # Expert 0 (the idempotency-guard key) is written LAST, so a crash
        # mid-combine leaves the guard unset and a revived Manager redoes
        # the whole combine — same "presence implies the rest" ordering as
        # setup()'s ("moecfg",).
        for e in range(self.E - 1, -1, -1):
            pairs = by_expert[e]
            ts.put(("disp", rnd, e), {
                "ids": torch.tensor([p[0] for p in pairs], dtype=torch.int64,
                                    device=self.device),
                "gates": torch.tensor([p[1] for p in pairs], dtype=torch.float32,
                                      device=self.device)})

    def _combine_expert(self, ts, rnd: int, history_limit: int) -> None:
        if ts.try_read(("dy", rnd)) is not None:
            return
        ids_mb = _on(minibatch_ids(self._cfg, rnd), self.device)
        inv = _on(_slot_inverse(self._cfg, rnd), self.device)
        Yhat = torch.zeros((self.B, self.d_out), dtype=torch.float32,
                           device=self.device)
        for e in range(self.E):
            disp = ts.try_read(("disp", rnd, e))[1]
            for key in sorted(ts.keys(("efwd", rnd, e, ANY, ANY))):
                lo, hi = key[3], key[4]
                # A token is routed to an expert at most once, so a block's
                # rows are distinct: one add each, as np.add.at's.
                rows = inv[disp["ids"][lo:hi]]
                Yhat[rows] += ts.try_read(key)[1]
        target = ts.try_read(("ylab",))[1][ids_mb]
        diff = Yhat - target
        denom = self.B * self.d_out
        loss = float(torch.sum(diff * diff) / denom)
        record_loss(ts, rnd, loss, history_limit)
        ts.put(("dy", rnd), 2.0 * diff / denom)

    def _commit_expert(self, ts, rnd: int, e: int, window) -> None:
        """Sum expert ``e``'s gradient partials and SGD-update it exactly
        once per (expert, round) — the §5.4 window keyed by expert. Runs
        in ``grad_<e>``'s combine, so a pipelined Manager commits each
        expert the moment its own grad stage closes, independent of
        sibling experts still in flight. The update is incremental, so
        the version ``("wever", e)`` (1 + the last round committed) keeps
        a revived Manager, whose window predates the commit, from applying
        it twice; the weights and the version are written by one
        ``put_many``. The reference deletes and re-puts each key and counts
        commits instead."""
        hit = ts.try_read(("disp", rnd, e))
        if hit is None or len(hit[1]["ids"]) == 0:
            return
        if not window.can_commit(e, rnd):
            return
        ver = ts.try_read(("wever", e))
        if ver is not None and ver[1] > rnd:
            # This round's update landed, and the Manager died before its
            # checkpoint recorded the commit in the window: record it
            # now. Applying it again would subtract the gradient twice.
            window.commit(e, rnd)
            return
        n_e = len(hit[1]["ids"])
        k1 = ts.keys(("gw1", rnd, e, ANY, ANY))
        if not tiles_cover([(k[3], k[4]) for k in k1], 0, n_e):
            return
        dev = self.device
        gW1 = torch.zeros((self.d_h, self.d_in), dtype=torch.float32, device=dev)
        for k in sorted(k1):
            gW1 += ts.try_read(k)[1]
        gW2 = torch.zeros((self.d_out, self.d_h), dtype=torch.float32, device=dev)
        for k in sorted(ts.keys(("gw2", rnd, e, ANY, ANY))):
            gW2 += ts.try_read(k)[1]
        W1 = ts.try_read(("we1", e))[1] - self.lr * gW1
        W2 = ts.try_read(("we2", e))[1] - self.lr * gW2
        if window.commit(e, rnd):
            # One put_many, which replaces each key: both weights and the
            # version that records this round land together or not at all,
            # and no weight key is ever absent (every later op waits on it).
            ts.put_many([(("we1", e), W1), (("we2", e), W2), (("wever", e), rnd + 1)])

    # ------------------------------------------------------------ probing
    def probe_expert_tasks(self, rnd: int = 0) -> list[TaskDesc]:
        """Run one routing round inline on a scratch TS and return the
        expert stage's prototype tasks — the measured irregularity probe
        shared by the example and the tests (cost each task via
        ``GLOBAL_OPS.cost``)."""
        from repro_torch.core.executor import TaskExecutor
        from repro_torch.core.space import TupleSpace
        ts = TupleSpace(device=self.device)
        self.setup(ts)
        TaskExecutor(ts).execute_batch(self.stage_tasks(ts, rnd, "route"))
        # The route combine touches neither the commit window nor the
        # manager config, so no Manager is needed here.
        self._combine_route(ts, rnd)
        return self.expert_stage_tasks(ts, rnd)

    # -------------------------------------------------------------- cleanup
    def finish_round(self, ts, rnd: int) -> None:
        for pat in [("route", rnd, ANY, ANY), ("disp", rnd, ANY),
                    ("efwd", rnd, ANY, ANY, ANY),
                    ("gw1", rnd, ANY, ANY, ANY),
                    ("gw2", rnd, ANY, ANY, ANY), ("dy", rnd)]:
            ts.delete(pat)
        ts.delete(("done", ANY, ANY, rnd, ANY, ANY, ANY, ANY, ANY))

    # ------------------------------------------------------------- protocol
    def key_schemas(self) -> tuple[KeySchema, ...]:
        return KEY_SCHEMAS

    def stage_effects(self, rnd: int) -> dict[str, tuple[StageEffect, ...]]:
        """The declared interference contract. Per-expert pins
        make the mutual independence of sibling expert/grad stages
        checkable, and the ``round`` pins show why adjacent rounds only
        hazard through each expert's own weight commit (the
        ``(grad_e, -1)`` edges)."""
        eff: dict[str, tuple[StageEffect, ...]] = {
            "route": (reads("moecfg"), reads("xtok"), reads("wr"),
                      writes("route", round=rnd),
                      reads("route", round=rnd),
                      writes("disp", round=rnd),
                      reads("disp", round=rnd, expert=0)),
            "dy": (reads("moecfg"), reads("xtok"), reads("ylab"),
                   reads("disp", round=rnd),
                   reads("efwd", round=rnd),
                   writes("dy", round=rnd),
                   reads("dy", round=rnd)),
            FINISH_STAGE: tuple(
                deletes(s, round=rnd) for s in
                ("route", "disp", "efwd", "gw1", "gw2", "dy")),
        }
        for e in range(self.E):
            eff[f"expert_{e}"] = (
                reads("moecfg"), reads("xtok"),
                reads("disp", round=rnd, expert=e),
                reads("we1", expert=e), reads("we2", expert=e),
                writes("efwd", round=rnd, expert=e))
            eff[f"grad_{e}"] = (
                reads("moecfg"), reads("xtok"),
                reads("disp", round=rnd, expert=e),
                reads("dy", round=rnd),
                reads("we1", expert=e), reads("we2", expert=e),
                reads("wever", expert=e),
                writes("gw1", round=rnd, expert=e),
                reads("gw1", round=rnd, expert=e),
                writes("gw2", round=rnd, expert=e),
                reads("gw2", round=rnd, expert=e),
                writes("we1", expert=e), writes("we2", expert=e),
                writes("wever", expert=e))
        return eff
