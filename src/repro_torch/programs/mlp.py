"""The paper's MLP workload (§5–§6) as a :class:`WorkloadProgram` (port of
``repro/programs/mlp.py``).

For a NN of linear layers the program derives five *prototype ops* per
layer — ``forward``, ``activation`` (hidden layers), ``loss`` (last
layer), ``backward``, ``update`` — and partitions them into **uniform
fixed-size** tasks so pouch/timeout tuning is handler-agnostic
(paper §5.1–5.2):

- a *forward/backward* task over ``(m inputs, n outputs)`` splits
  **4-way** into quadrants;
- *activation*, *loss* and *update* tasks over ``m`` elements split
  **2-way** into halves;
- splitting recurses until every task's cost is ≤ the task-size cap
  (the paper uses cap = 4⁴ = 256).

One round = one training sample at one SGD step (``data_id = round %
n_samples``, ``step = round``); the stage graph is the sample's forward
→ loss → backward → update pipeline, declared as the *real* dependency
DAG (:func:`stage_dag`): each ``fwd_l`` depends on the previous layer's
activation **and, across rounds, on the previous sample's ``upd_l``
commit** — so a pipelined Manager overlaps round *k*'s update sweep with
round *k+1*'s forward pass while every stage still reads exactly the
tuples the sequential order gave it (the loss trajectory stays
bit-identical at any ``max_inflight_stages``).

**On the device.** Every value the program writes is a float32 tensor on
its ``device`` (the weight version stays an int; ``record_loss`` gets the
loss as a Python float). The teacher data and the initial weights are the
reference's numpy draws from the same seeds, moved to the device as
float32 (the reference's labels are float64, so its loss arithmetic runs
in float64 where the port's runs in float32). The op
bodies compute their tile products through the hand-written
``tile_matmul`` (:func:`_masked_products`): a task's row is its input
vector masked to the task's input slice, the whole weight matrix is the
other operand, and the task keeps its output slice — the masked zeros add
exactly. Every launch has ``SKINNY_MAX_M`` rows (a short chunk is padded
with empty rows), so a task's bits never depend on which tasks share its
handler batch: a re-issued duplicate recomputes the very same values. On
the CPU the product is the plain version, through the wrapper's CPU
branch. The outer products and the update are elementwise PyTorch, the
same single multiplies as numpy's.

The in-process tuple spaces hold the very tensor that was put, so no
combine writes into a tensor it read from the space: where the reference
copies an array before filling it, the port clones.

TS data-plane key conventions (all per training *sample*, since the
paper uses SGD with batch size 1). Under a multi-tenant cloud the
program runs against a :class:`~repro_torch.core.space.ScopedSpace`, so
every subject below is stored as ``mlp::<subject>``:

==========================================  =================================
key                                          value
==========================================  =================================
``("w", layer)`` / ``("b", layer)``          committed weights / bias
``("wver", layer)``                          committed version (int)
``("x", data_id)`` / ``("label", data_id)``  input / target vectors
``("pre", l, data_id)``                      pre-activation (combined)
``("act", l, data_id)``                      post-activation (combined)
``("fpart", l, data_id, ol,oh, il,ih)``      forward partial: W[ol:oh,il:ih]·x
``("actpart", l, data_id, lo, hi)``          activation slice
``("losspart", data_id, lo, hi)``            loss over output slice
``("dypart", l, data_id, lo, hi)``           dLoss/dpre slice (last layer)
``("dy", l, data_id)``                       dLoss/dpre (combined)
``("gw", l, data_id, ol,oh, il,ih)``         dW tile
``("gb", l, data_id, ol,oh)``                db slice
``("bpart", l, data_id, il,ih, ol,oh)``      dx partial (contribution of out
                                              slice ``ol:oh`` to ``il:ih``)
``("gW", l, data_id)`` / ``("gB", l, ...)``  combined gradients
``("wnew", l, step, ol, oh)``                updated W rows (+"bnew" bias)
==========================================  =================================

Hidden activation is ``tanh`` (regression setting, paper §5.1/§6.1); the
last layer is linear.
"""

from __future__ import annotations

import functools
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.conflict import tiles_cover
from repro_torch.core.executor import ExecContext
from repro_torch.core.program import (FINISH_STAGE, GLOBAL_OPS, OpSpec,
                                      StageEffect, WorkloadProgram, deletes,
                                      reads, record_loss, writes)
from repro_torch.core.space import ANY
from repro_torch.core.space.schema import KeySchema, int_field
from repro_torch.core.tasks import TaskDesc, split_out_halves, split_quadrants
from repro_torch.device import resolve_device
from repro_torch.kernels.tile_matmul import ops as tm_ops
from repro_torch.kernels.tile_matmul.kernel import SKINNY_MAX_M

# The five prototype op names (open strings — new programs add their own).
FORWARD = "forward"
ACTIVATION = "activation"
LOSS = "loss"
BACKWARD = "backward"
UPDATE = "update"

# Cost weighting: the paper notes loss tasks "involve more complex
# computations and are better to be assigned a proportionally larger size".
LOSS_COST_FACTOR = 4.0

#: Rows of every tile-product launch: fixed, so a task's bits do not
#: depend on its batch partners.
ROWS = SKINNY_MAX_M


@dataclass(frozen=True)
class LayerSpec:
    """One linear layer: ``y = W x + b`` with ``W: (n_out, n_in)``."""
    n_in: int
    n_out: int


# --------------------------------------------------------------------------
# Prototype-task generation (paper §5.1)
# --------------------------------------------------------------------------

def prototype_tasks(layers: list[LayerSpec], data_id: int, step: int) -> dict[str, list[TaskDesc]]:
    """All prototype tasks for one training sample, grouped by pipeline stage.

    Stage keys (in dependency order)::

        fwd_<l>  act_<l> (hidden only)  loss  bwd_<l>  upd_<l>
    """
    n_layers = len(layers)
    stages: dict[str, list[TaskDesc]] = {}
    for l, spec in enumerate(layers):
        stages[f"fwd_{l}"] = [TaskDesc(FORWARD, l, data_id, step,
                                       0, spec.n_in, 0, spec.n_out)]
        if l < n_layers - 1:
            stages[f"act_{l}"] = [TaskDesc(ACTIVATION, l, data_id, step,
                                           0, 0, 0, spec.n_out)]
    last = layers[-1]
    stages["loss"] = [TaskDesc(LOSS, n_layers - 1, data_id, step,
                               0, 0, 0, last.n_out)]
    for l in reversed(range(n_layers)):
        spec = layers[l]
        stages[f"bwd_{l}"] = [TaskDesc(BACKWARD, l, data_id, step,
                                       0, spec.n_in, 0, spec.n_out)]
    for l in range(n_layers):
        spec = layers[l]
        stages[f"upd_{l}"] = [TaskDesc(UPDATE, l, data_id, step,
                                       0, spec.n_in, 0, spec.n_out)]
    return stages


def stage_order(n_layers: int) -> list[str]:
    """Dependency-ordered stage names for one sample's pipeline."""
    order: list[str] = []
    for l in range(n_layers):
        order.append(f"fwd_{l}")
        if l < n_layers - 1:
            order.append(f"act_{l}")
    order.append("loss")
    for l in reversed(range(n_layers)):
        order.append(f"bwd_{l}")
    for l in range(n_layers):
        order.append(f"upd_{l}")
    return order


def stage_dag(n_layers: int) -> dict[str, list]:
    """The *real* dependency DAG of one sample's pipeline — what each
    stage actually reads, not the linear order it used to run in:

    - ``fwd_l`` reads layer ``l``'s committed weights — i.e. the
      **previous round's** ``upd_l`` commit — plus the previous layer's
      combined activation (``act_{l-1}``);
    - ``act_l`` reads ``fwd_l``'s combined pre-activation;
    - ``loss`` reads the last layer's pre-activation;
    - ``bwd_l`` reads ``dy_l`` (from ``loss`` for the head, else from
      ``bwd_{l+1}``'s combine) plus this round's forward state;
    - ``upd_l`` reads ``bwd_l``'s combined gradients.

    ``upd_l`` of sample *k* is **independent** of sample *k+1*'s
    ``fwd_{l'}`` for every ``l' != l``: the frontier scheduler overlaps
    the tail of round *k*'s update sweep with the head of round *k+1*'s
    forward pass, and the trajectory stays bit-identical — every
    ``fwd_l`` still sees exactly the version-*k+1* weights, because its
    cross-round edge pins ``upd_l`` of round *k*."""
    deps: dict[str, list] = {}
    for l in range(n_layers):
        d: list = [f"act_{l - 1}"] if l > 0 else []
        d.append((f"upd_{l}", -1))
        deps[f"fwd_{l}"] = d
        if l < n_layers - 1:
            deps[f"act_{l}"] = [f"fwd_{l}"]
    deps["loss"] = [f"fwd_{n_layers - 1}"]
    for l in reversed(range(n_layers)):
        deps[f"bwd_{l}"] = ["loss"] if l == n_layers - 1 else [f"bwd_{l + 1}"]
    for l in range(n_layers):
        deps[f"upd_{l}"] = [f"bwd_{l}"]
    return deps


# --------------------------------------------------------------------------
# Op kernels — batch-vectorized, pure functions of tuples they read
# --------------------------------------------------------------------------

def activation(z: torch.Tensor) -> torch.Tensor:
    return torch.tanh(z)


def activation_deriv_from_act(a: torch.Tensor) -> torch.Tensor:
    return 1.0 - a * a


def _input_vec(ctx: ExecContext, layer: int, data_id: int) -> torch.Tensor:
    if layer == 0:
        return ctx.require(("x", data_id))
    return ctx.require(("act", layer - 1, data_id))


def _by_shape(tasks: list[TaskDesc]):
    """Stacking needs uniform tile shapes; edge tiles may differ."""
    groups: dict[tuple[int, int], list[TaskDesc]] = defaultdict(list)
    for t in tasks:
        groups[(t.m, t.n)].append(t)
    return groups.values()


@functools.lru_cache(maxsize=4096)
def _span_mask(device: torch.device, n: int, lo: int, hi: int) -> torch.Tensor:
    """``(n,)`` bool, true on ``lo:hi``; made once on ``device``, so a
    launch's mask needs no copy from the host."""
    mask = torch.zeros(n, dtype=torch.bool, device=device)
    mask[lo:hi] = True
    return mask


def _masked_products(v: torch.Tensor, w: torch.Tensor, spans: list, keeps: list):
    """For each task ``i``: ``(v masked to spans[i]) @ w`` sliced to
    ``keeps[i]``, through tile_matmul in launches of ``ROWS`` rows (a
    short chunk padded with empty rows). ``w`` is ``(len(v), N)``,
    contiguous."""
    n = v.shape[0]
    out = []
    for c in range(0, len(spans), ROWS):
        chunk = spans[c:c + ROWS]
        rows = [_span_mask(v.device, n, lo, hi) for lo, hi in chunk]
        rows += [_span_mask(v.device, n, 0, 0)] * (ROWS - len(chunk))
        prod = tm_ops.matmul(torch.where(torch.stack(rows), v, 0.0), w)
        out.extend(prod[i, lo:hi] for i, (lo, hi) in enumerate(keeps[c:c + ROWS]))
    return out


def forward_parts(ctx: ExecContext, tasks: list[TaskDesc]):
    t0 = tasks[0]
    x = _input_vec(ctx, t0.layer, t0.data_id)
    Wt = ctx.require(("w", t0.layer)).t().contiguous()
    items = []
    for group in _by_shape(tasks):
        parts = _masked_products(x, Wt, [(t.in_lo, t.in_hi) for t in group],
                                 [(t.out_lo, t.out_hi) for t in group])
        items.extend(
            ((("fpart", t.layer, t.data_id, t.out_lo, t.out_hi,
               t.in_lo, t.in_hi), part))
            for t, part in zip(group, parts))
    return items


def activation_parts(ctx: ExecContext, tasks: list[TaskDesc]):
    t0 = tasks[0]
    pre = ctx.require(("pre", t0.layer, t0.data_id))
    act = activation(pre)
    return [(("actpart", t.layer, t.data_id, t.out_lo, t.out_hi),
             act[t.out_lo:t.out_hi]) for t in tasks]


def loss_parts(ctx: ExecContext, tasks: list[TaskDesc]):
    # Output of the net = pre-activation of the last layer (linear head);
    # MSE over the full output dim — slices contribute sum / n_total.
    t0 = tasks[0]
    pre = ctx.require(("pre", t0.layer, t0.data_id))
    label = ctx.require(("label", t0.data_id))
    n_total = pre.shape[0]
    items = []
    for t in tasks:
        diff = pre[t.out_lo:t.out_hi] - label[t.out_lo:t.out_hi]
        items.append((("losspart", t.data_id, t.out_lo, t.out_hi),
                      torch.sum(diff * diff) / n_total))
        items.append((("dypart", t.layer, t.data_id, t.out_lo, t.out_hi),
                      2.0 * diff / n_total))
    return items


def backward_parts(ctx: ExecContext, tasks: list[TaskDesc]):
    t0 = tasks[0]
    dy = ctx.require(("dy", t0.layer, t0.data_id))
    x = _input_vec(ctx, t0.layer, t0.data_id)
    W = ctx.require(("w", t0.layer))
    items = []
    for group in _by_shape(tasks):
        dys = torch.stack([dy[t.out_lo:t.out_hi] for t in group])
        xs = torch.stack([x[t.in_lo:t.in_hi] for t in group])
        # outer products and dx partials, batched over the group; db only
        # once per out-slice (attached to the tile whose in_lo is 0).
        gws = dys[:, :, None] * xs[:, None, :]
        bparts = _masked_products(dy, W, [(t.out_lo, t.out_hi) for t in group],
                                  [(t.in_lo, t.in_hi) for t in group])
        for t, gw, bp in zip(group, gws, bparts):
            items.append((("gw", t.layer, t.data_id, t.out_lo, t.out_hi,
                           t.in_lo, t.in_hi), gw))
            items.append((("bpart", t.layer, t.data_id, t.in_lo, t.in_hi,
                           t.out_lo, t.out_hi), bp))
            if t.in_lo == 0:
                items.append((("gb", t.layer, t.data_id,
                               t.out_lo, t.out_hi),
                              dy[t.out_lo:t.out_hi].clone()))
    return items


def update_parts(ctx: ExecContext, tasks: list[TaskDesc]):
    # Keyed by step → duplicate executions overwrite with identical
    # values; the Manager's commit window takes each (step, slice) once.
    # One elementwise update over the rows the tasks span, then a slice a
    # task: the same single operations per element as row by row.
    t0 = tasks[0]
    lr = float(ctx.env.get("lr", 0.01))
    W = ctx.require(("w", t0.layer))
    b = ctx.require(("b", t0.layer))
    gW = ctx.require(("gW", t0.layer, t0.data_id))
    gB = ctx.require(("gB", t0.layer, t0.data_id))
    lo = min(t.out_lo for t in tasks)
    hi = max(t.out_hi for t in tasks)
    wnew = W[lo:hi] - lr * gW[lo:hi]
    bnew = b[lo:hi] - lr * gB[lo:hi]
    items = []
    for t in tasks:
        rows = slice(t.out_lo - lo, t.out_hi - lo)
        items.append((("wnew", t.layer, t.step, t.out_lo, t.out_hi), wnew[rows]))
        items.append((("bnew", t.layer, t.step, t.out_lo, t.out_hi), bnew[rows]))
    return items


def _cost_2d(t: TaskDesc) -> float:
    """Multiply/accumulate count proxy for 2-D tasks (paper §5.2)."""
    return float(t.m * t.n)


def _cost_act(t: TaskDesc) -> float:
    return float(t.n)


def _cost_loss(t: TaskDesc) -> float:
    return LOSS_COST_FACTOR * t.n


def _cost_update(t: TaskDesc) -> float:
    # rows out_lo:out_hi of W (n rows × m columns) + bias rows
    return float(t.n * max(t.m, 1))


# unit_time_prior: the default Handler emulates cost×time_scale/speed
# seconds per unit (time_scale=2e-6 at speed 1) — the cold-start prior
# the online cost model refines from observed samples.
for _spec in (
    OpSpec(FORWARD, forward_parts, _cost_2d, split_quadrants,
           unit_time_prior=2e-6),
    OpSpec(ACTIVATION, activation_parts, _cost_act, split_out_halves,
           unit_time_prior=2e-6),
    OpSpec(LOSS, loss_parts, _cost_loss, split_out_halves,
           unit_time_prior=2e-6),
    OpSpec(BACKWARD, backward_parts, _cost_2d, split_quadrants,
           unit_time_prior=2e-6),
    OpSpec(UPDATE, update_parts, _cost_update, split_out_halves,
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
    _ks("w", [int_field("layer")], _MGR, _RW, "persistent",
        description="committed weight matrix"),
    _ks("b", [int_field("layer")], _MGR, _RW, "persistent",
        description="committed bias"),
    _ks("wver", [int_field("layer")], _MGR,
        frozenset({"manager", "executor", "cloud"}), "persistent",
        description="committed weight version"),
    _ks("x", [int_field("data_id")], _MGR, _RW, "persistent",
        description="input vector"),
    _ks("label", [int_field("data_id")], _MGR, _RW, "persistent",
        description="target vector"),
    _ks("pre", [int_field("layer"), int_field("data_id")], _MGR, _RW,
        "round_scoped", description="combined pre-activation"),
    _ks("act", [int_field("layer"), int_field("data_id")], _MGR, _RW,
        "round_scoped", description="combined post-activation"),
    _ks("fpart", [int_field("layer"), int_field("data_id"),
                  int_field("out_lo"), int_field("out_hi"),
                  int_field("in_lo"), int_field("in_hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="forward partial W[ol:oh,il:ih]·x"),
    _ks("actpart", [int_field("layer"), int_field("data_id"),
                    int_field("lo"), int_field("hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="activation slice"),
    _ks("losspart", [int_field("data_id"), int_field("lo"),
                     int_field("hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="loss over output slice"),
    _ks("dypart", [int_field("layer"), int_field("data_id"),
                   int_field("lo"), int_field("hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="dLoss/dpre slice (last layer)"),
    _ks("dy", [int_field("layer"), int_field("data_id")], _MGR, _RW,
        "round_scoped", description="combined dLoss/dpre"),
    _ks("gw", [int_field("layer"), int_field("data_id"),
               int_field("out_lo"), int_field("out_hi"),
               int_field("in_lo"), int_field("in_hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="dW tile"),
    _ks("gb", [int_field("layer"), int_field("data_id"),
               int_field("out_lo"), int_field("out_hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="db slice"),
    _ks("bpart", [int_field("layer"), int_field("data_id"),
                  int_field("in_lo"), int_field("in_hi"),
                  int_field("out_lo"), int_field("out_hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="dx partial"),
    _ks("gW", [int_field("layer"), int_field("data_id")], _MGR, _RW,
        "round_scoped", description="combined weight gradient"),
    _ks("gB", [int_field("layer"), int_field("data_id")], _MGR, _RW,
        "round_scoped", description="combined bias gradient"),
    _ks("wnew", [int_field("layer"), int_field("step"),
                 int_field("out_lo"), int_field("out_hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="updated W rows (pre-commit)"),
    _ks("bnew", [int_field("layer"), int_field("step"),
                 int_field("out_lo"), int_field("out_hi")],
        _EXEC, _MGR_HDL, "stage_scoped", deleters=_MGR_HDL,
        description="updated bias rows (pre-commit)"),
    _ks("loss", [int_field("data_id"), int_field("step")], _MGR,
        frozenset({"manager", "cloud"}), "round_scoped",
        description="per-sample loss (losshist carries the trajectory)"),
)


# --------------------------------------------------------------------------
# Teacher data (paper §6.1)
# --------------------------------------------------------------------------

def make_teacher_data(layers: list[LayerSpec], n_samples: int, seed: int,
                      noise: float = 0.0):
    """Synthetic regression data from a random teacher net of the same
    architecture (paper §6.1: "randomly generate a set of parameters that
    define a mapping … synthesize 100 data points"). numpy, as the
    reference's: the same seed gives the same arrays in both packages."""
    rng = np.random.default_rng(seed + 1234)
    Ws = []
    for spec in layers:
        Ws.append(rng.standard_normal((spec.n_out, spec.n_in)).astype(np.float32)
                  / np.sqrt(spec.n_in))
    X = rng.standard_normal((n_samples, layers[0].n_in)).astype(np.float32)
    Y = []
    for x in X:
        h = x
        for i, W in enumerate(Ws):
            h = W @ h
            if i < len(Ws) - 1:
                h = np.tanh(h)
        Y.append(h + noise * rng.standard_normal(h.shape).astype(np.float32))
    return X, np.stack(Y)


# --------------------------------------------------------------------------
# The program
# --------------------------------------------------------------------------

class MLPProgram(WorkloadProgram):
    """The paper's §6 workload: SGD(bs=1) over a linear-layer NN, its
    tensors on ``device`` (``None`` means CUDA, which raises without a
    card; pass ``"cpu"`` for the plain path)."""

    name = "mlp"

    def __init__(self, layers: list[LayerSpec], epochs: int = 2,
                 n_samples: int = 100, seed: int = 0,
                 data_noise: float = 0.0, make_data: bool = True,
                 device=None) -> None:
        self.layers = list(layers)
        self.epochs = epochs
        self.n_samples = n_samples
        self.seed = seed
        self.data_noise = data_noise
        self.make_data = make_data
        self.device = resolve_device(device)
        self._order = stage_order(len(self.layers))
        self._dag = stage_dag(len(self.layers))

    def _tensor(self, a) -> torch.Tensor:
        """A float32 copy of ``a`` on the program's device."""
        return torch.tensor(a, dtype=torch.float32, device=self.device)

    # ---------------------------------------------------------------- setup
    def setup(self, ts) -> None:
        """Publish dataset + initial weights (fresh start only). Each
        block is guarded on the LAST tuple it writes — a set guard
        implies every earlier tuple of the block landed, so a Manager
        crash mid-publish leaves the guard unset and the revived
        Manager's re-call republishes the whole block (re-puts replace
        with identical values: data and init are pure functions of the
        seed)."""
        if self.make_data \
                and ts.try_read(("label", self.n_samples - 1)) is None:
            X, Y = make_teacher_data(self.layers, self.n_samples, self.seed,
                                     self.data_noise)
            for i in range(self.n_samples):
                ts.put(("x", i), self._tensor(X[i]))
                ts.put(("label", i), self._tensor(Y[i]))
        rng = np.random.default_rng(self.seed)
        for l, spec in enumerate(self.layers):
            # Draw unconditionally so the rng stream position per layer
            # never depends on which guards a crashed predecessor left
            # set — layer l's init is bit-identical on every re-run.
            scale = 1.0 / np.sqrt(spec.n_in)
            W0 = (rng.standard_normal(
                (spec.n_out, spec.n_in)) * scale).astype(np.float32)
            if ts.try_read(("wver", l)) is None:
                ts.put(("w", l), self._tensor(W0))
                ts.put(("b", l), torch.zeros(spec.n_out, dtype=torch.float32,
                                             device=self.device))
                ts.put(("wver", l), 0)

    # ---------------------------------------------------------- stage graph
    def n_rounds(self) -> int:
        return self.epochs * self.n_samples

    def stage_names(self, rnd: int) -> list[str]:  # noqa: ARG002
        return self._order

    def stage_deps(self, rnd: int) -> dict[str, list]:  # noqa: ARG002
        return self._dag

    def round_overlap(self) -> int:
        # finish_round cleanup is keyed by data_id = rnd % n_samples, so
        # two adjacent rounds only have disjoint partials/done marks when
        # the dataset has at least two samples.
        return 2 if self.n_samples >= 2 else 1

    def recleanable_rounds(self, lo: int, base: int) -> range:
        # finish_round(r) clears every round r + k * n_samples too: leave
        # out the finished rounds that alias a round the frontier may hold.
        return range(max(lo, base + self.round_overlap() - self.n_samples), base)

    def stage_tasks(self, ts, rnd: int, stage: str) -> list[TaskDesc]:  # noqa: ARG002
        data_id = rnd % self.n_samples
        return prototype_tasks(self.layers, data_id, rnd)[stage]

    # -------------------------------------------------------------- combine
    # Key iteration is SORTED everywhere: fp32 accumulation order must not
    # depend on handler completion order, or re-executed/raced tasks could
    # perturb training numerics (determinism is the §5.4 idempotency
    # guarantee, and it must hold bitwise).
    def combine(self, ts, rnd: int, stage: str, mgr) -> None:
        data_id = rnd % self.n_samples
        kind, _, l = stage.partition("_")
        if kind == "fwd":
            self._combine_forward(ts, int(l), data_id, self.layers[int(l)])
        elif kind == "act":
            self._combine_activation(ts, int(l), data_id, self.layers[int(l)])
        elif stage == "loss":
            self._combine_loss(ts, data_id, rnd, mgr.cfg.history_limit)
        elif kind == "bwd":
            self._combine_backward(ts, int(l), data_id, self.layers[int(l)])
        elif kind == "upd":
            self._commit_update(ts, int(l), rnd, self.layers[int(l)],
                                mgr.window)

    def _combine_forward(self, ts, l: int, data_id: int, spec: LayerSpec) -> None:  # noqa: ARG002
        if ts.try_read(("pre", l, data_id)) is not None:
            return
        keys = sorted(ts.keys(("fpart", l, data_id, ANY, ANY, ANY, ANY)))
        pre = ts.try_read(("b", l))[1].clone()
        for k in keys:
            ol, oh = k[3], k[4]
            pre[ol:oh] += ts.try_read(k)[1]
        ts.put(("pre", l, data_id), pre)

    def _combine_activation(self, ts, l: int, data_id: int, spec: LayerSpec) -> None:
        if ts.try_read(("act", l, data_id)) is not None:
            return
        out = torch.zeros(spec.n_out, dtype=torch.float32, device=self.device)
        for k in sorted(ts.keys(("actpart", l, data_id, ANY, ANY))):
            out[k[3]:k[4]] = ts.try_read(k)[1]
        ts.put(("act", l, data_id), out)

    def _combine_loss(self, ts, data_id: int, step: int,
                      history_limit: int) -> None:
        L = len(self.layers) - 1
        if ts.try_read(("dy", L, data_id)) is not None:
            return
        n_out = self.layers[-1].n_out
        loss = 0.0
        dy = torch.zeros(n_out, dtype=torch.float32, device=self.device)
        for k in sorted(ts.keys(("losspart", data_id, ANY, ANY))):
            loss += float(ts.try_read(k)[1])
        for k in sorted(ts.keys(("dypart", L, data_id, ANY, ANY))):
            dy[k[3]:k[4]] = ts.try_read(k)[1]
        ts.put(("loss", data_id, step), self._tensor(loss))
        record_loss(ts, step, loss, history_limit)
        ts.put(("dy", L, data_id), dy)

    def _combine_backward(self, ts, l: int, data_id: int, spec: LayerSpec) -> None:
        # Idempotency guard on the LAST tuple this combine writes (dy for
        # hidden layers, gB for layer 0): a crash mid-combine must leave
        # the guard unset so a revived Manager redoes the whole combine
        # (re-puts overwrite with identical values — pure function of
        # sorted parts).
        done_key = ("dy", l - 1, data_id) if l > 0 else ("gB", l, data_id)
        if ts.try_read(done_key) is not None:
            return
        dev = self.device
        gW = torch.zeros((spec.n_out, spec.n_in), dtype=torch.float32, device=dev)
        for k in sorted(ts.keys(("gw", l, data_id, ANY, ANY, ANY, ANY))):
            gW[k[3]:k[4], k[5]:k[6]] = ts.try_read(k)[1]
        gB = torch.zeros(spec.n_out, dtype=torch.float32, device=dev)
        for k in sorted(ts.keys(("gb", l, data_id, ANY, ANY))):
            gB[k[3]:k[4]] = ts.try_read(k)[1]
        ts.put(("gW", l, data_id), gW)
        ts.put(("gB", l, data_id), gB)
        if l > 0:
            dx = torch.zeros(spec.n_in, dtype=torch.float32, device=dev)
            for k in sorted(ts.keys(("bpart", l, data_id, ANY, ANY, ANY, ANY))):
                dx[k[3]:k[4]] += ts.try_read(k)[1]
            a_prev = ts.try_read(("act", l - 1, data_id))[1]
            ts.put(("dy", l - 1, data_id),
                   dx * activation_deriv_from_act(a_prev))

    def _commit_update(self, ts, l: int, step: int, spec: LayerSpec,
                       window) -> None:
        """§5.4: overwrite W only when all row tiles are present, exactly
        once per (layer, step)."""
        if not window.can_commit(l, step):
            # Already committed (revived-Manager re-run, or a straggler
            # re-issue finishing after the commit): the re-executed update
            # stage may have re-published identical wnew/bnew tiles. They
            # are step-keyed, so finish_round's data_id-keyed sweep never
            # matches them — without this cleanup every such re-run would
            # leak them.
            ts.delete(("wnew", l, step, ANY, ANY))
            ts.delete(("bnew", l, step, ANY, ANY))
            return
        keys = ts.keys(("wnew", l, step, ANY, ANY))
        if not tiles_cover([(k[3], k[4]) for k in keys], 0, spec.n_out):
            return
        W = ts.try_read(("w", l))[1].clone()
        b = ts.try_read(("b", l))[1].clone()
        for k in keys:
            W[k[3]:k[4]] = ts.try_read(k)[1]
        for k in ts.keys(("bnew", l, step, ANY, ANY)):
            b[k[3]:k[4]] = ts.try_read(k)[1]
        if window.commit(l, step):
            # `put` replaces atomically — a delete-then-put here would
            # open a window with no ("w", l) in the space, where a Manager
            # crash left every revived combine re-run dying on a None read.
            ts.put(("w", l), W)
            ts.put(("b", l), b)
            ver = ts.try_read(("wver", l))
            ts.put(("wver", l), (ver[1] if ver else 0) + 1)
        ts.delete(("wnew", l, step, ANY, ANY))
        ts.delete(("bnew", l, step, ANY, ANY))

    # -------------------------------------------------------------- cleanup
    def finish_round(self, ts, rnd: int) -> None:
        data_id = rnd % self.n_samples
        for pat in [("fpart", ANY, data_id, ANY, ANY, ANY, ANY),
                    ("actpart", ANY, data_id, ANY, ANY),
                    ("losspart", data_id, ANY, ANY),
                    ("dypart", ANY, data_id, ANY, ANY),
                    ("gw", ANY, data_id, ANY, ANY, ANY, ANY),
                    ("gb", ANY, data_id, ANY, ANY),
                    ("bpart", ANY, data_id, ANY, ANY, ANY, ANY),
                    ("gW", ANY, data_id), ("gB", ANY, data_id),
                    ("pre", ANY, data_id), ("act", ANY, data_id),
                    ("dy", ANY, data_id),
                    # per-sample loss tuples: nothing reads them after the
                    # combine (losshist carries the trajectory).
                    ("loss", data_id, ANY),
                    # step-keyed commit staging (step == rnd): normally
                    # removed by _commit_update, but a commit interleaved
                    # with a crash can strand tiles — belt over braces.
                    ("wnew", ANY, rnd, ANY, ANY),
                    ("bnew", ANY, rnd, ANY, ANY)]:
            ts.delete(pat)
        ts.delete(("done", ANY, ANY, data_id, ANY, ANY, ANY, ANY, ANY))

    # ------------------------------------------------------------- protocol
    def key_schemas(self) -> tuple[KeySchema, ...]:
        return KEY_SCHEMAS

    def stage_effects(self, rnd: int) -> dict[str, tuple[StageEffect, ...]]:
        """The declared interference contract: per stage, every
        data-plane key family its tasks' kernels read, its combine reads
        and writes, and (``@finish``) its round cleanup deletes — pins
        carry the concrete ``layer``/``data_id``/``step`` values for
        round ``rnd``, so the cross-round hazards the ``(upd_l, -1)``
        edges order (weight reads vs the §5.4 commit) show up as plain
        pin overlaps."""
        d = rnd % self.n_samples
        L = len(self.layers)
        eff: dict[str, tuple[StageEffect, ...]] = {}
        for l in range(L):
            src = (reads("x", data_id=d) if l == 0 else
                   reads("act", layer=l - 1, data_id=d))
            eff[f"fwd_{l}"] = (
                src, reads("w", layer=l), reads("b", layer=l),
                writes("fpart", layer=l, data_id=d),
                reads("fpart", layer=l, data_id=d),
                writes("pre", layer=l, data_id=d),
                reads("pre", layer=l, data_id=d))
            if l < L - 1:
                eff[f"act_{l}"] = (
                    reads("pre", layer=l, data_id=d),
                    writes("actpart", layer=l, data_id=d),
                    reads("actpart", layer=l, data_id=d),
                    writes("act", layer=l, data_id=d),
                    reads("act", layer=l, data_id=d))
        eff["loss"] = (
            reads("pre", layer=L - 1, data_id=d), reads("label", data_id=d),
            writes("losspart", data_id=d), reads("losspart", data_id=d),
            writes("dypart", layer=L - 1, data_id=d),
            reads("dypart", layer=L - 1, data_id=d),
            writes("loss", data_id=d, step=rnd),
            writes("dy", layer=L - 1, data_id=d),
            reads("dy", layer=L - 1, data_id=d))
        for l in range(L):
            src = (reads("x", data_id=d) if l == 0 else
                   reads("act", layer=l - 1, data_id=d))
            bwd = [src, reads("w", layer=l), reads("dy", layer=l, data_id=d),
                   writes("gw", layer=l, data_id=d),
                   reads("gw", layer=l, data_id=d),
                   writes("gb", layer=l, data_id=d),
                   reads("gb", layer=l, data_id=d),
                   writes("bpart", layer=l, data_id=d),
                   reads("bpart", layer=l, data_id=d),
                   writes("gW", layer=l, data_id=d),
                   reads("gW", layer=l, data_id=d),
                   writes("gB", layer=l, data_id=d),
                   reads("gB", layer=l, data_id=d)]
            if l > 0:
                bwd.append(writes("dy", layer=l - 1, data_id=d))
            eff[f"bwd_{l}"] = tuple(bwd)
            eff[f"upd_{l}"] = (
                reads("w", layer=l), reads("b", layer=l),
                reads("wver", layer=l),
                reads("gW", layer=l, data_id=d),
                reads("gB", layer=l, data_id=d),
                writes("wnew", layer=l, step=rnd),
                reads("wnew", layer=l, step=rnd),
                deletes("wnew", layer=l, step=rnd),
                writes("bnew", layer=l, step=rnd),
                reads("bnew", layer=l, step=rnd),
                deletes("bnew", layer=l, step=rnd),
                writes("w", layer=l), deletes("w", layer=l),
                writes("b", layer=l), deletes("b", layer=l),
                writes("wver", layer=l), deletes("wver", layer=l))
        eff[FINISH_STAGE] = tuple(
            [deletes(s, data_id=d) for s in
             ("fpart", "actpart", "losspart", "dypart", "gw", "gb",
              "bpart", "gW", "gB", "pre", "act", "dy", "loss")]
            + [deletes("wnew", step=rnd), deletes("bnew", step=rnd)])
        return eff
