"""The port's MLP program against the reference's, on the CPU.

The five op bodies run on the same tuples in both packages (numpy arrays in
the reference's space, float32 CPU tensors in the port's) and must agree
within 1e-6 absolute; the tile products take tile_matmul's plain version
through the wrapper's CPU branch. ``LayerSpec(40, 24), LayerSpec(24, 1)``
at a task cap of 12 makes ragged tiles: (2, 1), (2, 2), (3, 1), (3, 2).
Within the port a task's outputs are the same bits alone and inside a full
batch. The teacher data and the tuples ``setup`` publishes equal the
reference's, and the program's declarations (prototype tasks, stage order
and DAG, key schemas, stage effects) are the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.executor import ExecContext as RefCtx
from repro.core.program import GLOBAL_OPS as REF_OPS
from repro.core.space import ANY as REF_ANY
from repro.core.space import TupleSpace as RefSpace
from repro.programs import mlp as ref_mlp
from repro_torch.core.executor import ExecContext
from repro_torch.core.program import GLOBAL_OPS
from repro_torch.core.space import ANY, TupleSpace
from repro_torch.kernels.tile_matmul import kernel as tm_kernel
from repro_torch.programs import mlp

LAYERS = [(40, 24), (24, 1)]
CAP = 12.0
LR = 0.05
BODIES = {"forward": "fwd", "activation": "act", "loss": "loss", "backward": "bwd",
          "update": "upd"}


def _tuples(seed: int = 0) -> dict:
    """Every tuple the five op bodies read, for data_id 0 at step 0."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    (n0, h), (_, n1) = LAYERS
    return {("x", 0): f(n0), ("label", 0): f(n1),
            ("w", 0): f(h, n0), ("b", 0): f(h), ("w", 1): f(n1, h), ("b", 1): f(n1),
            ("pre", 0, 0): f(h), ("act", 0, 0): np.tanh(f(h)), ("pre", 1, 0): f(n1),
            ("dy", 0, 0): f(h), ("dy", 1, 0): f(n1),
            ("gW", 0, 0): f(h, n0), ("gB", 0, 0): f(h), ("gW", 1, 0): f(n1, h),
            ("gB", 1, 0): f(n1)}


def _spaces(tuples: dict):
    ref, port = RefSpace(), TupleSpace()
    for k, v in tuples.items():
        ref.put(k, v)
        port.put(k, torch.from_numpy(v.copy()))
    return ref, port


def _tasks(op: str, layer: int, registry, pkg_mlp) -> list:
    """The op's tasks of ``layer`` (data_id 0, step 0) partitioned at CAP."""
    specs = [pkg_mlp.LayerSpec(*s) for s in LAYERS]
    stages = pkg_mlp.prototype_tasks(specs, 0, 0)
    stage = "loss" if op == "loss" else f"{BODIES[op]}_{layer}"
    return [p for t in stages[stage] for p in registry.partition(t, CAP)]


def _layers_of(op: str) -> list[int]:
    return {"activation": [0], "loss": [1]}.get(op, [0, 1])


@pytest.mark.parametrize("op", list(BODIES))
def test_op_bodies_match_the_reference(op):
    ref_ts, port_ts = _spaces(_tuples())
    ref_fn = REF_OPS.resolve(op).batch_fn
    port_fn = GLOBAL_OPS.resolve(op).batch_fn
    for layer in _layers_of(op):
        tasks = _tasks(op, layer, GLOBAL_OPS, mlp)
        assert [dataclasses.astuple(t) for t in tasks] == \
            [dataclasses.astuple(t) for t in _tasks(op, layer, REF_OPS, ref_mlp)]
        want = ref_fn(RefCtx(ref_ts, {"lr": LR}), tasks)
        got = port_fn(ExecContext(port_ts, {"lr": LR}), tasks)
        assert [k for k, _ in got] == [k for k, _ in want]
        for (k, g), (_, w) in zip(got, want):
            assert isinstance(g, torch.Tensor) and g.dtype == torch.float32, k
            assert g.shape == np.shape(w), k
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-6, err_msg=str(k))


def test_the_products_have_ragged_shape_groups_and_several_launches():
    """The forward of layer 0 at cap 12: four tile shapes, and more tasks
    than one launch's rows, so groups span and pad launches."""
    tasks = _tasks("forward", 0, GLOBAL_OPS, mlp)
    assert {(t.m, t.n) for t in tasks} == {(2, 1), (2, 2), (3, 1), (3, 2)}
    assert len(tasks) > 2 * mlp.ROWS


@pytest.mark.parametrize("op", ["forward", "backward"])
def test_a_task_gives_the_same_bits_alone_and_in_a_full_batch(op):
    """A re-issued duplicate runs in another handler batch than its first
    execution: its values must not depend on its batch partners."""
    _, port_ts = _spaces(_tuples(seed=1))
    fn = GLOBAL_OPS.resolve(op).batch_fn
    ctx = ExecContext(port_ts, {"lr": LR})
    tasks = _tasks(op, 0, GLOBAL_OPS, mlp)
    batch = dict(fn(ctx, tasks))
    for t in tasks[::7]:
        for k, v in fn(ctx, [t]):
            assert torch.equal(v, batch[k]), k


def test_launches_have_a_fixed_row_count():
    """Each launch has ``ROWS`` rows, however many tasks the chunk holds."""
    seen = []
    real = mlp.tm_ops.matmul

    def spy(x, w):
        seen.append(tuple(x.shape))
        return real(x, w)

    v = torch.arange(8, dtype=torch.float32)
    w = torch.ones(8, 3)
    mlp.tm_ops.matmul = spy
    try:
        for n_tasks in (1, 5, mlp.ROWS, mlp.ROWS + 1):
            parts = mlp._masked_products(v, w, [(0, 2)] * n_tasks, [(0, 3)] * n_tasks)
            assert len(parts) == n_tasks
            assert all(torch.equal(p, torch.full((3,), 1.0)) for p in parts)
    finally:
        mlp.tm_ops.matmul = real
    assert set(seen) == {(mlp.ROWS, 8)}
    assert mlp.ROWS == tm_kernel.SKINNY_MAX_M


def test_teacher_data_is_the_reference_data():
    specs = [mlp.LayerSpec(*s) for s in LAYERS]
    ref_specs = [ref_mlp.LayerSpec(*s) for s in LAYERS]
    for noise in (0.0, 0.1):
        X, Y = mlp.make_teacher_data(specs, 7, 3, noise)
        rX, rY = ref_mlp.make_teacher_data(ref_specs, 7, 3, noise)
        assert np.array_equal(X, rX) and np.array_equal(Y, rY)


def test_setup_publishes_the_reference_tuples_on_the_device():
    ref_ts, port_ts = RefSpace(), TupleSpace()
    ref_mlp.MLPProgram([ref_mlp.LayerSpec(*s) for s in LAYERS], n_samples=5,
                       seed=2).setup(ref_ts)
    mlp.MLPProgram([mlp.LayerSpec(*s) for s in LAYERS], n_samples=5, seed=2,
                   device="cpu").setup(port_ts)
    keys = sorted(ref_ts.keys((REF_ANY, REF_ANY)))
    assert sorted(port_ts.keys((ANY, ANY))) == keys and len(keys) == 16
    for k in keys:
        want, got = ref_ts.try_read(k)[1], port_ts.try_read(k)[1]
        if k[0] == "wver":
            assert got == want == 0
        else:
            # Every value is a float32 tensor; the reference's labels are
            # float64 (its teacher weights are divided by np.sqrt, a float64
            # scalar), so the port rounds them once.
            assert isinstance(got, torch.Tensor) and got.dtype == torch.float32, k
            assert want.dtype == (np.float64 if k[0] == "label" else np.float32), k
            assert np.array_equal(got.numpy(), want.astype(np.float32)), k


def test_the_program_declares_the_reference_graph_and_protocol():
    specs = [mlp.LayerSpec(*s) for s in LAYERS]
    ref_specs = [ref_mlp.LayerSpec(*s) for s in LAYERS]
    port = mlp.MLPProgram(specs, n_samples=4, device="cpu")
    ref = ref_mlp.MLPProgram(ref_specs, n_samples=4)
    assert mlp.stage_order(3) == ref_mlp.stage_order(3)
    assert mlp.stage_dag(3) == ref_mlp.stage_dag(3)
    assert [dataclasses.asdict(s) for s in port.key_schemas()] == \
        [dataclasses.asdict(s) for s in ref.key_schemas()]
    for rnd in (0, 5):
        assert port.stage_names(rnd) == ref.stage_names(rnd)
        assert port.stage_deps(rnd) == ref.stage_deps(rnd)
        for stage in port.stage_names(rnd):
            assert [dataclasses.astuple(t) for t in port.stage_tasks(None, rnd, stage)] == \
                [dataclasses.astuple(t) for t in ref.stage_tasks(None, rnd, stage)]
        pe, re_ = port.stage_effects(rnd), ref.stage_effects(rnd)
        assert pe.keys() == re_.keys()
        assert all([dataclasses.astuple(e) for e in pe[s]] ==
                   [dataclasses.astuple(e) for e in re_[s]] for s in pe)
    assert port.round_overlap() == ref.round_overlap() == 2
    for op in BODIES:
        p, r = GLOBAL_OPS.resolve(op), REF_OPS.resolve(op)
        t = _tasks(op, _layers_of(op)[0], GLOBAL_OPS, mlp)[0]
        assert p.cost_fn(t) == r.cost_fn(t) and p.unit_time_prior == r.unit_time_prior


def test_the_combines_never_write_into_a_tensor_of_the_space():
    """The in-process spaces hold the very tensor that was put: a combine
    that filled a tensor it read would rewrite the committed weights, and
    a revived Manager's re-run would read them corrupted."""
    specs = [mlp.LayerSpec(8, 4), mlp.LayerSpec(4, 1)]
    prog = mlp.MLPProgram(specs, epochs=1, n_samples=1, device="cpu")
    ts = TupleSpace()
    prog.setup(ts)
    w0, b0 = ts.try_read(("w", 0))[1], ts.try_read(("b", 0))[1]
    w0_bits, b0_bits = w0.clone(), b0.clone()
    ts.put(("fpart", 0, 0, 0, 4, 0, 8), torch.ones(4))
    prog._combine_forward(ts, 0, 0, specs[0])
    ts.put(("wnew", 0, 0, 0, 4), torch.full((4, 8), 2.0))
    ts.put(("bnew", 0, 0, 0, 4), torch.full((4,), 3.0))

    class _Window:
        def can_commit(self, *_):
            return True

        def commit(self, *_):
            return True

    prog._commit_update(ts, 0, 0, specs[0], _Window())
    assert torch.equal(w0, w0_bits) and torch.equal(b0, b0_bits)
    assert torch.equal(ts.try_read(("w", 0))[1], torch.full((4, 8), 2.0))
    assert torch.equal(ts.try_read(("pre", 0, 0))[1], b0_bits + 1.0)
