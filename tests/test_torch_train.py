"""The port's training path against the JAX reference, on the CPU.

``train_loss`` and its gradients, one AdamW step from the reference's own
checkpoint (``runs/quickstart/smollm_360m_reduced/ckpt_29``: float32
params and optimizer state), ``train()`` of reduced smollm_360m against
``repro.launch.train.train`` from the same initial weights and data, and a
resume from journal and checkpoint. The same numpy data goes to both
packages. Model-level bars: 1e-4 in float32 (``ROADMAP.md``); gradients
also at 1e-4, relative to the largest gradient of their tensor.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.checkpoint.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.configs.base import get_config as jax_get_config
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.train import train as jax_train
from repro.models import model as JM
from repro.optim.optimizer import OptConfig as JOptConfig
from repro.optim.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.checkpoint.checkpoint import _flatten, load_checkpoint
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.distributed.watchdog import StepWatchdog
from repro_torch.launch.steps import make_train_step
from repro_torch.launch.train import train
from repro_torch.models import model as M
from repro_torch.optim.optimizer import OptConfig, init_opt_state, tree_leaves, tree_map

CKPT = Path(__file__).resolve().parents[1] / "runs/quickstart/smollm_360m_reduced/ckpt_29"
ARCH = "smollm_360m"


def _batch(step: int, batch: int = 4, seq: int = 32) -> dict:
    cfg = get_config(ARCH, reduced=True)
    return TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=batch, seq=seq,
                                        mode="cyclic")).batch_at(step)


def _jax_ckpt29(opt: JOptConfig):
    jcfg = jax_get_config(ARCH, reduced=True)
    like = JM.init_params(jcfg, jax.random.PRNGKey(0))
    step, params, opt_state = jax_load_checkpoint(str(CKPT), like,
                                                  jax_init_opt_state(like, opt))
    return step, params, opt_state


def _port_ckpt29(opt: OptConfig):
    cfg = get_config(ARCH, reduced=True)
    like = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return load_checkpoint(str(CKPT), like, init_opt_state(like, opt))


def _flat_np(tree) -> dict:
    """Reference-keyed numpy leaves of a port tree (per-layer lists stacked)."""
    return {k: v.detach().float().numpy() for k, v in _flatten(tree).items()}


def _assert_trees_close(got: dict, want, rtol: float, what: str) -> None:
    """Every leaf within ``rtol`` of the largest value of its reference
    leaf (so near-zero entries are held to the tensor's scale)."""
    want = {k: np.asarray(v, np.float32) for k, v in _flatten_with_paths(want).items()}
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys()))
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=rtol * scale,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("remat", ["nothing", "none", "dots"])
def test_train_loss_and_gradients_match_reference_on_ckpt_29(remat):
    jcfg = dataclasses.replace(jax_get_config(ARCH, reduced=True), remat=remat)
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), remat=remat)
    _, jparams, _ = _jax_ckpt29(JOptConfig())
    _, params, _ = _port_ckpt29(OptConfig())
    batch = _batch(30)
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: JM.train_loss(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, met = M.train_loss(leaves, cfg, {k: torch.as_tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(met["nll"].item(), float(jmet["nll"]), rtol=1e-4, atol=1e-4)
    assert met["aux"].item() == float(jmet["aux"]) == 0.0
    _assert_trees_close(_flat_np(tree_map(lambda _: next(it), params)), jgrads, 1e-4,
                        "grad")


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_one_train_step_from_ckpt_29_matches_reference(moment_dtype):
    """Params and optimizer state of ckpt_29, one step of the train step
    (with weight decay, so the rank >= 2 rule is exercised): new params,
    moments, step count and metrics. bf16 moments start from ckpt_29's
    float32 ones cast, in both packages."""
    kw = dict(peak_lr=1e-3, warmup_steps=5, decay_steps=40, weight_decay=0.1,
              moment_dtype=moment_dtype)
    jopt, opt = JOptConfig(**kw), OptConfig(**kw)
    _, jparams, jstate = _jax_ckpt29(JOptConfig())
    _, params, state = _port_ckpt29(OptConfig())
    jstate = {"m": jax.tree.map(lambda x: x.astype(jopt.mdtype), jstate["m"]),
              "v": jax.tree.map(lambda x: x.astype(jopt.mdtype), jstate["v"]),
              "step": jstate["step"]}
    state = {"m": tree_map(lambda x: x.to(opt.mdtype), state["m"]),
             "v": tree_map(lambda x: x.to(opt.mdtype), state["v"]), "step": state["step"]}
    assert int(state["step"]) == int(jstate["step"]) == 30
    batch = _batch(30)
    cfg, jcfg = get_config(ARCH, reduced=True), jax_get_config(ARCH, reduced=True)
    jp, js, jm = jax_make_train_step(jcfg, jopt)(
        jparams, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    before = _flat_np(params)
    p, s, m = make_train_step(cfg, opt)(params, state,
                                        {k: torch.as_tensor(v) for k, v in batch.items()})
    # out of place: the inputs are as they were
    assert all(np.array_equal(before[k], v) for k, v in _flat_np(params).items())
    for key in ("loss", "nll", "lr", "grad_norm"):
        np.testing.assert_allclose(m[key], float(jm[key]), rtol=1e-4, err_msg=key)
    assert int(s["step"]) == int(js["step"]) == 31
    _assert_trees_close(_flat_np(p), jp, 1e-5, "params")
    tol = 1e-4 if moment_dtype == "float32" else 1e-2
    _assert_trees_close(_flat_np(s["m"]), js["m"], tol, "m")
    _assert_trees_close(_flat_np(s["v"]), js["v"], tol, "v")


def _jax_init_flat() -> dict:
    jp = JM.init_params(jax_get_config(ARCH, reduced=True), jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in _flatten_with_paths(jp).items()}


def test_train_matches_reference_train(tmp_path):
    """Reduced smollm_360m, 5 steps of 8 x 64 cyclic tokens, seed 0: the
    reference's train() and the port's from the reference's initial weights."""
    quiet = dict(steps=5, ckpt_every=0, resume=False, log=lambda _: None)
    ref = jax_train(ARCH, ckpt_dir=str(tmp_path / "jax"), **quiet)
    params = params_from_numpy(_jax_init_flat(), get_config(ARCH, reduced=True), "cpu")
    out = train(ARCH, ckpt_dir=str(tmp_path / "torch"), device="cpu", params=params,
                **quiet)
    assert out["start_step"] == 0 and out["watchdog"] == {"timeouts": 0, "retries": 0}
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4, atol=1e-4)
    assert out["losses"][-1] < out["losses"][0]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_resume_from_journal_and_checkpoint_continues_the_run(tmp_path, writer):
    """A run cut after step 3 (checkpoint at steps 1 and 3) and resumed by the
    port gives the losses of an uninterrupted run, whichever package wrote
    the journal and checkpoints."""
    opt = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=6, weight_decay=0.0)
    flat = _jax_init_flat()
    cfg = get_config(ARCH, reduced=True)
    quiet = dict(ckpt_every=2, log=lambda _: None)
    whole = train(ARCH, steps=6, ckpt_dir=str(tmp_path / "whole"), device="cpu",
                  params=params_from_numpy(flat, cfg, "cpu"), opt=OptConfig(**opt), **quiet)
    cut = str(tmp_path / "cut")
    if writer == "port":
        first = train(ARCH, steps=4, ckpt_dir=cut, device="cpu",
                      params=params_from_numpy(flat, cfg, "cpu"), opt=OptConfig(**opt),
                      **quiet)
    else:
        first = jax_train(ARCH, steps=4, ckpt_dir=cut, opt=JOptConfig(**opt), **quiet)
    np.testing.assert_allclose(first["losses"], whole["losses"][:4], rtol=1e-4, atol=1e-4)
    rest = train(ARCH, steps=6, ckpt_dir=cut, device="cpu", opt=OptConfig(**opt), **quiet)
    assert rest["start_step"] == 4
    np.testing.assert_allclose(rest["losses"], whole["losses"][4:], rtol=1e-4, atol=1e-4)


def test_watchdog_reissues_a_failed_step_from_the_same_state():
    """A step that fails once is re-issued with the same inputs: the
    out-of-place update leaves them as they were, so the retry's result is
    the result of a step that never failed."""
    cfg = get_config(ARCH, reduced=True)
    opt = OptConfig(peak_lr=1e-3, warmup_steps=2, decay_steps=6, weight_decay=0.1)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = init_opt_state(params, opt)
    batch = {k: torch.as_tensor(v) for k, v in _batch(0).items()}
    step = make_train_step(cfg, opt)
    calls = []

    def flaky(*args):
        calls.append(1)
        out = step(*args)
        if len(calls) == 1:
            raise RuntimeError("lost the step after its update")
        return out

    dog = StepWatchdog()
    p1, s1, m1 = dog.run(flaky, params, state, batch)
    p2, s2, m2 = step(params, state, batch)
    assert dog.retries_used == 1 and len(calls) == 2
    assert m1 == m2 and int(s1["step"]) == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))


def _spied(monkeypatch, module, name: str, counts: dict):
    """Counts the calls of ``module.name`` that multiply untransposed (the
    forward products, and the float32 z of a fused activation)."""
    fn = getattr(module, name)

    def spy(*args, **kw):
        if not (kw.get("trans_x") or kw.get("trans_w")):
            counts[name] = counts.get(name, 0) + 1
        return fn(*args, **kw)
    monkeypatch.setattr(module, name, spy)


def _grads_and_forwards(monkeypatch, cfg, remat: str):
    from repro_torch.kernels.tile_matmul import ops as tm_ops
    counts: dict = {}
    _spied(monkeypatch, tm_ops, "tile_matmul_ref", counts)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = M.train_loss(leaves, dataclasses.replace(cfg, remat=remat),
                           {k: torch.as_tensor(v) for k, v in _batch(0).items()})
    grads = torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True)
    monkeypatch.undo()
    return loss.item(), grads, counts["tile_matmul_ref"]


def test_remat_dots_gives_the_gradients_of_nothing_bit_for_bit(monkeypatch):
    """Reduced smollm on the CPU: the loss and every gradient under "dots"
    are those under "nothing" and "none" bit for bit, and a step runs each
    forward product once under "dots" (as under "none") where "nothing"
    runs it twice: 7 products a layer, and one float32 z for the SwiGLU
    gate's SiLU in every policy."""
    cfg = get_config(ARCH, reduced=True)
    runs = {r: _grads_and_forwards(monkeypatch, cfg, r) for r in ("nothing", "dots", "none")}
    loss, grads, _ = runs["nothing"]
    for remat in ("dots", "none"):
        assert runs[remat][0] == loss
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][1], grads)), remat
    layers = cfg.n_layers
    assert {r: n for r, (_, _, n) in runs.items()} == {
        "nothing": 2 * 7 * layers + layers, "dots": 7 * layers + layers,
        "none": 7 * layers + layers}


def _layer(x, wq, wo, ssd_in):
    """A layer of the three wrappers on the CPU: a product, the attention,
    the scan, and elementwise work between them."""
    from repro_torch.kernels.flash_attention.ops import attention
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.tile_matmul.ops import matmul
    B, T, d = x.shape
    q = matmul(torch.nn.functional.silu(x), wq).reshape(B, T, 2, d // 2)
    a = attention(q, q[:, :, :1], q[:, :, :1]).reshape(B, T, d)
    y, state = ssd(a.reshape(B, T, 2, d // 2), *ssd_in)
    return matmul(y.reshape(B, T, d) * 2.0, wo) + state.sum()


@pytest.mark.parametrize("remat,forwards", [("nothing", 2), ("dots", 1), ("none", 1)])
def test_remat_dots_runs_each_kernel_forward_once(monkeypatch, remat, forwards):
    """``_remat`` around a layer of ``matmul``, ``attention`` and ``ssd``
    on CPU tensors: under "dots" the recompute gets each forward's output
    back (tile_matmul_ref, flash_attention_ref and the scan's plain version
    run once a step), where "nothing" runs each twice; the gradients are
    the same bits in every policy."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.tile_matmul import ops as tm_ops
    g = torch.Generator().manual_seed(1)
    B, T, d, N = 2, 24, 16, 8
    x, wq, wo = (torch.randn(s, generator=g) for s in ((B, T, d), (d, d), (d, d)))
    ssd_in = (torch.rand((B, T, 2), generator=g), -torch.rand(2, generator=g) - 0.5,
              torch.randn((B, T, 1, N), generator=g), torch.randn((B, T, 1, N), generator=g),
              torch.randn(2, generator=g))
    leaves = [t.requires_grad_(True) for t in (x, wq, wo)]
    cfg = dataclasses.replace(get_config(ARCH, reduced=True), remat="nothing")
    want = torch.autograd.grad(M._remat(_layer, cfg)(*leaves, ssd_in).square().sum(), leaves)
    counts: dict = {}
    _spied(monkeypatch, tm_ops, "tile_matmul_ref", counts)
    _spied(monkeypatch, fa_ops, "flash_attention_ref", counts)
    _spied(monkeypatch, ssd_ops, "ssd_plain", counts)
    out = M._remat(_layer, dataclasses.replace(cfg, remat=remat))(*leaves, ssd_in)
    got = torch.autograd.grad(out.square().sum(), leaves)
    assert counts == {"tile_matmul_ref": 2 * forwards, "flash_attention_ref": forwards,
                      "ssd_plain": forwards}
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_a_kept_output_answers_only_the_call_that_made_it():
    """The tape hands an output back only to the same call at the same
    point with the same shapes, and refuses one written in place."""
    from repro_torch.kernels import _keep
    tape = _keep.Tape()
    x = torch.ones(3)
    with _keep.playing(tape):
        first = _keep.kept(torch.neg, x)
    with _keep.playing(tape):
        again = _keep.kept(torch.neg, x)
    assert torch.equal(again, first) and again is not first
    with _keep.playing(tape), pytest.raises(RuntimeError, match="other shapes"):
        _keep.kept(torch.neg, torch.ones(4))
    with _keep.playing(tape), pytest.raises(RuntimeError, match="past"):
        _keep.kept(torch.neg, x)
        _keep.kept(torch.neg, x)
    first.add_(1.0)
    with _keep.playing(tape), pytest.raises(RuntimeError, match="in place"):
        _keep.kept(torch.neg, x)


def test_scan_gradient_on_the_card_raises_instead_of_stopping(monkeypatch):
    """A gradient through the scan on a non-CPU tensor goes to the kernels,
    never to the plain version: with no kernel that takes meta tensors it
    raises, and with both launches recorded the forward reaches
    ``ssd_scan`` (writing the chunk states) and the backward
    ``ssd_scan_bwd`` (reading them), whose gradients come back to every
    input."""
    from repro_torch.kernels.ssd_scan import kernel
    from repro_torch.kernels.ssd_scan.ops import ssd

    def inputs():
        shapes = ((1, 8, 2, 16), (1, 8, 2), (2,), (1, 8, 1, 16), (1, 8, 1, 16), (2,))
        return [torch.empty(s, device="meta", requires_grad=True) for s in shapes]

    with pytest.raises(ValueError, match="CUDA"):
        ssd(*inputs())
    calls = []

    def launch(x, dt, a, b, c, d, chunk_states):
        calls.append(("ssd_scan", tuple(chunk_states.shape)))
        return torch.empty_like(x), x.new_empty((1, 2, 16, 16))

    def launch_bwd(x, dt, a, b, c, d, dy, dstate, states):
        calls.append(("ssd_scan_bwd", tuple(dy.shape), tuple(dstate.shape),
                      tuple(states.shape)))
        return tuple(torch.empty_like(t) for t in (x, dt, a, b, c, d))

    monkeypatch.setattr(kernel, "ssd_scan", launch)
    monkeypatch.setattr(kernel, "ssd_scan_bwd", launch_bwd)
    leaves = inputs()
    y, state = ssd(*leaves)
    grads = torch.autograd.grad((y.sum(), state.sum()), leaves)
    # one chunk of 64 steps: its entry state and the final state
    assert calls == [("ssd_scan", (1, 2, 2, 16, 16)),
                     ("ssd_scan_bwd", (1, 8, 2, 16), (1, 2, 16, 16), (1, 2, 2, 16, 16))]
    assert [g.shape for g in grads] == [t.shape for t in leaves]
