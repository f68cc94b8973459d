"""Checkpoints, journal and data of the port against the JAX reference, on
the CPU: a checkpoint written by either package loads in the other with the
same bits (bf16 and float32 params, float32 / bf16 / int8 moments, the step),
the reference's ``ckpt_29`` loads through both of the port's paths, either
package replays the other's journal, and ``batch_at`` gives the same
batches."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpoint import _flatten_with_paths
from repro.checkpoint.checkpoint import load_checkpoint as jax_load
from repro.checkpoint.checkpoint import save_checkpoint as jax_save
from repro.checkpoint.journal import TrainJournal as JaxJournal
from repro.configs.base import get_config as jax_get_config
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import model as JM
from repro.optim.optimizer import OptConfig as JOptConfig
from repro.optim.optimizer import adamw_update as jax_adamw
from repro.optim.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.checkpoint.checkpoint import _flatten, load_checkpoint, save_checkpoint
from repro_torch.checkpoint.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.checkpoint.journal import TrainJournal
from repro_torch.configs.base import get_config
from repro_torch.data.frontend import pipeline_for
from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
from repro_torch.models import model as M
from repro_torch.optim.optimizer import OptConfig, adamw_update, init_opt_state, tree_map

CKPT = Path(__file__).resolve().parents[1] / "runs/quickstart/smollm_360m_reduced/ckpt_29"
ARCH = "smollm_360m"


def _bits(x) -> np.ndarray:
    """An array's raw bits (bf16 through a uint16 view)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16).astype(np.int16) if x.dtype == jnp.bfloat16 else x


def _same(port_tree, jax_tree) -> None:
    got = {k: _bits(v) for k, v in _flatten(port_tree).items()}
    want = {k: _bits(v) for k, v in _flatten_with_paths(jax_tree).items()}
    assert got.keys() == want.keys(), sorted(got.keys() ^ want.keys())
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _stepped_states(param_dtype: str, moment_dtype: str):
    """Reference params (``param_dtype``) and an AdamW state after one step,
    and the port's copies of both."""
    jcfg = jax_get_config(ARCH, reduced=True)
    jcfg = type(jcfg)(**{**jcfg.__dict__, "param_dtype": param_dtype})
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(1))
    jopt = JOptConfig(moment_dtype=moment_dtype)
    grads = jax.tree.map(lambda p: jnp.ones_like(p) * 0.01, jparams)
    jparams, jstate, _ = jax_adamw(jparams, grads, jax_init_opt_state(jparams, jopt), jopt)
    cfg = get_config(ARCH, reduced=True)
    flat = {k: np.asarray(v) for k, v in _flatten_with_paths(jparams).items()}
    to_t = {k: (torch.from_numpy(v.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
                if v.dtype == jnp.bfloat16 else v) for k, v in flat.items()}
    params = params_from_numpy(to_t, cfg, "cpu")
    sflat = {k: np.asarray(v) for k, v in _flatten_with_paths(jstate).items()}
    sflat = {k: (torch.from_numpy(v.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
                 if v.dtype == jnp.bfloat16 else v) for k, v in sflat.items()}
    state = opt_state_from_numpy(sflat, cfg, "cpu")
    return (jparams, jstate, jopt), (params, state, OptConfig(moment_dtype=moment_dtype))


CASES = [("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "int8")]


@pytest.mark.parametrize("param_dtype,moment_dtype", CASES)
def test_port_checkpoint_loads_in_the_reference(tmp_path, param_dtype, moment_dtype):
    (jparams, jstate, jopt), (params, state, _) = _stepped_states(param_dtype, moment_dtype)
    _same(params, jparams)
    _same(state, jstate)
    save_checkpoint(str(tmp_path), 7, params, state)
    like = jax.tree.map(jnp.zeros_like, jparams)
    step, lp, ls = jax_load(str(tmp_path), like, jax_init_opt_state(like, jopt))
    assert step == 7
    _same(params, lp)
    _same(state, ls)


@pytest.mark.parametrize("param_dtype,moment_dtype", CASES)
def test_reference_checkpoint_loads_in_the_port(tmp_path, param_dtype, moment_dtype):
    (jparams, jstate, _), (params, state, opt) = _stepped_states(param_dtype, moment_dtype)
    jax_save(str(tmp_path), 3, jparams, jstate)
    like = tree_map(torch.zeros_like, params)
    step, lp, ls = load_checkpoint(str(tmp_path), like, init_opt_state(like, opt))
    assert step == 3
    _same(lp, jparams)
    _same(ls, jstate)
    step, only, none = load_checkpoint(str(tmp_path), like)
    assert none is None
    _same(only, jparams)


def test_ckpt_29_loads_through_both_port_paths():
    cfg = get_config(ARCH, reduced=True)
    like = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step, params, state = load_checkpoint(str(CKPT), like, init_opt_state(like, OptConfig()))
    assert step == 29 and int(state["step"]) == 30
    with np.load(CKPT / "params.npz") as p, np.load(CKPT / "opt.npz") as o:
        conv_p = params_from_numpy(dict(p), cfg, "cpu")
        conv_s = opt_state_from_numpy(dict(o), cfg, "cpu")
    for a, b in ((params, conv_p), (state, conv_s)):
        fa, fb = _flatten(a), _flatten(b)
        assert fa.keys() == fb.keys()
        assert all(torch.equal(fa[k], fb[k]) for k in fa)


def test_checkpoint_commits_the_manifest_last(tmp_path):
    """The manifest is renamed into place after the arrays: a directory
    with arrays but no manifest is not a checkpoint."""
    cfg = get_config(ARCH, reduced=True)
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    save_checkpoint(str(tmp_path), 1, params)
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["manifest.json", "params.npz"]


def test_updated_state_stays_loadable(tmp_path):
    """A port-updated int8 state round-trips through a checkpoint."""
    cfg = get_config(ARCH, reduced=True)
    opt = OptConfig(moment_dtype="int8")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    grads = tree_map(lambda p: torch.full_like(p, 0.01), params)
    params, state, _ = adamw_update(params, grads, init_opt_state(params, opt), opt)
    save_checkpoint(str(tmp_path), 0, params, state)
    like = tree_map(torch.zeros_like, params)
    _, lp, ls = load_checkpoint(str(tmp_path), like, init_opt_state(like, opt))
    for a, b in ((params, lp), (state, ls)):
        fa, fb = _flatten(a), _flatten(b)
        assert all(torch.equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_either_package_replays_the_others_journal(tmp_path, writer):
    path = str(tmp_path / "j" / "journal.jsonl")
    write, read = ((TrainJournal, JaxJournal) if writer == "port"
                   else (JaxJournal, TrainJournal))
    w = write(path)
    for step in range(3):
        w.append({"step": step, "loss": 1.0 / (step + 1), "ckpt": None, "data_cursor": step})
    recs = read(path).replay()
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert read(path).latest() == write(path).latest()
    with open(path, "a") as f:
        f.write('{"torn": ')
    assert len(read(path).replay()) == 3


@pytest.mark.parametrize("kw", [
    dict(mode="random"), dict(mode="cyclic"), dict(mode="cyclic", n_codebooks=3),
    dict(mode="random", embed_dim=8), dict(mode="cyclic", seed=5)])
def test_batch_at_is_identical(kw):
    cfg = dict(vocab=97, batch=3, seq=16) | kw
    port, ref = TokenPipeline(PipelineConfig(**cfg)), JTokenPipeline(JPipelineConfig(**cfg))
    for step in (0, 1, 29, 1000):
        a, b = port.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (step, k)


@pytest.mark.parametrize("arch,mode", [("smollm_360m", "cyclic"), ("musicgen_medium", "cyclic"),
                                       ("musicgen_medium", "random"),
                                       ("internvl2_76b", "cyclic")])
def test_pipeline_for_feeds_each_frontend_as_the_reference_train_does(arch, mode):
    """``pipeline_for`` gives the batches that the reference's ``train()``
    builds for the config's frontend: token ids, codebook tokens (B, T, K),
    or seeded embeddings (B, T, d)."""
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch, reduced=True)
    port = pipeline_for(cfg, 2, 12, seed=4, mode=mode)
    ref = JTokenPipeline(JPipelineConfig(
        vocab=jcfg.vocab, batch=2, seq=12, seed=4, mode=mode,
        n_codebooks=jcfg.n_codebooks if jcfg.frontend == "codebooks" else 0,
        embed_dim=jcfg.d_model if jcfg.frontend == "embeds" else 0))
    for step in (0, 3):
        a, b = port.batch_at(step), ref.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (step, k)
    first = port.batch_at(0)
    want = {"codebooks": "tokens", "embeds": "embeds"}.get(cfg.frontend, "tokens")
    assert first[want].shape[:2] == (2, 12)
