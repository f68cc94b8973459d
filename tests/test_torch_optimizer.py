"""The port's AdamW (``repro_torch.optim.optimizer``) against the JAX
reference, on the CPU: the schedule, the update with float32, bfloat16 and
int8 moments over a few steps, and the blockwise int8 quantization bit for
bit. The same numpy trees go to both packages. Tolerances: schedule and
float32 updates 1e-6 relative (the same float32 formulas in another
order); moments 1e-5 in float32 and one bf16 ulp (2^-8 relative) in
bfloat16 (a float32 moment that lands next to a rounding tie may round the
other way); int8 moments within one quantization step (q within 1) and
scales within 1e-6. Each update starts both packages from the same state,
so a moment rounded the other way does not carry into the next step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import optimizer as J
from repro_torch.optim import optimizer as T


def _opt_kwargs(moment_dtype="float32"):
    return dict(peak_lr=1e-2, warmup_steps=3, decay_steps=8, min_lr_ratio=0.1,
                weight_decay=0.1, clip_norm=1.0, moment_dtype=moment_dtype)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 6, 8, 9, 50])
def test_schedule_matches_reference(step):
    kw = _opt_kwargs()
    got = T.schedule(T.OptConfig(**kw), torch.tensor(step, dtype=torch.int32))
    want = J.schedule(J.OptConfig(**kw), jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _trees(seed: int):
    """A reference tree (period leaves stacked on a leading axis of 2) and
    the port's (the same leaves, one dict a layer in a list), from numpy."""
    rng = np.random.default_rng(seed)
    arrs = {"embed": rng.standard_normal((50, 3000)).astype(np.float32) * 0.02,
            "final_ln": 1 + 0.1 * rng.standard_normal(24).astype(np.float32),
            "w": rng.standard_normal((2, 24, 40)).astype(np.float32) * 0.02,
            "ln": 1 + 0.1 * rng.standard_normal((2, 24)).astype(np.float32),
            "bias": np.asarray(0.1 * rng.standard_normal(()), np.float32)}
    ref = {"embed": {"tok": arrs["embed"]}, "final_ln": arrs["final_ln"],
           "period": ({"w": arrs["w"], "ln": arrs["ln"]},), "bias": arrs["bias"]}
    port = {"embed": {"tok": arrs["embed"]}, "final_ln": arrs["final_ln"],
            "period": ([{"w": arrs["w"][i], "ln": arrs["ln"][i]} for i in range(2)],),
            "bias": arrs["bias"]}
    return (jax.tree.map(jnp.asarray, ref),
            T.tree_map(lambda x: x, jax.tree.map(torch.from_numpy, port)))


def _port_flat(tree) -> dict:
    from repro_torch.checkpoint.checkpoint import _flatten
    return {k: v.float().numpy() for k, v in _flatten(tree).items()}


def _ref_flat(tree) -> dict:
    from repro.checkpoint.checkpoint import _flatten_with_paths
    return {k: np.asarray(v, np.float32) for k, v in _flatten_with_paths(tree).items()}


def _as_torch(x) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype == jnp.bfloat16:
        return torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def _port_tree(ref):
    """The port's layout of a reference tree of ``_trees``' structure (its
    period leaves, or int8 moment dicts, unstacked into a list of 2)."""
    r = jax.tree.map(_as_torch, ref)
    per = [jax.tree.map(lambda a, i=i: a[i], r["period"][0]) for i in range(2)]
    return {"embed": r["embed"], "final_ln": r["final_ln"], "period": (per,), "bias": r["bias"]}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(moment_dtype):
    """Four updates, each from the same state in both packages (the
    reference's previous output): the first clips the gradient, each one
    decays the rank >= 2 leaves. The port's inputs are left as they were."""
    kw = _opt_kwargs(moment_dtype)
    jcfg, tcfg = J.OptConfig(**kw), T.OptConfig(**kw)
    jp, _ = _trees(1)
    js = J.init_opt_state(jp, jcfg)
    for step in range(4):
        tp = _port_tree(jp)
        ts = {"m": _port_tree(js["m"]), "v": _port_tree(js["v"]),
              "step": _as_torch(js["step"])}
        jg, tg = _trees(100 + step)
        jg = jax.tree.map(lambda x: x * (3.0 if step == 0 else 0.5), jg)   # clipped once
        tg = T.tree_map(lambda x: x * (3.0 if step == 0 else 0.5), tg)
        before = _port_flat(tp)
        jp, js, jm = J.adamw_update(jp, jg, js, jcfg)
        new_tp, new_ts, tm = T.adamw_update(tp, tg, ts, tcfg)
        assert all(np.array_equal(v, _port_flat(tp)[k]) for k, v in before.items())
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-6)
        assert int(new_ts["step"]) == int(js["step"]) == step + 1
        want, got = _ref_flat(jp), _port_flat(new_tp)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
        for name in ("m", "v"):
            if moment_dtype == "int8":
                _check_int8_moments(js[name], new_ts[name])
            else:
                w_m, g_m = _ref_flat(js[name]), _port_flat(new_ts[name])
                tol = 1e-5 if moment_dtype == "float32" else 2 ** -8
                for k in w_m:
                    np.testing.assert_allclose(g_m[k], w_m[k], rtol=tol,
                                               atol=tol * np.abs(w_m[k]).max(), err_msg=k)


def _check_int8_moments(jtree, ttree):
    """Quantized moments within one step (q within 1) of each other; scales
    within 1e-6 relative."""
    from repro.checkpoint.checkpoint import _flatten_with_paths
    from repro_torch.checkpoint.checkpoint import _flatten
    jf = {k: np.asarray(v) for k, v in _flatten_with_paths(jtree).items()}
    tf = {k: v.numpy() for k, v in _flatten(ttree).items()}
    assert jf.keys() == tf.keys()
    for key in [k[:-2] for k in jf if k.endswith("/q")]:
        js, ts = jf[key + "/s"], tf[key + "/s"]
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=1e-12, err_msg=key)
        jq, tq = jf[key + "/q"].astype(np.int32), tf[key + "/q"].astype(np.int32)
        assert np.abs(jq - tq).max() <= 1, key


QUANT_SHAPES = [(5000,), (3, 2048), (2, 3, 100), (4, 2049), ()]


@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_blockwise_quantization_is_bit_equal_to_reference(shape):
    rng = np.random.default_rng(len(shape) * 7 + sum(shape))
    x = np.asarray(rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 30.0]), np.float32)
    j = J.quantize_blockwise(jnp.asarray(x))
    t = T.quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(t["s"].numpy(), np.asarray(j["s"]))
    assert tuple(t["s"].shape) == T.scale_shape(shape) == J.scale_shape(shape)
    np.testing.assert_array_equal(T.dequantize_blockwise(t, shape).numpy(),
                                  np.asarray(J.dequantize_blockwise(j, shape)))


def test_quantization_rounds_half_to_even_as_the_reference():
    """A block whose absmax is 127 has scale 1, so x.5 values are exact
    ties: both round them to the even neighbour."""
    x = np.array([127.0, 2.5, 3.5, -2.5, -0.5, 0.5, 1.5, 126.5], np.float32)
    j = J.quantize_blockwise(jnp.asarray(x))
    t = T.quantize_blockwise(torch.from_numpy(x))
    np.testing.assert_array_equal(t["q"].numpy(), [127, 2, 4, -2, 0, 0, 2, 126])
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))


def test_init_opt_state_shapes_and_dtypes():
    _, tp = _trees(0)
    for md, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        st = T.init_opt_state(tp, T.OptConfig(moment_dtype=md))
        assert [m.dtype for m in T.tree_leaves(st["m"])] == [dt] * 7
        assert st["step"].dtype == torch.int32 and int(st["step"]) == 0
    st = T.init_opt_state(tp, T.OptConfig(moment_dtype="int8"))
    tok = st["m"]["embed"]["tok"]
    assert tok["q"].dtype == torch.int8 and tuple(tok["s"].shape) == (50, 2)
    assert tuple(st["v"]["bias"]["s"].shape) == (1,)


def test_weight_decay_follows_the_reference_stacked_rank():
    """Period norms decay (rank 2 once stacked), final_ln and the scalar do
    not; with zero gradients only the decayed leaves move."""
    _, tp = _trees(2)
    cfg = T.OptConfig(peak_lr=1e-2, warmup_steps=0, decay_steps=1, weight_decay=0.5)
    zeros = T.tree_map(torch.zeros_like, tp)
    new, _, _ = T.adamw_update(tp, zeros, T.init_opt_state(tp, cfg), cfg)
    moved = {k: not np.array_equal(v, _port_flat(tp)[k]) for k, v in _port_flat(new).items()}
    assert moved == {"embed/tok": True, "final_ln": False, "period/0/w": True,
                     "period/0/ln": True, "bias": False}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_donated_gradients_take_the_new_params(moment_dtype):
    """``donate_grads``: the same update, each new parameter written into its
    gradient's memory, except where two leaves share one gradient tensor
    (which stays as it was); params and state are left as they were."""
    cfg = T.OptConfig(**_opt_kwargs(moment_dtype))
    _, tp = _trees(3)
    state = T.init_opt_state(tp, cfg)
    _, tg = _trees(4)
    shared = torch.full((24,), 0.5)
    tg["final_ln"] = tg["period"][0][0]["ln"] = shared
    want_p, want_s, want_m = T.adamw_update(tp, tg, state, cfg)
    before, grads = _port_flat(tp), T.tree_map(torch.clone, tg)
    grads["final_ln"] = grads["period"][0][0]["ln"] = shared
    got_p, got_s, got_m = T.adamw_update(tp, grads, state, cfg, donate_grads=True)
    assert all(np.array_equal(v, _port_flat(tp)[k]) for k, v in before.items())
    assert torch.equal(shared, torch.full((24,), 0.5))
    for k in ("lr", "grad_norm"):
        assert torch.equal(got_m[k], want_m[k])
    for a, b in zip(T.tree_leaves((got_p, got_s)), T.tree_leaves((want_p, want_s))):
        assert torch.equal(a, b)
    for p, g in zip(T.tree_leaves(got_p), T.tree_leaves(grads)):
        assert (p.data_ptr() == g.data_ptr()) == (g is not shared)


def test_global_norm_of_a_long_leaf_holds_float32_precision_on_the_cpu():
    """A 2^23-element leaf (gemma3_12b's tied embedding has 1e9): the CPU's
    float32 norm of the whole leaf drifts by about 3e-4; summed in runs,
    the global norm stays within 1e-6 of the float64 one."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1 << 23).astype(np.float32))
    tree = {"embed": x * 1e-4, "ln": torch.full((24,), 1e-3)}
    want = np.sqrt(sum(float((t.double() ** 2).sum()) for t in tree.values()))
    got = T.global_norm(tree)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
