"""The port's ssd_scan module against the JAX reference, on the CPU.

The same numpy inputs go through the reference (its per-timestep oracle, and
its Pallas kernel in interpret mode through ``repro.kernels.ssd_scan.ops.ssd``,
as ``tests/test_kernels.py`` runs it) and through the port, whose wrapper
runs the plain PyTorch version on a CPU tensor. The reference kernel needs
T to be a multiple of its chunk; the port's wrapper takes any T, so a ragged
case gives the reference a chunk that divides T.

Tolerances: the reference's SSD bar, 1e-3, for float32 results (outputs,
and the float32 final state also for bfloat16 inputs); 2e-2, the
reference's bfloat16 bar, for outputs rounded to bfloat16 (one bf16 ulp at
magnitude 2 is 1.6e-2, and the two sides round float32 sums that differ in
their last bits). The two oracles run the same recurrence: 1e-5.

The scan's gradient: the plain adjoint (``ssd_plain_bwd``) against
``jax.vjp`` of the reference's ``ssd_chunked`` and of its per-timestep
oracle, in float32, each gradient within 1e-3 of its largest entry; and a
plain-torch emulation of the backward kernel's chunked arithmetic (the
formulas of ``csrc/ssd_scan_bwd.cu``) against the adjoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd as jax_ssd
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_scan_ref
from repro.models.mamba2 import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels.ssd_scan import kernel
from repro_torch.kernels.ssd_scan.ops import ssd, ssd_plain, ssd_plain_bwd
from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref
from repro_torch.models.mamba2 import ssd_chunked

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(bt, t, h, p, g, n, seed):
    """Inputs of test_kernels.py's SSD sweep, made with numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bt, t, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bt, t, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((bt, t, g, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((bt, t, g, n)) * 0.5).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(h)).astype(np.float32)
    return x, dt, A, B, C, D


def _np(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


@pytest.mark.parametrize("bh,t,p,n", [(4, 32, 8, 8), (6, 17, 16, 4), (2, 1, 8, 16)])
def test_ref_matches_reference_oracle(bh, t, p, n):
    rng = np.random.default_rng(bh * 100 + t)
    x = rng.standard_normal((bh, t, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bh, t)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(bh) * 0.3).astype(np.float32)
    b = (rng.standard_normal((bh, t, n)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((bh, t, n)) * 0.5).astype(np.float32)
    d = rng.standard_normal(bh).astype(np.float32)
    args = (x, dt, a, b, c, d)
    yr, sr = jax_ssd_scan_ref(*map(jnp.asarray, args))
    y, s = ssd_scan_ref(*map(torch.from_numpy, args))
    assert y.dtype == torch.float32 and s.shape == (bh, n, p)
    np.testing.assert_allclose(_np(y), _np(yr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(s), _np(sr), rtol=1e-5, atol=1e-5)


SWEEP = [  # (bt, t, h, p, g, n, reference chunk, dtype)
    (1, 32, 2, 8, 1, 8, 16, "float32"),
    (2, 64, 4, 16, 2, 16, 32, "float32"),
    (2, 128, 4, 8, 2, 8, 16, "float32"),
    (2, 40, 4, 16, 2, 16, 40, "float32"),      # ragged against Q = 16 / 64
    (1, 100, 2, 8, 1, 16, 50, "float32"),      # ragged, two chunks of 50
    (2, 64, 4, 16, 2, 16, 32, "bfloat16"),
    (1, 40, 4, 8, 4, 8, 20, "bfloat16"),       # G = H, ragged
]


def _both_ssd(x, dt, A, B, C, D, dtype, chunk):
    jd, td = DTYPES[dtype]
    jx, jB, jC = (jnp.asarray(a).astype(jd) for a in (x, B, C))
    ref = jax_ssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, jnp.asarray(D), chunk=chunk)
    tx, tB, tC = (torch.from_numpy(a).to(td) for a in (x, B, C))
    out = ssd(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC, torch.from_numpy(D))
    return out, ref


@pytest.mark.parametrize("bt,t,h,p,g,n,chunk,dtype", SWEEP)
def test_ssd_matches_reference_kernel(bt, t, h, p, g, n, chunk, dtype):
    """bfloat16 cases run twice: in bfloat16 (outputs rounded on both
    sides, 2e-2), and on the same bf16-valued inputs in float32 at 1e-3."""
    x, dt, A, B, C, D = _inputs(bt, t, h, p, g, n, seed=t * 7 + h + g)
    (y, s), (yr, sr) = _both_ssd(x, dt, A, B, C, D, dtype, chunk)
    assert y.dtype == DTYPES[dtype][1] and y.shape == (bt, t, h, p)
    assert s.dtype == torch.float32 and s.shape == (bt, h, n, p)
    ytol = 1e-3 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(y), _np(yr), rtol=ytol, atol=ytol)
    np.testing.assert_allclose(_np(s), _np(sr), rtol=1e-3, atol=1e-3)
    if dtype == "bfloat16":
        x, B, C = (np.asarray(torch.from_numpy(a).bfloat16().float()) for a in (x, B, C))
        (y, s), (yr, sr) = _both_ssd(x, dt, A, B, C, D, "float32", chunk)
        np.testing.assert_allclose(_np(y), _np(yr), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(_np(s), _np(sr), rtol=1e-3, atol=1e-3)


def test_wrapper_state_is_the_transpose_of_ssd_chunked_state():
    """The kernel's (and the wrapper's) final state is (Bt, H, N, P), the
    model cache's (Bt, H, P, N): P != N here, so a missing transpose shows."""
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in _inputs(2, 24, 4, 8, 2, 16, seed=3))
    _, s = ssd(x, dt, A, B, C, D)
    _, s_chunked = ssd_chunked(x, dt, A, B, C, D, chunk=16)
    assert s.shape == (2, 4, 16, 8) and s_chunked.shape == (2, 4, 8, 16)
    np.testing.assert_allclose(_np(s.transpose(-1, -2)), _np(s_chunked), rtol=1e-4,
                               atol=1e-4)


def test_ssd_matches_reference_ssd_chunked_on_ragged_t():
    x, dt, A, B, C, D = _inputs(2, 45, 4, 8, 2, 8, seed=11)
    yr, _ = jax_ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C, D)), chunk=16)
    y, _ = ssd(*map(torch.from_numpy, (x, dt, A, B, C, D)))
    np.testing.assert_allclose(_np(y), _np(yr), rtol=1e-3, atol=1e-3)


def test_non_cpu_tensor_reaches_the_kernel_and_raises():
    x, dt, A, B, C, D = (torch.from_numpy(a).to("meta")
                         for a in _inputs(1, 16, 2, 8, 1, 8, seed=1))
    before = kernel.ssd_scan.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd(x, dt, A, B, C, D)
    assert kernel.ssd_scan.launches == before


@pytest.mark.parametrize("dtype,n,p,aligned,path", [
    (torch.bfloat16, 128, 64, True, "mma"),     # every mamba2_2_7b prefill scan
    (torch.bfloat16, 64, 32, True, "mma"),
    (torch.bfloat16, 128, 96, True, "mma"),     # three 32-column slices of P
    (torch.bfloat16, 128, 64, False, "ffma"),   # cp.async needs 16-byte rows
    (torch.bfloat16, 16, 64, True, "ffma"),     # N not 64 or 128
    (torch.bfloat16, 128, 48, True, "ffma"),    # P not a multiple of 32
    (torch.float32, 128, 64, True, "ffma"),     # float32 parity runs
])
def test_path_choice(dtype, n, p, aligned, path):
    assert kernel.choose_path(dtype, n, p, aligned) == path
    assert set(kernel.ssd_scan.paths) == set(kernel.PATH_CODES) == {"mma", "ffma"}


@pytest.mark.parametrize("dtype,n,p,aligned,path", [
    (torch.bfloat16, 128, 64, True, "mma"),     # every mamba2_2_7b layer's backward
    (torch.bfloat16, 64, 32, True, "mma"),
    (torch.bfloat16, 128, 96, True, "ffma"),    # G's rows of P no longer fit registers
    (torch.bfloat16, 128, 64, False, "ffma"),   # cp.async needs 16-byte rows
    (torch.bfloat16, 16, 64, True, "ffma"),     # N not 64 or 128
    (torch.float32, 128, 64, True, "ffma"),     # float32 parity runs
])
def test_backward_path_choice(dtype, n, p, aligned, path):
    assert kernel.choose_bwd_path(dtype, n, p, aligned) == path
    assert set(kernel.ssd_scan_bwd.paths) == {"mma", "ffma"}


def test_path_choice_refuses_other_dtypes():
    for choose in (kernel.choose_path, kernel.choose_bwd_path):
        with pytest.raises(ValueError):
            choose(torch.float16, 128, 64, True)


def _split(v, pair):
    """v rounded to bf16 once, or as the hi + lo pair hi = bf16(v),
    lo = bf16(v - hi) whose two products the mma path sums."""
    hi = v.bfloat16().float()
    return hi + (v - hi).bfloat16().float() if pair else hi


def _ssd_rounded(x, dt, A, B, C, D, pair, Q=64):
    """Plain-torch emulation of the mma path's arithmetic: chunks of Q = 64
    (a ragged tail padded with dt = 0), float32 sums, x/B/C exact in bf16,
    and the float32 operands M = (C B^T) o L o dt, S and B o w entering the
    products through ``_split``."""
    Bt, T, H, P = x.shape
    N, rep = B.shape[3], H // B.shape[2]
    xf = x.float()
    Bf, Cf = (t.float().repeat_interleave(rep, 2) for t in (B, C))
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, :, :, None]
    y = torch.zeros(Bt, T, H, P)
    S = torch.zeros(Bt, H, N, P)
    for t0 in range(0, T, Q):
        n = min(Q, T - t0)

        def chunk(a):
            out = a.new_zeros((Bt, Q) + a.shape[2:])
            out[:, :n] = a[:, t0:t0 + n]
            return out
        xc, bc, cc, dc = chunk(xf), chunk(Bf), chunk(Cf), chunk(dt)
        cum = torch.cumsum(dc * A, 1)                                    # (Bt, Q, H)
        L = torch.where(tril, torch.exp(cum[:, :, None] - cum[:, None]), 0.0)
        M = _split(torch.einsum("bihn,bjhn->bijh", cc, bc) * L * dc[:, None], pair)
        yc = (torch.einsum("bijh,bjhp->bihp", M, xc)
              + torch.exp(cum)[..., None] * torch.einsum("bihn,bhnp->bihp", cc, _split(S, pair))
              + D[:, None] * xc)
        w = torch.exp(cum[:, -1:] - cum) * dc
        S = (torch.exp(cum[:, -1])[..., None, None] * S
             + torch.einsum("bjhn,bjhp->bhnp", _split(bc * w[..., None], pair), xc))
        y[:, t0:t0 + n] = yc[:, :n]
    return y.to(x.dtype), S


_ROUNDING_SHAPE = (1, 200, 4, 64, 2, 128)   # ragged against Q = 64, G = 2, N 128


def _rounded_and_reference(pair):
    """(y, state) of the emulation and of the reference's Pallas kernel in
    interpret mode (chunk 40 divides T = 200), on the same bf16 x/B/C."""
    x, dt, A, B, C, D = _inputs(*_ROUNDING_SHAPE, seed=3)
    jx, jB, jC = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, B, C))
    yr, sr = jax_ssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC, jnp.asarray(D), chunk=40)
    tx, tB, tC = (torch.from_numpy(a).bfloat16() for a in (x, B, C))
    y, s = _ssd_rounded(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
                        torch.from_numpy(D), pair)
    return (_np(y), _np(s)), (_np(yr), _np(sr))


def test_mma_rounding_scheme_holds_the_reference_bars():
    """The hi + lo pairs keep the kernel's arithmetic within the SSD state
    bar (1e-3) and the bf16 output bar (2e-2) of the reference."""
    (y, s), (yr, sr) = _rounded_and_reference(pair=True)
    assert np.abs(sr).max() > 0.5   # a state of the size the bar is meant for
    np.testing.assert_allclose(s, sr, rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(y, yr, rtol=2e-2, atol=2e-2)


def test_one_bf16_rounding_of_the_float32_operands_misses_the_state_bar():
    """Why the mma path pays for the second product: rounding M, S and
    B o w to bf16 once misses the state bar at the same inputs."""
    (_, s), (_, sr) = _rounded_and_reference(pair=False)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(s, sr, rtol=1e-3, atol=1e-3)


# --- the scan's gradient -----------------------------------------------------

GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


def _cotangents(bt, t, h, p, g, n, seed):
    """dy (Bt, T, H, P) and a final-state gradient (Bt, H, N, P)."""
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((bt, t, h, p)) * 0.5).astype(np.float32),
            (rng.standard_normal((bt, h, n, p)) * 0.5).astype(np.float32))


def _assert_grads_close(got, want, rtol, what=""):
    """Each gradient within ``rtol`` of its reference's largest entry."""
    for name, a, b in zip(GRADS, got, want):
        b = _np(b)
        np.testing.assert_allclose(_np(a), b, rtol=0, atol=rtol * np.abs(b).max(),
                                   err_msg=f"{what} {name}")


BWD_SWEEP = [  # (bt, t, h, p, g, n, reference chunk)
    (1, 32, 2, 8, 1, 8, 16),
    (2, 48, 4, 8, 2, 16, 16),
    (2, 45, 4, 8, 2, 8, 16),      # ragged against the chunk
    (1, 100, 2, 16, 1, 16, 32),   # ragged, four chunks of 32
    (2, 24, 4, 8, 1, 16, 24),     # one chunk
]


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("bt,t,h,p,g,n,chunk", BWD_SWEEP)
def test_plain_bwd_matches_vjp_of_reference_ssd_chunked(bt, t, h, p, g, n, chunk,
                                                        with_dstate):
    args = _inputs(bt, t, h, p, g, n, seed=t + h + g)
    dy, ds = _cotangents(bt, t, h, p, g, n, seed=t)
    ds = ds if with_dstate else np.zeros_like(ds)
    (_, _), vjp = jax.vjp(lambda *a: jax_ssd_chunked(*a, chunk=chunk),
                          *map(jnp.asarray, args))
    # ssd_chunked's state is (Bt, H, P, N), the port's (Bt, H, N, P)
    want = vjp((jnp.asarray(dy), jnp.asarray(ds.transpose(0, 1, 3, 2))))
    got = ssd_plain_bwd(*map(torch.from_numpy, args), torch.from_numpy(dy),
                        torch.from_numpy(ds) if with_dstate else None)
    for grad, arg in zip(got, args):
        assert grad.shape == arg.shape and grad.dtype == torch.float32
    _assert_grads_close(got, want, 1e-3)


@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("bh,t,p,n", [(4, 32, 8, 8), (6, 17, 16, 4), (2, 1, 8, 16)])
def test_plain_bwd_matches_vjp_of_reference_oracle(bh, t, p, n, with_dstate):
    """The per-(batch, head) adjoint against ``jax.vjp`` of the reference's
    per-timestep ``ssd_scan_ref`` (G = H, batch 1: no sums over heads)."""
    x, dt, A, B, C, D = _inputs(1, t, bh, p, bh, n, seed=bh + t)
    dy, ds = _cotangents(1, t, bh, p, bh, n, seed=p)
    ds = ds if with_dstate else np.zeros_like(ds)
    folded = (x[0].transpose(1, 0, 2), dt[0].T, A, B[0].transpose(1, 0, 2),
              C[0].transpose(1, 0, 2), D)
    _, vjp = jax.vjp(jax_ssd_scan_ref, *map(jnp.asarray, folded))
    want = vjp((jnp.asarray(dy[0].transpose(1, 0, 2)), jnp.asarray(ds[0])))
    got = ssd_plain_bwd(*map(torch.from_numpy, (x, dt, A, B, C, D)), torch.from_numpy(dy),
                        torch.from_numpy(ds))
    got = (got[0][0].transpose(0, 1), got[1][0].T, got[2], got[3][0].transpose(0, 1),
           got[4][0].transpose(0, 1), got[5])
    _assert_grads_close(got, want, 1e-3)


@pytest.mark.parametrize("with_dstate", [False, True])
def test_autograd_function_on_cpu_matches_autograd_through_plain(with_dstate):
    """``ssd`` under grad (its autograd.Function, the plain adjoint as the
    backward) gives autograd's own gradients through ``ssd_plain``."""
    args = _inputs(2, 40, 4, 8, 2, 16, seed=5)
    dy, ds = (torch.from_numpy(a) for a in _cotangents(2, 40, 4, 8, 2, 16, seed=6))
    grads = []
    for fn in (ssd, ssd_plain):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        y, s = fn(*leaves)
        loss = (y * dy).sum() + ((s * ds).sum() if with_dstate else 0.0)
        grads.append(torch.autograd.grad(loss, leaves))
    _assert_grads_close(grads[0], grads[1], 1e-5)


def test_autograd_function_takes_a_final_state_gradient_alone():
    """A loss of the final state alone: y's gradient arrives as None (grads
    are not materialised) and the backward runs with dy = 0."""
    leaves = [torch.from_numpy(a).requires_grad_() for a in _inputs(1, 8, 2, 4, 1, 4, seed=1)]
    _, s = ssd(*leaves)
    grads = torch.autograd.grad(s.sum(), leaves)
    want = ssd_plain_bwd(*[t.detach() for t in leaves], torch.zeros(1, 8, 2, 4),
                         torch.ones(1, 2, 4, 4))
    _assert_grads_close(grads, want, 1e-5)


def _bwd_chunked(x, dt, A, B, C, D, dy, dstate, split, Q=64):
    """Plain-torch emulation of ``csrc/ssd_scan_bwd.cu``'s arithmetic: the
    chunk entry states as the forward writes them, then chunks of Q walked
    backward with the gradient G of the exit state, cum_bar from the row dots
    c . C_bar - dt (b . Bt) and <G, S> at the exit, and its reverse cumsum.
    Every float32 operand of a product goes through ``split``, once, as the
    mma kernel splits it into its hi and lo tiles or fragments: (C B^T o L)^T,
    (Y_bar X^T o L)^T, Y_bar X^T o L o dt_j, G and S (each a tile read by two
    products), and Y_bar o ein for G's update, whose other operand C stays
    exact; the exit factors eout and ein scale the accumulators, not the
    operands. B's and C's gradients leave per head in float32 and are summed
    over a group's heads in head order, then rounded once."""
    Bt, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    xf, dyf = x.float(), dy.float()
    Bf, Cf = (t.float().repeat_interleave(rep, 2) for t in (B, C))
    nc = -(-T // Q)
    tril = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, :, :, None]

    def chunk(a, c):
        n = min(Q, T - c * Q)
        out = a.new_zeros((Bt, Q) + a.shape[2:])
        out[:, :n] = a[:, c * Q:c * Q + n]
        return out

    def scalars(dc):
        cum = torch.cumsum(dc * A, 1)                                    # (Bt, Q, H)
        return cum, torch.exp(cum), torch.exp(cum[:, -1:] - cum)

    S = [torch.zeros(Bt, H, N, P)]
    for c in range(nc):
        cum, _, eout = scalars(chunk(dt, c))
        S.append(torch.exp(cum[:, -1])[..., None, None] * S[-1] + torch.einsum(
            "bjhn,bjhp->bhnp", split(chunk(Bf, c) * (eout * chunk(dt, c))[..., None]),
            chunk(xf, c)))
    Gr = torch.zeros(Bt, H, N, P) if dstate is None else dstate.float()
    dx, ddt = torch.zeros(Bt, nc * Q, H, P), torch.zeros(Bt, nc * Q, H)
    dbp, dcp = torch.zeros(Bt, nc * Q, H, N), torch.zeros(Bt, nc * Q, H, N)
    da, dd = torch.zeros(H), torch.zeros(H)
    for c in reversed(range(nc)):
        gs = (Gr * S[c + 1]).sum((-1, -2))
        xc, yc, bc, cc, dc = (chunk(a, c) for a in (xf, dyf, Bf, Cf, dt))
        cum, ein, eout = scalars(dc)
        L = torch.where(tril, torch.exp(cum[:, :, None] - cum[:, None]), 0.0)
        CBL = split(torch.einsum("bihn,bjhn->bijh", cc, bc) * L)
        DL = torch.einsum("bihp,bjhp->bijh", yc, xc) * L
        dd += torch.einsum("bihp,bihp->h", yc, xc)
        sl = slice(c * Q, (c + 1) * Q)
        dx[:, sl] = dc[..., None] * (torch.einsum("bijh,bihp->bjhp", CBL, yc) + eout[..., None]
                                     * torch.einsum("bjhn,bhnp->bjhp", bc, split(Gr))) \
            + D[:, None] * yc
        dbp[:, sl] = torch.einsum("bijh,bihn->bjhn", split(DL), cc) \
            + eout[..., None] * torch.einsum("bjhp,bhnp->bjhn", xc, split(Gr))
        dcp[:, sl] = torch.einsum("bijh,bjhn->bihn", split(DL * dc[:, None]), bc) \
            + ein[..., None] * torch.einsum("bihp,bhnp->bihn", yc, split(S[c]))
        Gr = torch.exp(cum[:, -1])[..., None, None] * Gr + torch.einsum(
            "bihn,bihp->bhnp", cc, split(yc * ein[..., None]))
        bb = (bc * dbp[:, sl]).sum(-1)
        cbar = (cc * dcp[:, sl]).sum(-1) - dc * bb
        cbar[:, -1] += gs
        dA = torch.flip(torch.cumsum(torch.flip(cbar, [1]), 1), [1])
        ddt[:, sl] = bb + A * dA
        da += (dc * dA).sum((0, 1))
    dB, dC = torch.zeros(Bt, T, G, N), torch.zeros(Bt, T, G, N)
    for r in range(rep):    # head order within each group
        dB += (dt[..., None] * dbp[:, :T]).reshape(Bt, T, G, rep, N)[:, :, :, r]
        dC += dcp[:, :T].reshape(Bt, T, G, rep, N)[:, :, :, r]
    return (dx[:, :T].to(x.dtype), ddt[:, :T], da, dB.to(B.dtype), dC.to(C.dtype), dd)


_BWD_ROUNDING_SHAPES = [(2, 200, 4, 64, 1, 32), (1, 130, 6, 32, 2, 16),
                        (1, 150, 12, 32, 4, 64)]   # G = 4: three heads a group


def _bwd_cases(shape, dtype):
    x, dt, A, B, C, D = (torch.from_numpy(a) for a in _inputs(*shape, seed=sum(shape)))
    dy, ds = (torch.from_numpy(a) for a in _cotangents(*shape, seed=3))
    x, B, C, dy = (t.to(dtype) for t in (x, B, C, dy))
    return (x, dt, A, B, C, D, dy, ds), ssd_plain_bwd(x, dt, A, B, C, D, dy, ds)


@pytest.mark.parametrize("shape", _BWD_ROUNDING_SHAPES)
def test_chunked_bwd_arithmetic_matches_the_adjoint(shape):
    """The kernel's formulas in exact float32 (the ffma path's arithmetic):
    ragged T, G > 1 and a final-state gradient, at the float32 bar."""
    args, want = _bwd_cases(shape, torch.float32)
    _assert_grads_close(_bwd_chunked(*args, split=lambda v: v), want, 1e-4)


def _pair(v):
    hi = v.bfloat16().float()
    return hi + (v - hi).bfloat16().float()


@pytest.mark.parametrize("shape", _BWD_ROUNDING_SHAPES)
def test_bwd_mma_rounding_scheme_holds_the_bf16_bar(shape):
    """The mma path's hi + lo pairs on bf16 inputs keep every gradient
    within the bf16 bar (2e-2 of its largest entry) of the adjoint."""
    args, want = _bwd_cases(shape, torch.bfloat16)
    _assert_grads_close(_bwd_chunked(*args, split=_pair), want, 2e-2)


@pytest.mark.parametrize("shape", _BWD_ROUNDING_SHAPES)
def test_bwd_one_bf16_rounding_misses_the_bar_on_da(shape):
    """Why the backward pays for the pairs too: one bf16 rounding of its
    float32 operands puts dA (a sum over every step, with cancellation)
    beyond the bf16 bar."""
    args, want = _bwd_cases(shape, torch.bfloat16)
    got = _bwd_chunked(*args, split=lambda v: v.bfloat16().float())
    err = (got[2] - want[2]).abs().max() / want[2].abs().max()
    assert err > 2e-2, err
