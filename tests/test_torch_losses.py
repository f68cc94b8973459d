"""The port's chunked cross-entropy (``repro_torch.models.losses``) against
the JAX reference, on the CPU: value and gradients (``jax.value_and_grad``
against ``torch.autograd``) with a ragged tail, a mask and ``z_loss``, and
``multi_head_xent``. Inputs from numpy seeds; float32 at 1e-5 relative (the
same formulas, sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.losses import chunked_softmax_xent as jax_xent
from repro.models.losses import multi_head_xent as jax_multi
from repro_torch.models.losses import chunked_softmax_xent, multi_head_xent


def _inputs(seed, t, d, v, labels_shape=None):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    lab = rng.integers(0, v, labels_shape or (t,)).astype(np.int32)
    mask = (rng.random(t) > 0.3).astype(np.float32)
    return h, w, lab, mask


def _grads(fn_t, fn_j, h, w):
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = fn_t(ht, wt)
    gh, gw = torch.autograd.grad(out, (ht, wt))
    ref, (jh, jw) = jax.value_and_grad(fn_j, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    return (out.item(), gh.numpy(), gw.numpy()), (float(ref), np.asarray(jh), np.asarray(jw))


@pytest.mark.parametrize("t,chunk,masked,z_loss", [
    (32, 8, False, 0.0),     # chunks divide T
    (37, 16, False, 0.0),    # ragged tail: 11 masked padding rows
    (37, 16, True, 0.0),     # a caller's mask on top
    (40, 64, True, 1e-3),    # one chunk (T < chunk), z_loss
    (29, 8, False, 1e-2),    # ragged and z_loss
])
def test_chunked_xent_value_and_gradients_match_reference(t, chunk, masked, z_loss):
    h, w, lab, mask = _inputs(t * 10 + chunk, t, 24, 50)
    m_t = torch.from_numpy(mask) if masked else None
    m_j = jnp.asarray(mask) if masked else None
    got, want = _grads(
        lambda a, b: chunked_softmax_xent(a, b, torch.from_numpy(lab), chunk=chunk,
                                          z_loss=z_loss, mask=m_t)[0],
        lambda a, b: jax_xent(a, b, jnp.asarray(lab), chunk=chunk, z_loss=z_loss,
                              mask=m_j)[0],
        h, w)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)


def test_token_count_and_no_grad_path():
    """``tokens`` counts the unmasked positions; without autograd the chunks
    are not checkpointed and give the same value."""
    h, w, lab, mask = _inputs(5, 37, 16, 30)
    args = (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(lab))
    with torch.no_grad():
        plain, aux = chunked_softmax_xent(*args, chunk=16, mask=torch.from_numpy(mask))
    _, jaux = jax_xent(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab), chunk=16,
                       mask=jnp.asarray(mask))
    assert aux["tokens"].item() == float(jaux["tokens"]) == mask.sum()
    hg = args[0].clone().requires_grad_()
    ckpt, _ = chunked_softmax_xent(hg, args[1], args[2], chunk=16,
                                   mask=torch.from_numpy(mask))
    assert ckpt.item() == plain.item()


@pytest.mark.parametrize("n_books,t,chunk", [(4, 24, 8), (2, 21, 16)])
def test_multi_head_xent_matches_reference(n_books, t, chunk):
    h, w, lab, _ = _inputs(n_books * 100 + t, t, 16, 20 * n_books, (t, n_books))
    lab = lab % 20
    got, want = _grads(
        lambda a, b: multi_head_xent(a, b, torch.from_numpy(lab), n_books, chunk=chunk)[0],
        lambda a, b: jax_multi(a, b, jnp.asarray(lab), n_books, chunk=chunk)[0],
        h, w)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
