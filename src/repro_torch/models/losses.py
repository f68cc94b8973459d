"""Chunked cross-entropy (port of ``repro/models/losses.py``).

The full logit tensor is never materialised: tokens go through the head in
chunks, and each chunk is recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint(body)``), so
only one chunk's float32 logits and their gradient live at a time. The
logits product ``h @ head_w`` is ``torch.matmul``, as the reference leaves it
to XLA outside any Pallas kernel. One device shards no vocabulary.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_loss(h, head_w, lab, msk, z_loss: float):
    """(sum of masked NLL [+ z_loss · sum of masked lse²], mask sum)."""
    logits = torch.matmul(h, head_w).float()                # (chunk, V)
    m = logits.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[:, 0]
    gold = logits.gather(1, lab[:, None])[:, 0]
    nll = (lse - gold) * msk
    total = nll.sum()
    if z_loss > 0:
        total = total + z_loss * (lse.square() * msk).sum()
    return total, msk.sum()


def chunked_softmax_xent(hidden, head_w, labels, *, chunk: int = 2048,
                         z_loss: float = 0.0, mask=None):
    """hidden: (T, d); head_w: (d, V); labels: (T,) integer.

    Returns (mean_nll, aux dict). ``mask`` (T,) float — 0 masks a position.
    A ragged tail is padded to the chunk with masked rows.
    """
    T = hidden.shape[0]
    chunk = min(chunk, T)
    if mask is None:
        mask = torch.ones((T,), dtype=torch.float32, device=hidden.device)
    mask = mask.float()
    labels = labels.long()
    pad = (-T) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    grad = torch.is_grad_enabled() and (hidden.requires_grad or head_w.requires_grad)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, T + pad, chunk):
        args = (hidden[c0:c0 + chunk], head_w, labels[c0:c0 + chunk],
                mask[c0:c0 + chunk], z_loss)
        s, n = (checkpoint(_chunk_loss, *args, use_reentrant=False,
                           preserve_rng_state=False)
                if grad else _chunk_loss(*args))
        total = total + s
        count = count + n
    denom = count.clamp_min(1.0)
    return total / denom, {"tokens": denom}


def multi_head_xent(hidden, head_w, labels, n_books: int, *, chunk: int = 2048):
    """MusicGen-style per-codebook heads: head_w: (d, n_books·V);
    labels: (T, n_books). Mean NLL across books."""
    V = head_w.shape[1] // n_books
    losses = [chunked_softmax_xent(hidden, head_w[:, b * V:(b + 1) * V],
                                   labels[:, b], chunk=chunk)[0]
              for b in range(n_books)]
    return torch.stack(losses).mean(), {"books": n_books}
