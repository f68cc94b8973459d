"""What ``remat="dots"`` keeps: the kernel forwards' outputs of one layer.

The reference's ``"dots"`` policy (``jax.checkpoint`` with
``checkpoint_dots``) saves what the layer's products compute and recomputes
the rest in the backward pass. In the port every product, the prefill
attention and the scan are kernel launches, so ``"dots"`` keeps the outputs
of ``tile_matmul`` (2-D and batched), ``flash_attention`` (O and the row
lse) and ``ssd_scan`` (y, the final state and the chunk entry states), and
recomputes the norms, rope, conv, casts, gates and routing from them.

How: ``models/model.py::_remat`` runs each layer under a :class:`Tape`. The
layer's forward records every kernel forward's output in call order; when
``torch.utils.checkpoint`` recomputes the layer in the backward pass, the
same calls come in the same order and :func:`kept` hands the recorded
outputs back instead of launching. A selective checkpoint policy
(``create_selective_checkpoint_contexts``) sees only dispatcher ops, and
these kernels are ``ctypes`` calls inside ``autograd.Function``s; making
each a ``torch.library`` custom op would put every launch behind the
dispatcher, with a fake implementation to keep in step with each kernel,
for the one purpose of being seen. The tape needs neither and leaves the
launch path as it is under every other policy.

The tape is thread-local: the card's backward, and so the recompute, runs
on autograd's device thread, which enters the tape itself. A kept output is
handed back only to a call of the same function on inputs of the same
shapes, and only while no one wrote to it in place; anything else raises.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

_local = threading.local()


class Tape:
    """One layer's kept kernel outputs: recorded by the first pass through
    the layer, handed back, in order, by every later one."""

    def __init__(self) -> None:
        self.kept: list = []
        self.recorded = False
        self.at = 0


@contextmanager
def playing(tape: Tape):
    """Run a pass of the layer under ``tape``: the first records, later ones
    replay from the start."""
    outer = getattr(_local, "tape", None)
    _local.tape, tape.at = tape, 0
    try:
        yield
    finally:
        _local.tape = outer
    tape.recorded = True


def _key(fn, args, kw) -> tuple:
    def sig(a):
        return (tuple(a.shape), a.dtype) if hasattr(a, "shape") else a
    return ((getattr(fn, "__name__", fn),) + tuple(sig(a) for a in args)
            + tuple((k, sig(v)) for k, v in sorted(kw.items())))


def _detached(out):
    return tuple(t.detach() for t in out) if isinstance(out, tuple) else out.detach()


def _versions(out) -> tuple:
    return tuple(t._version for t in (out if isinstance(out, tuple) else (out,)))


def kept(fn, *args, **kw):
    """``fn(*args, **kw)`` (a kernel forward or its plain version), unless a
    layer is replaying under a tape: then a fresh alias of the output its
    first pass recorded at this point."""
    tape = getattr(_local, "tape", None)
    if tape is None:
        return fn(*args, **kw)
    key = _key(fn, args, kw)
    if not tape.recorded:
        out = fn(*args, **kw)
        tape.kept.append((key, _detached(out), _versions(out)))
        return out
    if tape.at >= len(tape.kept):
        raise RuntimeError(f"remat 'dots': the recompute launches {key[0]} past the "
                           f"{len(tape.kept)} kernel outputs its forward kept")
    want, out, versions = tape.kept[tape.at]
    tape.at += 1
    if want != key:
        raise RuntimeError(f"remat 'dots': the recompute calls {key[0]} where the "
                           f"forward kept the output of {want[0]}, or with other shapes")
    if _versions(out) != versions:
        raise RuntimeError(f"remat 'dots': a kept output of {key[0]} was written in place")
    return _detached(out)
