"""Launch counters of the kernel wrappers.

Each wrapper carries ``.launches`` and per-key dicts (``.paths``, and
``.layouts`` and ``.outputs`` on ``tile_matmul``) that :func:`launch`
raises by one after a launch. The ACAN runtime launches from several
handler threads at once and ``x += 1`` on an attribute is a read and a
write that two threads can interleave, so every update holds one lock.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()


def launch(fn, **keys) -> None:
    """Count one launch of ``fn``'s kernel: ``fn.launches`` and, for each
    ``attr=key``, ``getattr(fn, attr)[key]``."""
    with _lock:
        fn.launches += 1
        for attr, key in keys.items():
            getattr(fn, attr)[key] += 1
