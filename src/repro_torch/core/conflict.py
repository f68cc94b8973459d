"""Update-task conflict resolution (paper §5.4).

All task kinds except ``update`` are idempotent — they never overwrite what
they read, so duplicate execution after a timeout/retransmission is
harmless. ``update`` overwrites parameters, so the paper prescribes a
TCP-style **sliding-window** discipline: track committed (layer, step)
windows, accept each update tile exactly once, and only overwrite the
parameters when *all* tiles of a layer's update are present.

:class:`CommitWindow` implements that discipline for the Manager.

A verbatim copy of the reference's ``repro/core/conflict.py``: the code is the same, with ``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CommitWindow:
    """Tracks, per layer, the highest committed step; rejects stale or
    duplicate commits (exactly-once parameter overwrite)."""

    committed_step: dict[int, int] = field(default_factory=dict)
    duplicates_rejected: int = 0
    stale_rejected: int = 0

    def can_commit(self, layer: int, step: int) -> bool:
        last = self.committed_step.get(layer, -1)
        if step <= last:
            return False
        return True

    def commit(self, layer: int, step: int) -> bool:
        """Returns True if this (layer, step) is newly committed."""
        last = self.committed_step.get(layer, -1)
        if step == last:
            self.duplicates_rejected += 1
            return False
        if step < last:
            self.stale_rejected += 1
            return False
        self.committed_step[layer] = step
        return True

    # ---------------------------------------------------------- persistence
    def to_state(self) -> dict:
        return {"committed_step": dict(self.committed_step)}

    @staticmethod
    def from_state(state: dict) -> "CommitWindow":
        cw = CommitWindow()
        cw.committed_step = {int(k): int(v)
                             for k, v in state.get("committed_step", {}).items()}
        return cw


def tiles_cover(tiles: list[tuple[int, int]], lo: int, hi: int) -> bool:
    """True iff the half-open ranges in ``tiles`` exactly cover [lo, hi).

    Used by the Manager to decide when a stage's partial results are
    complete (all partition pieces present, no gaps)."""
    if not tiles:
        return False
    spans = sorted(set(tiles))
    cur = lo
    for a, b in spans:
        if a > cur:
            return False
        cur = max(cur, b)
    return cur >= hi
