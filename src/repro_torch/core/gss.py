"""The adaptive timeout of Guided Self-Scheduling (port of the part of
``repro/core/gss.py`` that the step watchdog needs; the pouch controller and
``gss_chunk`` come with the ACAN runtime slice, ROADMAP.md).

:class:`TimeoutController` observes each round (all done?, elapsed,
completion fraction) and moves the timeout toward ``elapsed × slack`` on
success, or grows it multiplicatively on failure: the paper's §5.3
adaptive timeout, inversely proportional to aggregate handler power.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TimeoutController:
    timeout: float = 0.5
    min_timeout: float = 1e-3
    max_timeout: float = 30.0
    slack: float = 1.3          # target = completion_time × slack
    grow: float = 1.6           # on an incomplete round
    ema: float = 0.5            # blend toward target on success
    #: Cap on retained history entries (0 = unbounded).
    history_limit: int = 10_000
    history: list[float] = field(default_factory=list)

    def update(self, all_done: bool, elapsed: float, fraction_done: float) -> float:
        if all_done:
            target = max(elapsed * self.slack, self.min_timeout)
            self.timeout = (1 - self.ema) * self.timeout + self.ema * target
        else:
            # Partial completion: scale in proportion to how far we got —
            # a nearly-done round grows only slightly.
            shortfall = max(1.0 - fraction_done, 0.1)
            self.timeout *= 1.0 + (self.grow - 1.0) * shortfall
        self.timeout = min(max(self.timeout, self.min_timeout), self.max_timeout)
        self.history.append(self.timeout)
        if self.history_limit and len(self.history) > self.history_limit:
            del self.history[:-self.history_limit]
        return self.timeout
