"""Step-level timeout/retransmission (port of
``repro/distributed/watchdog.py``): the paper's discipline at the step
runner.

A training step is a function of (params, opt_state, batch) that returns new
trees and leaves its inputs as they were (``optim.adamw_update`` is out of
place), so re-executing it after a timeout is the paper's task re-issue:
redundant execution is harmless, and the watchdog needs no failure
detector, only the timeout. A timed-out attempt's thread may still finish;
its result is dropped and it changes no state the next attempt reads. The
step must end by waiting for the device (it reads its loss to the host), or
the controller would adapt the timeout to host enqueue time.

The adaptive timeout reuses the GSS controller of the ACAN Manager: healthy
steps shrink the timeout toward observed latency × slack; a straggling step
triggers re-execution.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core.gss import TimeoutController


class StepTimeout(Exception):
    pass


class StepFailed(Exception):
    pass


@dataclass
class StepWatchdog:
    controller: TimeoutController = field(
        default_factory=lambda: TimeoutController(timeout=60.0,
                                                  max_timeout=3600.0))
    max_retries: int = 3
    timeouts_fired: int = 0
    retries_used: int = 0

    def run(self, step_fn: Callable, *args, **kwargs):
        """Execute ``step_fn`` under the adaptive timeout; re-issue on
        timeout or failure, up to ``max_retries``."""
        last_exc: Exception | None = None
        for attempt in range(self.max_retries + 1):
            result: list = []
            exc: list = []

            def body() -> None:
                try:
                    result.append(step_fn(*args, **kwargs))
                except Exception as e:          # noqa: BLE001
                    exc.append(e)

            t0 = time.monotonic()
            th = threading.Thread(target=body, daemon=True)
            th.start()
            th.join(self.controller.timeout)
            elapsed = time.monotonic() - t0
            if result:
                self.controller.update(True, elapsed, 1.0)
                return result[0]
            if th.is_alive():
                # Timeout: the thread may still finish (a computation cannot
                # be killed, as a lost handler cannot); re-issue.
                self.timeouts_fired += 1
                self.controller.update(False, elapsed, 0.0)
                last_exc = StepTimeout(
                    f"step exceeded {self.controller.timeout:.2f}s "
                    f"(attempt {attempt})")
            else:
                last_exc = exc[0] if exc else StepFailed("no result")
            self.retries_used += 1
        raise last_exc
