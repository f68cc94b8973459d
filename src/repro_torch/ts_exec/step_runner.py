"""ACAN over the port (port of ``repro/ts_exec/step_runner.py``): runs
:class:`~repro_torch.programs.torch_sgd.TorchSGDProgram` on the generic
Manager/Handler plane — the pouch barrier, GSS deadline adaptation,
straggler re-issue, cursor checkpointing and the §5.4 exactly-once commit
all come from :mod:`repro_torch.core.manager`.

This is the bridge between ``core/`` (the paper) and the model zoo: the
handlers' microbatch gradients run on the card through the hand-written
kernels. Handlers are threads of this process: they share one GIL and
launch on the default stream, so their device work is serialised, and the
program's lock lets one of them launch a gradient at a time.

The one addition to the reference's interface is ``device`` (``None``
means ``cuda``, which raises without a card; pass ``"cpu"`` for the plain
path); a ``remote`` space's client rebuilds what it reads there too. Before the Manager starts, :meth:`ACANStepRunner.warm_up` runs one
microbatch gradient on the device, which builds and loads every kernel
the step launches: a first build takes tens of seconds, which would
otherwise time out every task of the first round and re-issue it.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from repro_torch.core.gss import TimeoutController
from repro_torch.core.handler import Handler, SpeedBox
from repro_torch.core.manager import Manager, ManagerConfig
from repro_torch.core.space import ANY, CONTROL_SCHEMAS, TupleSpace, find_checked
from repro_torch.models import model as M
from repro_torch.programs.torch_sgd import TorchSGDProgram


@dataclass
class ACANTrainConfig:
    n_handlers: int = 4
    n_micro: int = 4               # microbatch tasks per step (the pouch)
    micro_batch: int = 2
    seq: int = 64
    steps: int = 8
    lr: float = 0.05
    timeout: float = 5.0
    handler_crash_prob: float = 0.0   # per task, before completing
    data_mode: str = "cyclic"         # learnable by default
    ts_backend: str | None = None     # None -> $REPRO_TS_BACKEND
    seed: int = 0


@dataclass
class ACANTrainResult:
    losses: list
    reissues: int
    crashes: int
    param_versions: int
    #: Protocol sanitizer outcome (zeros/empty without a CheckedBackend).
    ts_violations: int = 0
    ts_leaks: dict = field(default_factory=dict)


class ACANStepRunner:
    def __init__(self, cfg: M.ModelConfig, tcfg: ACANTrainConfig,
                 device=None) -> None:
        self.cfg = cfg
        self.tcfg = tcfg
        self.program = TorchSGDProgram(
            cfg, steps=tcfg.steps, n_micro=tcfg.n_micro,
            micro_batch=tcfg.micro_batch, seq=tcfg.seq, lr=tcfg.lr,
            handler_crash_prob=tcfg.handler_crash_prob,
            data_mode=tcfg.data_mode, seed=tcfg.seed, device=device)
        self.device = self.program.device
        self.ts = TupleSpace(backend=tcfg.ts_backend, device=self.device)
        self._warm = False
        # Declare the key protocol when a CheckedBackend is stacked
        # (single-tenant runner — default namespace).
        checked = find_checked(self.ts.backend)
        if checked is not None:
            checked.registry.register_many(
                CONTROL_SCHEMAS + tuple(self.program.key_schemas()))

    def warm_up(self) -> None:
        """One microbatch gradient from the space's params (put by the
        program's ``setup`` unless the caller put its own), discarded:
        every kernel of the step is built, loaded and launched once."""
        self.program.setup(self.ts)
        params = self.ts.try_read(("params", ANY))[1]
        self.program.grad(params, self.program.batch(0, 0))
        self._warm = True

    # ------------------------------------------------------------------ run
    def run(self) -> ACANTrainResult:
        tcfg = self.tcfg
        if not self._warm:
            self.warm_up()
        stop = threading.Event()
        mgr = Manager(
            ts=self.ts, program=self.program,
            cfg=ManagerConfig(task_cap=float("inf"),
                              pouch_size=max(tcfg.n_micro, 1),
                              initial_timeout=tcfg.timeout),
            stop_event=stop)
        mgr.controller = TimeoutController(timeout=tcfg.timeout,
                                           max_timeout=60.0)
        # batch_size=1: gradient tasks are heavy, so microbatches must
        # spread across handlers instead of draining into one batch.
        handlers = [Handler(ts=self.ts, name=f"h{i}", speed=SpeedBox(1.0),
                            capacity=float("inf"), time_scale=0.0,
                            batch_size=1, registry=self.program.registry,
                            stop_event=stop)
                    for i in range(tcfg.n_handlers)]
        threads = [threading.Thread(target=h.run, daemon=True)
                   for h in handlers]
        for t in threads:
            t.start()
        try:
            mgr.run()
        finally:
            stop.set()
        # Wait for every handler to leave its loop: one still computing a
        # late duplicate gradient would otherwise go on launching kernels
        # (and writing to the space) after run() returned. A handler sees
        # the stop within its take timeout plus one gradient.
        for t in threads:
            t.join()
        losses = [self.ts.try_read(k)[1]
                  for k in sorted(self.ts.keys(("losshist", ANY)))]
        checked = find_checked(self.ts.backend)
        report = checked.protocol_report() if checked is not None else None
        return ACANTrainResult(
            losses=losses, reissues=mgr.reissued,
            crashes=self.program.crashes,
            param_versions=mgr.window.committed_step.get(0, -1) + 1,
            ts_violations=0 if report is None else report["violations"],
            ts_leaks={} if report is None else dict(report["leaks"]))


def step_seconds(runner: ACANStepRunner, t0: float) -> list[float]:
    """Host seconds of each step of ``runner``'s finished run, which
    started at ``t0`` (``time.time()``): from ``t0`` or the commit of
    ``("params", k - 1)`` to the commit of ``("params", k)``, read from the
    put times in the space's ledger."""
    puts = {e.key[1]: e.wallclock for e in runner.ts.ledger.entries
            if e.op == "put" and e.key[0] == "params"}
    ends = [puts[k] for k in range(1, runner.tcfg.steps + 1)]
    return [b - a for a, b in zip([t0] + ends, ends)]
