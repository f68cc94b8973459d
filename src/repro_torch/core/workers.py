"""Out-of-process handler fleet (port of ``repro/core/workers.py``).

One *worker* is a normal :class:`~repro_torch.core.handler.Handler` — same
event loop, same capability/store/fence/autotune behaviour — running in
its own interpreter over a :class:`~repro_torch.core.space.RemoteBackend`
connection to the cloud's tuple-space server. Nothing about the
ACAN protocol changes; only the thread boundary became a process
boundary, which is what takes the emulated compute off the cloud
process's GIL.

Three pieces:

- :func:`main` — the ``python -m repro_torch.core.workers`` entrypoint: one
  Handler over one RemoteBackend, built entirely from flags (the op
  registry is always the built-in one — custom-registry programs cannot
  cross a process boundary and keep a thread fleet). SIGTERM = clean
  stop; SIGKILL = the crash the fault plane injects.
- :class:`HandlerProcess` — the ``subprocess.Popen`` wrapper that
  duck-types the slice of ``threading.Thread`` the
  :class:`~repro_torch.core.faults.MonitorDaemon` supervises (``is_alive``/
  ``join``/``name``), so process revival IS thread revival to the
  daemon: a dead worker is noticed by the same poll and respawned by the
  same ``make_handler_thread(i)`` factory.
- :class:`ProcessCrashEvent` — the crash-axis shim: the daemon fires
  handler crashes by calling ``event.set()``; for a process fleet that
  delivers SIGKILL to the current worker — a *real* kill, taken tasks
  genuinely lost mid-flight, exactly the failure the
  timeout/retransmission discipline must absorb.

Speed re-draws are applied at (re)spawn time from the cloud's
``SpeedBox`` — a live worker keeps its spawn-time speed until the fault
plane kills it (documented divergence from the thread fleet, where
re-draws apply immediately).

**Devices.** A worker runs its ops on ``--device`` (resolved with
:func:`~repro_torch.device.resolve_device`): its client rebuilds every
tensor it reads there, so the ops' ``tile_matmul`` launches happen in the
worker. A worker asked for ``cuda`` on a host without a card exits
non-zero and says why; it never carries on on the CPU. On the card it
makes its CUDA context and loads the ``tile_matmul`` library before its
first ``take_batch``, so its first task pays neither.

**Launch counts.** The kernels' launch counters count in the process that
launches, so a process fleet's launches are the workers' own. With
``--counts-file`` a worker writes its counters there as JSON every
:data:`COUNTS_EVERY` seconds while they change, and once more when it
stops cleanly (SIGTERM); the cloud hands each worker a file in a private
directory and reports their sum. A SIGKILLed worker leaves what it wrote
last: only the launches of its last interval are lost with it.

Differs from the reference in ``device``, ``counts_file`` /
``--counts-file`` and the module paths (``python -m
repro_torch.core.workers``, the port's source root on ``PYTHONPATH``).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import torch

from repro_torch.core.handler import Handler, HandlerCrash, HandlerTenant, SpeedBox
from repro_torch.core.space import TupleSpace, as_scoped
from repro_torch.core.space.remote import RemoteBackend
from repro_torch.device import resolve_device

__all__ = ["HandlerProcess", "ProcessCrashEvent", "launch_counts", "main",
           "spawn_worker"]

#: How often (seconds) a worker with ``--counts-file`` writes its counters
#: while it runs.
COUNTS_EVERY = 0.25


class HandlerProcess:
    """Popen wrapper exposing the Thread surface MonitorDaemon drives."""

    def __init__(self, proc: subprocess.Popen, name: str) -> None:
        self.proc = proc
        self.name = name

    def is_alive(self) -> bool:
        return self.proc.poll() is None

    def join(self, timeout: float | None = None) -> None:
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            pass

    def terminate(self) -> None:
        """Clean stop (SIGTERM): the worker stops its handler and exits."""
        if self.proc.poll() is None:
            self.proc.terminate()

    def kill_hard(self) -> None:
        """SIGKILL — the injected crash. No cleanup runs in the worker:
        whatever tasks it had taken die with it."""
        if self.proc.poll() is None:
            self.proc.kill()


class ProcessCrashEvent:
    """Duck-types the ``threading.Event`` crash channel for one fleet
    slot. The daemon's fault firing calls ``set()``; here that means
    SIGKILL-ing whichever worker currently holds the slot (``proc`` is
    re-pointed by the cloud on every respawn). ``is_set``/``clear`` keep
    the Event surface for anything that polls."""

    def __init__(self) -> None:
        self.proc: HandlerProcess | None = None
        self.kills = 0

    def set(self) -> None:
        p = self.proc
        if p is not None and p.is_alive():
            self.kills += 1
            p.kill_hard()

    def clear(self) -> None:
        pass

    def is_set(self) -> bool:
        return False


def spawn_worker(addr: tuple | str, name: str, *, speed: float = 1.0,
                 capacity: float = 256.0, lr: float = 0.01,
                 time_scale: float = 2e-6, batch_size: int = 16,
                 scheduling: str = "event", compute_mode: str = "sleep",
                 autotune: bool = False, defer_ratio: float = 3.0,
                 namespaces: list[str] | None = None,
                 tenant_caps: dict | None = None, device=None,
                 counts_file: str | os.PathLike | None = None) -> HandlerProcess:
    """Spawn one worker process connected to the server at ``addr``,
    running its ops on ``device`` (``None`` means CUDA: the worker exits
    non-zero without a card)."""
    if not isinstance(addr, str):
        addr = f"{addr[0]}:{addr[1]}"
    import repro_torch
    src_root = os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))
    env = dict(os.environ)
    env["PYTHONPATH"] = src_root + os.pathsep + env.get("PYTHONPATH", "")
    argv = [sys.executable, "-m", "repro_torch.core.workers",
            "--addr", addr, "--name", name, "--speed", str(speed),
            "--capacity", str(capacity), "--lr", str(lr),
            "--time-scale", str(time_scale),
            "--batch-size", str(batch_size),
            "--scheduling", scheduling, "--compute-mode", compute_mode,
            "--defer-ratio", str(defer_ratio)]
    if autotune:
        argv.append("--autotune")
    if namespaces:
        argv += ["--namespaces", ",".join(namespaces)]
    if tenant_caps:
        argv += ["--tenant-caps",
                 ",".join(f"{ns}={cap}" for ns, cap in tenant_caps.items())]
    if device is not None:
        argv += ["--device", str(device)]
    if counts_file is not None:
        argv += ["--counts-file", str(counts_file)]
    proc = subprocess.Popen(argv, env=env)
    return HandlerProcess(proc, name)


def _parse_caps(spec: str) -> dict[str, int]:
    out: dict[str, int] = {}
    for part in spec.split(","):
        if part:
            ns, _, cap = part.partition("=")
            out[ns] = int(cap)
    return out


def _kernel_wrappers() -> dict:
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as ssd
    from repro_torch.kernels.tile_matmul import kernel as tm
    return {"tile_matmul": tm.tile_matmul, "flash_attention": fa.flash_attention,
            "flash_attention_bwd": fa.flash_attention_bwd, "ssd_scan": ssd.ssd_scan,
            "ssd_scan_bwd": ssd.ssd_scan_bwd}


def launch_counts() -> dict:
    """This process's launch counters: per kernel ``launches`` and its
    per-key dicts (``paths``, ``layouts``), read under the counters' lock."""
    from repro_torch.kernels import _count
    wrappers = _kernel_wrappers()
    with _count._lock:
        return {name: {attr: (dict(v) if isinstance(v, dict) else v)
                       for attr in ("launches", "paths", "layouts")
                       if (v := getattr(fn, attr, None)) is not None}
                for name, fn in wrappers.items()}


def _write_counts(path: str, counts: dict) -> None:
    """Replace ``path`` with ``counts`` in one step: a reader, or a SIGKILL
    between the two calls, never sees half a file."""
    tmp = f"{path}.tmp"
    Path(tmp).write_text(json.dumps(counts))
    os.replace(tmp, path)


def _flush_counts(path: str, stop: threading.Event, every: float) -> None:
    """Write this process's counters to ``path`` every ``every`` seconds
    in which they changed, until ``stop`` is set."""
    last = None
    while not stop.wait(every):
        counts = launch_counts()
        if counts != last:
            _write_counts(path, counts)
            last = counts


def _ready_device(name: str):
    """The worker's device, ready to run ops: on the card, its CUDA
    context made and the tile_matmul library loaded."""
    dev = resolve_device(name)
    if dev.type == "cuda":
        from repro_torch.kernels.tile_matmul import kernel as tm
        if (dev.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"no CUDA device {dev}: this host has "
                               f"{torch.cuda.device_count()}")
        torch.zeros(1, device=dev)
        tm._lib()
    return dev


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="ACAN out-of-process handler worker")
    ap.add_argument("--addr", required=True, help="TS server host:port")
    ap.add_argument("--name", default="hproc")
    ap.add_argument("--device", default=None,
                    help="where the worker runs its ops (cpu | cuda; "
                         "default cuda, which needs a card)")
    ap.add_argument("--counts-file", default=None,
                    help="write the kernels' launch counts here as they change "
                         "and on a clean stop")
    ap.add_argument("--speed", type=float, default=1.0)
    ap.add_argument("--capacity", type=float, default=256.0)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--time-scale", type=float, default=2e-6)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--scheduling", default="event")
    ap.add_argument("--compute-mode", default="sleep")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--defer-ratio", type=float, default=3.0)
    ap.add_argument("--namespaces", default="",
                    help="comma-separated tenant namespaces (empty = "
                         "single-tenant fast path)")
    ap.add_argument("--tenant-caps", default="",
                    help="ns=cap,... per-tenant keep caps")
    args = ap.parse_args(argv)

    try:
        device = _ready_device(args.device)
    except RuntimeError as e:
        print(f"worker {args.name}: {e}", file=sys.stderr)
        return 2

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_a: stop.set())

    backend = RemoteBackend(addr=args.addr, device=device)
    ts = TupleSpace(backend=backend)

    tenants = None
    if args.namespaces:
        caps = _parse_caps(args.tenant_caps)
        # registry=None -> the built-in op registry (MLP + MoE): worker
        # processes can only run globally registered ops.
        tenants = {ns: HandlerTenant(as_scoped(ts, ns), None,
                                     max_tasks=caps.get(ns))
                   for ns in args.namespaces.split(",")}

    h = Handler(ts=ts, name=args.name, speed=SpeedBox(args.speed),
                capacity=args.capacity, lr=args.lr,
                time_scale=args.time_scale, batch_size=args.batch_size,
                scheduling=args.scheduling, registry=None,
                tenants=tenants, autotune=args.autotune,
                defer_ratio=args.defer_ratio,
                compute_mode=args.compute_mode, stop_event=stop)
    flushed = threading.Event()
    flusher = None
    if args.counts_file:
        flusher = threading.Thread(target=_flush_counts, daemon=True,
                                   args=(args.counts_file, flushed, COUNTS_EVERY))
        flusher.start()
    # The handler runs on the main thread: CPython delivers SIGTERM to
    # the main thread between bytecodes, the handler above sets `stop`,
    # and the event loop's bounded take_batch timeout observes it.
    try:
        h.run()
    except HandlerCrash:
        pass
    backend.close()
    if flusher is not None:
        flushed.set()
        flusher.join()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        _write_counts(args.counts_file, launch_counts())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
