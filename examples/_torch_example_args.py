"""Shared CLI helpers for the port's example scripts
(``examples/torch_*.py``): the same helpers as ``_example_args.py``, over
``repro_torch``."""

import sys

from repro_torch.core.space import find_checked


def flag(name: str, usage: str, argv: list[str] | None = None) -> str | None:
    """Value of ``--name`` if present."""
    argv = sys.argv if argv is None else argv
    if name not in argv:
        return None
    idx = argv.index(name) + 1
    if idx >= len(argv):
        sys.exit(f"{name} requires a value ({usage})")
    return argv[idx]


def ts_backend_arg() -> str | None:
    """Value of ``--ts-backend`` if present (None -> $REPRO_TS_BACKEND)."""
    return flag("--ts-backend", "local | sharded[:n] | instrumented[:spec] | "
                "checked+spec")


def device_arg() -> str:
    """Value of ``--device`` (``cuda`` unless given; ``cpu`` runs the plain
    path)."""
    return flag("--device", "cpu | cuda") or "cuda"


def protocol_audit(backend, res) -> None:
    """Print the CheckedBackend shutdown report when the protocol
    sanitizer is stacked (``--ts-backend checked+local`` etc.): every run
    must end with zero schema/role violations and zero tuple leaks."""
    if find_checked(backend) is None:
        return
    n_leaks = sum(e["count"] for e in res.ts_leaks.values())
    print(f"protocol audit : violations {res.ts_violations}, "
          f"leaked tuples {n_leaks} (both must be 0 — every key "
          f"schema-clean, every non-persistent tuple swept)")
    for sample in getattr(res, "ts_violation_samples", [])[:3]:
        print(f"  {sample}")
    for label, entry in list(res.ts_leaks.items())[:3]:
        print(f"  leak {label}: {entry['count']}x {entry['lifecycle']} "
              f"e.g. {entry['sample'][0]}")
