"""Multi-tenant ACAN on the port: the paper's MLP and the non-regular MoE
routing program **co-resident on one tuple space**, each in its own
namespace, served by one shared, reconfigurable handler fleet — under an
exp3-style fault plan (every Manager AND all Handlers crash each interval
with p=1.0, handler speeds re-drawn 1:5:10). Both programs' products are
hand-written ``tile_matmul`` launches. Twin of
``examples/acan_multi_tenant.py``; imports only ``repro_torch``.

    PYTHONPATH=src python examples/torch_acan_multi_tenant.py \
        [--device cpu|cuda] [--ts-backend spec]

``--device`` defaults to ``cuda`` (raises without a card; ``cpu`` runs the
plain path). Each program gets its own Manager and a ScopedSpace view
(its keys are stored under ``mlp::...`` / ``moe_routing::...``), so task
sweeps, recovery cursors and data-plane tuples cannot collide; the
handlers drain tasks across both namespaces in a single take_batch and
route each one to its tenant's executor. Pass ``--ts-backend
instrumented:local`` (or ``instrumented:sharded``) to also print the
isolation audit: zero deletes capable of crossing a namespace — and
``checked+local`` / ``instrumented+checked+sharded`` for the protocol
audit: zero schema violations and zero leaked tuples at shutdown.
"""

import numpy as np

from _torch_example_args import device_arg, protocol_audit, ts_backend_arg
from repro_torch.core import (ACANCloud, CloudConfig, FaultPlan, LayerSpec,
                              MLPProgram, MoERoutingProgram)


def main() -> None:
    device = device_arg()
    epochs, n_samples = 2, 12
    layers = [LayerSpec(32, 32), LayerSpec(32, 1)]
    mlp = MLPProgram(layers, epochs=epochs, n_samples=n_samples, seed=0,
                     device=device)
    moe = MoERoutingProgram(steps=12, seed=0, device=device)
    cfg = CloudConfig(
        layers=layers, n_handlers=4, epochs=epochs, n_samples=n_samples,
        task_cap=256.0, pouch_size=64, lr=0.01, time_scale=2e-5,
        initial_timeout=0.1,
        fault_plan=FaultPlan(interval=0.15, speed_levels=(1.0, 5.0, 10.0),
                             p_speed_change=1.0, p_handler_crash=1.0,
                             p_manager_crash=1.0, seed=1),
        wall_limit=240.0, ts_backend=ts_backend_arg(), device=device)
    cloud = ACANCloud(cfg, programs=[mlp, moe])
    print(f"tenants: {', '.join(cloud.namespaces)}  on one "
          f"{type(cloud.ts.backend).__name__} ({cfg.n_handlers} shared "
          f"handlers, device {mlp.device})")
    print("faults: speeds 1:5:10 re-drawn + both Managers AND all "
          f"Handlers crash every {cfg.fault_plan.interval}s (p=1.0)\n")

    res = cloud.run()

    for ns, r in res.per_program.items():
        losses = [l for _, l in r.loss_history]
        n = len(losses) // 2
        print(f"[{ns}] rounds {len(losses)}  loss "
              f"{np.mean(losses[:n]):.4f} -> {np.mean(losses[n:]):.4f}  "
              f"manager revivals {r.manager_revivals}  pouches {r.pouches}")
    print(f"\nfleet: handler revivals {res.handler_revivals}   "
          f"speed changes {res.speed_changes}   wall {res.wallclock:.1f}s")
    print(f"ledger intact: {res.ledger_ok}")

    backend = cloud.ts.backend
    if hasattr(backend, "delete_metrics"):
        dm = backend.delete_metrics()
        widened = cloud.ts.stats().get("instr_widened_deletes", 0)
        plain_task = dm.get("task", {"removed": 0})["removed"]
        print(f"isolation audit: widened-subject deletes {widened}, "
              f"unscoped task removals {plain_task} "
              f"(both must be 0 — no delete can cross a namespace)")
    protocol_audit(cloud.ts.backend, res)


if __name__ == "__main__":
    main()
