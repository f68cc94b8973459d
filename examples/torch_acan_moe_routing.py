"""Non-regular workload on the port's ACAN plane: MoE expert routing with
data-dependent task sizes, trained through the same fault-tolerant
Manager/Handler runtime as the paper's MLP — under an exp3-style fault
plan (Manager AND all Handlers crash every interval with p=1.0). Every
product of its ops is a hand-written ``tile_matmul`` launch. Twin of
``examples/acan_moe_routing.py``; imports only ``repro_torch``.

    PYTHONPATH=src python examples/torch_acan_moe_routing.py \
        [--device cpu|cuda] [--ts-backend spec]

``--device`` defaults to ``cuda`` (raises without a card; ``cpu`` runs the
plain path). Every round draws a token minibatch and routes it top-k
through a frozen router; each expert's forward/grad task is sized by how
many tokens landed on it, so task costs are irregular and re-draw every
round — watch the cost spread and the GSS timeout absorb it.
"""

import numpy as np

from _torch_example_args import device_arg, protocol_audit, ts_backend_arg
from repro_torch.core import (ACANCloud, CloudConfig, FaultPlan, GLOBAL_OPS,
                              MoERoutingProgram)


def main() -> None:
    device = device_arg()
    prog = MoERoutingProgram(steps=16, seed=0, device=device)
    cfg = CloudConfig(
        n_handlers=4, task_cap=256.0, pouch_size=64, time_scale=1e-6,
        initial_timeout=0.1,
        fault_plan=FaultPlan(interval=0.15, speed_levels=(1.0, 5.0, 10.0),
                             p_speed_change=1.0, p_handler_crash=1.0,
                             p_manager_crash=1.0, seed=1),
        wall_limit=240.0, ts_backend=ts_backend_arg(),
        # Per-expert stages are DAG-independent — let the frontier
        # scheduler keep them (and adjacent rounds) in flight together,
        # under the same fault plane (crashes resume mid-frontier).
        max_inflight_stages=8, device=device)
    cloud = ACANCloud(cfg, program=prog)
    print(f"MoE: {prog.E} experts, top-{prog.k}, {prog.B} tokens/round, "
          f"{prog.steps} rounds; device {prog.device}; ts backend "
          f"{type(cloud.ts.backend).__name__}; "
          f"frontier width {cfg.max_inflight_stages}")
    print("faults: speeds 1:5:10 re-drawn + Manager AND Handlers crash "
          f"every {cfg.fault_plan.interval}s (p=1.0)\n")

    res = cloud.run()

    losses = [l for _, l in res.loss_history]
    n = len(losses) // 2
    print(f"rounds completed : {len(losses)}/{prog.steps}")
    print(f"MSE half means   : {np.mean(losses[:n]):.4f} -> "
          f"{np.mean(losses[n:]):.4f}")
    print(f"manager revivals : {res.manager_revivals}   "
          f"handler revivals: {res.handler_revivals}   "
          f"speed changes: {res.speed_changes}")

    # Show the irregularity: re-derive round 0's expert tasks (the probe
    # runs the routing round on a scratch space, so the finished cloud's
    # program instance can be probed directly).
    costs = sorted(GLOBAL_OPS.cost(t) for t in prog.probe_expert_tasks())
    print(f"expert task costs (round 0): {costs}  <- data-dependent, "
          f"irregular")
    print(f"ledger intact    : {res.ledger_ok}   pouches: {res.pouches}   "
          f"wall: {res.wallclock:.1f}s")
    protocol_audit(cloud.ts.backend, res)


if __name__ == "__main__":
    main()
