"""The paper, end to end, on the PyTorch port: train the §6 two-layer MLP
through the port's ACAN tuple-space runtime with heterogeneous,
crash-prone handlers, its tile products through the hand-written
``tile_matmul`` kernel — and watch the adaptive timeout track handler
power inversely (Figures 1-4). Twin of ``examples/acan_mlp_train.py``;
imports only ``repro_torch``.

    PYTHONPATH=src python examples/torch_acan_mlp_train.py \
        [--device cpu|cuda] [--paper-scale] \
        [--ts-backend local|sharded[:n]|instrumented[:spec]|checked+spec]

``--device`` defaults to ``cuda`` (raises without a card; ``cpu`` runs the
plain path). Default runs a compressed variant (N=64, shorter intervals);
``--paper-scale`` runs the paper's width (N=256, pouch 100, task cap 4⁴)
under experiment 3's faults on 20 samples. The tuple-space backend comes
from ``--ts-backend`` (or ``$REPRO_TS_BACKEND``).
"""

import sys

import numpy as np

from _torch_example_args import device_arg, protocol_audit, ts_backend_arg
from repro_torch.configs import paper_mlp
from repro_torch.core import ACANCloud, CloudConfig, FaultPlan, LayerSpec


def main() -> None:
    ts_backend = ts_backend_arg()
    device = device_arg()
    if "--paper-scale" in sys.argv:
        cfg = paper_mlp.robustness_config(interval=0.5, n_samples=20,
                                          device=device)
        cfg.ts_backend = ts_backend
    else:
        cfg = CloudConfig(
            layers=[LayerSpec(64, 64), LayerSpec(64, 1)],
            n_handlers=4, epochs=2, n_samples=16, task_cap=256.0,
            pouch_size=100, lr=0.02, time_scale=1e-6, initial_timeout=0.12,
            fault_plan=FaultPlan(interval=0.3, speed_levels=(1.0, 5.0, 10.0),
                                 p_speed_change=1.0, p_handler_crash=1.0,
                                 p_manager_crash=1.0, seed=1),
            wall_limit=240.0, seed=0, ts_backend=ts_backend, device=device)

    cloud = ACANCloud(cfg)
    print(f"model: {[(s.n_in, s.n_out) for s in cfg.layers]}, "
          f"{cfg.n_handlers} handlers, task cap {cfg.task_cap:.0f}, "
          f"pouch {cfg.pouch_size}, device {cloud.program.device}, "
          f"ts backend {type(cloud.ts.backend).__name__}")
    print("faults: speeds 1:5:10 re-drawn + Manager AND Handlers crash "
          f"every {cfg.fault_plan.interval}s (p=1.0)\n")

    res = cloud.run()

    losses = [l for _, l in res.loss_history]
    n = len(losses) // 2
    print(f"steps completed : {len(losses)}")
    print(f"MSE epoch means : {np.mean(losses[:n]):.4f} -> "
          f"{np.mean(losses[n:]):.4f}")
    print(f"manager revivals: {res.manager_revivals}   "
          f"handler revivals: {res.handler_revivals}   "
          f"speed changes: {res.speed_changes}")
    t = np.array([x[1] for x in res.timeout_history])
    p = np.array([x[2] for x in res.timeout_history])
    m = p > 0
    if m.sum() > 3:
        print(f"corr(timeout, power) = "
              f"{np.corrcoef(t[m], p[m])[0, 1]:.3f}  (paper: inverse)")
    print(f"ledger intact   : {res.ledger_ok}   "
          f"pouches: {res.pouches}   wall: {res.wallclock:.1f}s")
    protocol_audit(cloud.ts.backend, res)


if __name__ == "__main__":
    main()
