"""The paper's own experimental model (§6): a 2-layer linear NN,
N=4⁴=256 → 256 → 1, trained with SGD (batch size 1) under the ACAN
runtime. Task capacity 4⁴, pouch 100, 4 handlers.

Port of ``repro/configs/paper_mlp.py``: the same three experiment configs,
plus ``device`` (``None`` means CUDA, which raises without a card; pass
``"cpu"`` for the plain path), where the MLP's tensors live and its tile
products run."""

from repro_torch.core import CloudConfig, FaultPlan, LayerSpec

N = 4 ** 4  # 256

LAYERS = [LayerSpec(N, N), LayerSpec(N, 1)]


# The paper does not state its learning rate; SGD(bs=1) on the 256-dim
# teacher regression diverges above ~5e-3 (verified against the sequential
# numpy oracle) — 2e-3 gives the paper's clean Fig.-1 decay.
PAPER_LR = 0.002


def feasibility_config(time_scale: float = 5e-7, epochs: int = 2,
                       n_samples: int = 100, device=None) -> CloudConfig:
    """Experiment 1: stable manager+handlers, fixed speeds (paper §6.1)."""
    return CloudConfig(layers=LAYERS, n_handlers=4, epochs=epochs,
                       n_samples=n_samples, task_cap=float(N),
                       pouch_size=100, lr=PAPER_LR, time_scale=time_scale,
                       fault_plan=FaultPlan(interval=1e9), seed=0,
                       device=device)


def adaptability_config(interval: float = 0.25, time_scale: float = 5e-7,
                        n_samples: int = 20, device=None) -> CloudConfig:
    """Experiment 2: speeds 1:5:10 re-drawn every interval (paper §6.2:
    5 s intervals; compressed wall-clock, ratios preserved)."""
    return CloudConfig(layers=LAYERS, n_handlers=4, epochs=1,
                       n_samples=n_samples, task_cap=float(N),
                       pouch_size=100, lr=PAPER_LR, time_scale=time_scale,
                       fault_plan=FaultPlan(interval=interval,
                                            speed_levels=(1.0, 5.0, 10.0),
                                            p_speed_change=1.0),
                       seed=0, device=device)


def robustness_config(interval: float = 0.25, time_scale: float = 5e-7,
                      n_samples: int = 20, device=None) -> CloudConfig:
    """Experiment 3: Manager AND all Handlers crash every interval with
    probability 1, plus speed changes (paper §6.3)."""
    return CloudConfig(layers=LAYERS, n_handlers=4, epochs=1,
                       n_samples=n_samples, task_cap=float(N),
                       pouch_size=100, lr=PAPER_LR, time_scale=time_scale,
                       fault_plan=FaultPlan(interval=interval,
                                            speed_levels=(1.0, 5.0, 10.0),
                                            p_speed_change=1.0,
                                            p_handler_crash=1.0,
                                            p_manager_crash=1.0),
                       seed=0, device=device)
