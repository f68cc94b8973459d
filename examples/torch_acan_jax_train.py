"""ACAN over the port: the paper's runtime scheduling real model training
(reduced deepseek-v2-lite: MLA and a fine-grained MoE) — microbatch-gradient
tasks flow through the Tuple Space with timeout/re-issue, handlers crash
mid-task at 25% probability, and the §5.4 sliding window commits each param
version exactly once. Every product, attention and their gradients are
hand-written kernel launches (float32: the ``ffma`` paths). Twin of
``examples/acan_jax_train.py``; imports only ``repro_torch``.

    PYTHONPATH=src python examples/torch_acan_jax_train.py \
        [--device cpu|cuda] [--ts-backend spec]

``--device`` defaults to ``cuda`` (raises without a card; ``cpu`` runs the
plain path). Pass ``--ts-backend sharded`` (or set ``$REPRO_TS_BACKEND``) to
run the gradient-task traffic over the sharded tuple-space backend, or
``checked+local`` for the protocol audit.
"""

from _torch_example_args import device_arg, protocol_audit, ts_backend_arg
from repro_torch.configs.base import get_config
from repro_torch.ts_exec.step_runner import ACANStepRunner, ACANTrainConfig


def train_config(ts_backend: str | None = None, **overrides) -> ACANTrainConfig:
    """The example's run: the reference's 4 handlers, 4 microbatch tasks of
    2 x 32 tokens a step, 8 SGD steps at lr 0.05, a 30 s first deadline, a
    0.25 crash probability a task, seed 0."""
    return ACANTrainConfig(**(dict(n_handlers=4, n_micro=4, micro_batch=2, seq=32, steps=8,
                                   lr=0.05, timeout=30.0, handler_crash_prob=0.25, seed=0,
                                   ts_backend=ts_backend) | overrides))


def main() -> None:
    device = device_arg()
    cfg = get_config("deepseek_v2_lite_16b", reduced=True)
    tcfg = train_config(ts_backend_arg())
    runner = ACANStepRunner(cfg, tcfg, device=device)
    print(f"arch: {cfg.name} (reduced, MoE {cfg.period[0].moe.n_experts}e "
          f"top-{cfg.period[0].moe.top_k}); {tcfg.n_handlers} handlers, "
          f"{tcfg.n_micro} grad tasks/step, 25% crash prob/task, "
          f"ts backend {type(runner.ts.backend).__name__}; device {runner.device}\n")
    res = runner.run()
    for i, l in enumerate(res.losses):
        print(f"step {i}: loss {l:.4f}")
    print(f"\ncrashes: {res.crashes}  re-issues: {res.reissues}  "
          f"param versions committed: {res.param_versions}")
    assert res.losses[-1] < res.losses[0]
    print("loss decreased through crashes — ACAN semantics hold for real "
          "model training.")
    protocol_audit(runner.ts.backend, res)


if __name__ == "__main__":
    main()
