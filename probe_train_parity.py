#!/usr/bin/env python3
"""Where a float32 train step of a dense config parts from the CPU's.

One float32 train step of ``chip_smoke.py``'s parity configuration of
``arch`` (h2o_danube_1_8b: 2 layers, 1 x 4224 tokens; gemma3_12b: one local
and one global layer, 1 x 1152) from the same seeded weights, four ways:
on the card through the attention kernels, on the card with the attention
kernels swapped for the plain formula (``flash_attention_ref`` and
``flash_attention_bwd_ref``), on the card through the CPU's chunked
attention under autograd, and on the CPU. Prints each pair's gradient
norms and the tensors whose first moments (0.1 x the clipped gradient)
differ most, relative to each tensor's largest entry. A difference that
is the same in every tensor is the clip factor, i.e. the gradient norm.

``--cpu-norm`` instead prints, on the CPU alone, how far PyTorch's float32
norm of one long vector and ``repro_torch.optim.optimizer.global_norm``
are from the float64 norm, at 1e6 to 1e8 elements.

Usage (from the repository root; the first form on a host with a CUDA
device)::

    python3 probe_train_parity.py [h2o_danube_1_8b | gemma3_12b]
    python3 probe_train_parity.py --cpu-norm

Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parent


def cpu_norm() -> None:
    from repro_torch.optim.optimizer import global_norm

    gen = torch.Generator().manual_seed(0)
    for n in (10 ** 6, 10 ** 7, 10 ** 8):
        x = torch.randn(n, generator=gen) * 1e-4
        want = x.double().norm().item()
        whole = torch._foreach_norm([x])[0].item()
        runs = global_norm({"x": x}).item()
        print(f"{n:>10} elements: whole-vector float32 norm {(whole - want) / want:+.3e}, "
              f"global_norm {(runs - want) / want:+.3e} (relative to float64)")


def card(arch: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention import ref as R
    from repro_torch.launch import steps as steps_mod
    from repro_torch.models import attention as A
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.optim.optimizer import OptConfig, init_opt_state

    spec = C.DENSE_TRAIN[arch]
    pcfg = dataclasses.replace(C._parity_config(get_config(arch), spec["parity_periods"]),
                               param_dtype="float32")
    opt = OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=5, weight_decay=0.0)
    params = M.init_params(pcfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    tokens = TokenPipeline(PipelineConfig(vocab=pcfg.vocab, batch=spec["parity"]["batch"],
                                          seq=spec["parity"]["seq"], mode="cyclic")).batch_at(0)
    step = steps_mod.make_train_step(pcfg, opt)

    def run(dev):
        p = C._to(params, dev)
        t0 = time.perf_counter()
        _, state, m = step(p, init_opt_state(p, opt),
                           {k: torch.as_tensor(v, device=dev) for k, v in tokens.items()})
        print(f"{dev}: step {time.perf_counter() - t0:.2f} s, loss {m['loss']}, "
              f"grad norm {m['grad_norm']}", flush=True)
        return {k: v.cpu() for k, v in _flatten(state["m"]).items()}, m

    def chunked(q, k, v, cfg, *, q_offset=0, q_chunk=512, kv_chunk=512):
        B, T, Hq, _ = q.shape
        G = Hq // k.shape[2]
        out = A.chunked_attention(q, k.repeat_interleave(G, dim=2),
                                  v.repeat_interleave(G, dim=2), causal=True,
                                  window=cfg.window, softcap=cfg.softcap, q_offset=q_offset,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
        return out.reshape(B, T, Hq, -1)

    runs = {"kernels": run("cuda")}
    kernels = (K.flash_attention, K.flash_attention_bwd)
    K.flash_attention = lambda q, k, v, path=None, **kw: R.flash_attention_ref(q, k, v, **kw)
    K.flash_attention_bwd = (lambda q, k, v, o, do, lse, path=None, **kw:
                             R.flash_attention_bwd_ref(q, k, v, o, do, lse, **kw))
    runs["plain formula on the card"] = run("cuda")
    K.flash_attention, K.flash_attention_bwd = kernels
    gqa, blocks.gqa_attention = blocks.gqa_attention, chunked
    runs["chunked on the card"] = run("cuda")
    blocks.gqa_attention = gqa
    runs["cpu"] = run("cpu")
    for a, b in (("kernels", "cpu"), ("plain formula on the card", "cpu"),
                 ("chunked on the card", "cpu"), ("kernels", "plain formula on the card"),
                 ("kernels", "chunked on the card")):
        (ga, ma), (gb, mb) = runs[a], runs[b]
        errs = {k: (ga[k] - gb[k]).abs().max().item() / max(gb[k].abs().max().item(), 1e-30)
                for k in gb}
        print(f"{a} vs {b}: grad norm {ma['grad_norm']} / {mb['grad_norm']}")
        for k, e in sorted(errs.items(), key=lambda kv: -kv[1])[:6]:
            print(f"    {k}: {e:.3e}")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    if "--cpu-norm" in sys.argv:
        cpu_norm()
        return 0
    if not torch.cuda.is_available():
        print("probe_train_parity: no CUDA device (--cpu-norm runs without one)",
              file=sys.stderr)
        return 1
    card(sys.argv[1] if len(sys.argv) > 1 else "gemma3_12b")
    return 0


if __name__ == "__main__":
    sys.exit(main())
