#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version at the serving path's shapes, times
them, serves full-width smollm_360m (batch 8 x 512-token prompts, 32 greedy
tokens) through the port's ``serve`` entry point, and checks full-depth
float32 logits of the kernel path against the plain path on the CPU.

Usage (from the repository root, on a host with a CUDA device)::

    python3 chip_smoke.py

Prints the device and its power limit, a ``{"kernels": [...]}`` line, and
as the last line ``{"ok": true, "device": {...}}``. Any failed phase raises
and exits non-zero. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out" / "chip_smoke.json"

# Published dense peaks of one H100 SXM (NVIDIA data sheet): bf16 tensor
# cores, float32 outside them, and HBM3.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-4}
ACTS = ("none", "tanh", "relu", "silu", "gelu")
# (K, N) of the block projections of smollm_360m: q/o, k/v, gate/up, down.
PROJ = ((960, 960), (960, 320), (960, 2560), (2560, 960))
# One layer's seven projections: (K, N, activation).
LAYER = ((960, 960, "none"), (960, 320, "none"), (960, 320, "none"),
         (960, 960, "none"), (960, 2560, "silu"), (960, 2560, "none"),
         (2560, 960, "none"))
BATCH, PROMPT, GEN, CACHE = 8, 512, 32, 1024


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _time_ms(fn, iters=20) -> float:
    """Device time of one call: CUDA events around ``iters`` calls after
    three warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return type(tree)(_to(v, device) for v in tree)


def check_tile_matmul(tm_kernel, tile_matmul_ref) -> dict:
    """Kernel vs plain version at every projection shape, activation and
    dtype of the serving path, with and without bias."""
    err = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for m in (BATCH * PROMPT, BATCH):
            for k, n in PROJ:
                x = _randn((m, k), dtype, m + k)
                w = _randn((k, n), dtype, n, k ** -0.5)
                b = _randn((n,), dtype, 7)
                for act in ACTS:
                    for bias in (None, b):
                        out = tm_kernel.tile_matmul(x, w, bias, activation=act)
                        ref = tile_matmul_ref(x, w, bias, activation=act)
                        torch.testing.assert_close(out.float(), ref.float(),
                                                   rtol=TOL[dtype], atol=TOL[dtype])
                        worst = max(worst, (out.float() - ref.float()).abs().max().item())
        err[str(dtype)] = worst
    torch.cuda.synchronize()
    return err


FLASH_CASES = (  # (name, BH, G, Tq, Tkv, window, softcap)
    ("causal", 40, 3, 512, 512, 0, 0.0),
    ("window", 40, 3, 512, 512, 128, 0.0),
    ("softcap", 40, 3, 512, 512, 0, 30.0),
    ("q_offset", 40, 3, 256, 512, 0, 0.0),
)


def check_flash(fa_kernel, flash_attention_ref) -> dict:
    err = {}
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for name, bh, g, tq, tkv, window, softcap in FLASH_CASES:
            q = _randn((bh, g, tq, 64), dtype, 1)
            k = _randn((bh, tkv, 64), dtype, 2)
            v = _randn((bh, tkv, 64), dtype, 3)
            kw = dict(causal=True, window=window, softcap=softcap, q_offset=tkv - tq)
            out = fa_kernel.flash_attention(q, k, v, **kw)
            ref = flash_attention_ref(q, k, v, **kw)
            torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                                       atol=TOL[dtype], msg=lambda m, c=name: f"{c}: {m}")
            worst = max(worst, (out.float() - ref.float()).abs().max().item())
        err[str(dtype)] = worst
    torch.cuda.synchronize()
    return err


def _time_layer(m: int, copies: int, tm_kernel, tile_matmul_ref) -> dict:
    """One layer's seven bf16 projections at M = ``m``, cycling through
    ``copies`` sets of weights."""
    dt = torch.bfloat16
    xs = {k: _randn((m, k), dt, k) for k in (960, 2560)}
    ws = [[_randn((k, n), dt, 10 * c + i, k ** -0.5) for i, (k, n, _) in enumerate(LAYER)]
          for c in range(copies)]

    def run(fn):
        for wl in ws:
            for (k, _, act), w in zip(LAYER, wl):
                fn(xs[k], w, act)

    def lib(x, w, act):
        y = torch.matmul(x, w)
        return F.silu(y) if act == "silu" else y

    kern = _time_ms(lambda: run(lambda x, w, a: tm_kernel.tile_matmul(x, w, activation=a)))
    plain = _time_ms(lambda: run(lambda x, w, a: tile_matmul_ref(x, w, activation=a)))
    library = _time_ms(lambda: run(lib))
    flops = sum(2 * m * k * n for k, n, _ in LAYER)
    nbytes = sum((m * k + k * n + m * n) * 2 for k, n, _ in LAYER)
    bound_ms, bound_by = _bound(flops, nbytes, dt)
    return dict(M=m, ms=kern / copies, plain_ms=plain / copies, library_ms=library / copies,
                flop=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)


def time_tile_matmul(tm_kernel, tile_matmul_ref) -> dict:
    """Prefill (M = 4096) and decode (M = 8). Decode cycles through enough
    weight copies to overflow the 50 MB L2, as a decode step finds each
    layer's weights cold."""
    return {"prefill": _time_layer(BATCH * PROMPT, 1, tm_kernel, tile_matmul_ref),
            "decode": _time_layer(BATCH, 4, tm_kernel, tile_matmul_ref)}


def time_flash(fa_kernel, flash_attention_ref) -> dict:
    """Prefill attention of one layer, bf16: q (40, 3, 512, 64), causal."""
    dt, bh, g, t, d = torch.bfloat16, BATCH * 5, 3, PROMPT, 64
    q = _randn((bh, g, t, d), dt, 1)
    k = _randn((bh, t, d), dt, 2)
    v = _randn((bh, t, d), dt, 3)
    kern = _time_ms(lambda: fa_kernel.flash_attention(q, k, v, causal=True))
    plain = _time_ms(lambda: flash_attention_ref(q, k, v, causal=True))
    qs = q.reshape(BATCH, 15, t, d)
    ks = k.reshape(BATCH, 5, t, d).repeat_interleave(g, dim=1)
    vs = v.reshape(BATCH, 5, t, d).repeat_interleave(g, dim=1)
    library = _time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
    pairs = bh * g * t * (t + 1) // 2          # unmasked (query, key) pairs
    flops = 4 * d * pairs
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * 2
    bound_ms, bound_by = _bound(flops, nbytes, dt)
    return dict(ms=kern, plain_ms=plain, library_ms=library, flop=flops, bytes=nbytes,
                bound_ms=bound_ms, bound_by=bound_by)


def profile_steps(M, cfg, params) -> dict:
    """One prefill (8 x 512) and one decode step of the served model: host
    wall time without tracing (median of 3), device kernel time from a
    torch.profiler trace of one more run, their ratio as the device's busy
    share, and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, PROMPT)),
                             device="cuda")
    small, logits = M.prefill(params, cfg, {"tokens": tokens})
    cache = M.init_cache(cfg, BATCH, CACHE, "cuda")
    for big, sm in zip(cache["period"][0], small["period"][0]):
        for name in ("k", "v"):
            big[name][:, :PROMPT] = sm[name]
    step = {"token": torch.argmax(logits, dim=-1), "cur_len": PROMPT}
    fns = {"prefill": lambda: M.prefill(params, cfg, {"tokens": tokens}),
           "decode": lambda: M.decode_step(params, cfg, cache, step)}
    out = {}
    for name, fn in fns.items():
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = []
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                kern.append((e.key, (us if us is not None else e.self_cuda_time_total) / 1e3,
                             e.count))
        kern.sort(key=lambda r: -r[1])
        wall_ms = sorted(walls)[1] * 1e3
        device_ms = sum(r[1] for r in kern)
        out[name] = dict(wall_ms=wall_ms, device_ms=device_ms,
                         busy_share=device_ms / wall_ms,
                         top_kernels=[dict(name=k[:90], ms=t, calls=c) for k, t, c in kern[:10]])
    return out


def parity_f32(M, get_config) -> float:
    """Full-width, full-depth float32 logits: kernel path on the card vs the
    plain path on the CPU, prefill of 2 x 128 tokens then 4 decode steps."""
    cfg = get_config("smollm_360m")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda",
                           dtype_override=torch.float32)
    plain = _to(params, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 128))
    worst = 0.0
    runs = {}
    for dev, p in (("cuda", params), ("cpu", plain)):
        caches, logits = M.prefill(p, cfg, {"tokens": torch.as_tensor(tokens, device=dev)})
        cache = M.init_cache(cfg, 2, 136, dev, dtype=torch.float32)
        for big, small in zip(cache["period"][0], caches["period"][0]):
            for name in ("k", "v"):
                big[name][:, :128] = small[name]
        runs[dev] = (p, cache, [logits.cpu()])
    for step in range(4):
        tok = torch.argmax(runs["cpu"][2][-1], dim=-1)
        for dev, (p, cache, outs) in runs.items():
            logits, _ = M.decode_step(p, cfg, cache, {"token": tok.to(dev), "cur_len": 128 + step})
            outs.append(logits.cpu())
    for got, want in zip(runs["cuda"][2], runs["cpu"][2]):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
        worst = max(worst, (got - want).abs().max().item())
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.tile_matmul import kernel as tm_kernel
    from repro_torch.kernels.tile_matmul.ref import tile_matmul_ref
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M

    # 1. Device.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    detail: dict = {"device": name, "nvidia_smi": smi}

    # 2. Build every kernel, one nvcc each, all at once.
    t0 = time.perf_counter()
    _build.build_all()
    detail["build_s"] = time.perf_counter() - t0
    print(f"build: {detail['build_s']:.1f} s")
    detail["ptxas"] = {k: _build.build_log(k) for k in _build.KERNELS}

    # 3. Each kernel against its plain version at the path's shapes.
    detail["tile_matmul_err"] = check_tile_matmul(tm_kernel, tile_matmul_ref)
    detail["flash_attention_err"] = check_flash(fa_kernel, flash_attention_ref)
    print(f"checks: tile_matmul max |err| {detail['tile_matmul_err']}, "
          f"flash_attention max |err| {detail['flash_attention_err']}")

    # 4. Times: kernel, plain version, one PyTorch call as yardstick.
    detail["tile_matmul_time"] = time_tile_matmul(tm_kernel, tile_matmul_ref)
    detail["flash_attention_time"] = time_flash(fa_kernel, flash_attention_ref)
    print(f"times (ms): tile_matmul {detail['tile_matmul_time']}")
    print(f"times (ms): flash_attention {detail['flash_attention_time']}")

    # 5. The main path: serve full-width smollm_360m from seeded random
    # weights. A short warm-up serve first, so the timed run holds no
    # first-call set-up.
    cfg = get_config("smollm_360m")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    serve("smollm_360m", reduced=False, batch=BATCH, prompt_len=PROMPT, gen=2,
          cache_len=CACHE, seed=0, device="cuda", params=params, log=lambda _: None)
    torch.cuda.reset_peak_memory_stats()
    tm_kernel.tile_matmul.launches = 0
    fa_kernel.flash_attention.launches = 0
    res = serve("smollm_360m", reduced=False, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                cache_len=CACHE, seed=0, device="cuda", params=params)
    launches = {"tile_matmul": tm_kernel.tile_matmul.launches,
                "flash_attention": fa_kernel.flash_attention.launches}
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    assert toks.shape == (BATCH, GEN), toks.shape
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    assert launches["flash_attention"] == cfg.n_layers, launches
    assert launches["tile_matmul"] == 7 * cfg.n_layers * (1 + GEN), launches
    detail["serve"] = dict(batch=BATCH, prompt_len=PROMPT, gen=GEN, cache_len=CACHE,
                           prefill_s=res["t_prefill"], decode_s=res["t_decode"],
                           decode_tok_s=BATCH * GEN / res["t_decode"],
                           peak_mem_bytes=peak, launches=launches,
                           params=M.param_count(cfg))
    print(f"serve: prefill {BATCH}x{PROMPT} {res['t_prefill']:.4f} s, decode "
          f"{detail['serve']['decode_tok_s']:.1f} tok/s, peak memory "
          f"{peak / 2**30:.3f} GiB, launches {launches} "
          f"(flash {launches['flash_attention']} per prefill, tile_matmul "
          f"{launches['tile_matmul'] // (1 + GEN)} per forward pass)")
    detail["profile"] = profile_steps(M, cfg, params)
    del params
    for phase, p in detail["profile"].items():
        print(f"profile {phase}: wall {p['wall_ms']:.3f} ms, device kernels "
              f"{p['device_ms']:.3f} ms, busy share {p['busy_share']:.3f}")

    # 6. Full-depth float32 parity, kernel path vs plain path.
    detail["parity_f32_max_err"] = parity_f32(M, get_config)
    print(f"parity f32 full depth: max |logit err| {detail['parity_f32_max_err']:.3e}")

    # 7. Results.
    tmt, fat = detail["tile_matmul_time"]["prefill"], detail["flash_attention_time"]
    kernels = [
        dict(name="tile_matmul", route="cuda", source="src/repro_torch/csrc/tile_matmul.cu",
             replaces="src/repro/kernels/tile_matmul/kernel.py:58",
             launches=launches["tile_matmul"],
             max_abs_err=detail["tile_matmul_err"][str(torch.bfloat16)],
             ms=tmt["ms"], plain_ms=tmt["plain_ms"], bound_ms=tmt["bound_ms"],
             bound_by=tmt["bound_by"], library_ms=tmt["library_ms"],
             timed="one layer's 7 prefill projections, M=4096, bf16"),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:88",
             launches=launches["flash_attention"],
             max_abs_err=detail["flash_attention_err"][str(torch.bfloat16)],
             ms=fat["ms"], plain_ms=fat["plain_ms"], bound_ms=fat["bound_ms"],
             bound_by=fat["bound_by"], library_ms=fat["library_ms"],
             timed="one layer's prefill attention, q (40, 3, 512, 64), causal, bf16"),
    ]
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(detail, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
