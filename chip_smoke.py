#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version at the serving and training paths'
shapes, times them, and drives the port's two serving paths through its
``serve`` entry point (batch 8 x 512-token prompts, 32 greedy tokens each):
full-width smollm_360m (tile_matmul + flash_attention) and full-width,
full-depth mamba2_2_7b (tile_matmul + ssd_scan); then its training path
through ``train``: five AdamW steps of full-width, full-depth smollm_360m on
8 x 512 tokens, every projection's forward and both gradient products
through tile_matmul, every attention through flash_attention and its
backward kernel, and one float32 train step held against the CPU's; then
the same for full-width, full-depth mamba2_2_7b, every scan through
ssd_scan and its gradient through ssd_scan_bwd; then full-width, full-depth
smollm_360m trained by the paper's ACAN runtime (``ACANStepRunner``: Manager
and Handler threads over the tuple space, one task a microbatch gradient,
4 x 2 x 512 tokens a step) without and with injected handler crashes, whose
losses and weights must agree bit for bit, one of its steps profiled, and
the float32 runner held against the CPU's; then the paper's own system
(§6): the MLP's forward and backward op bodies on the card against the
CPU's (their tile products float32 tile_matmul launches of 16 masked rows,
each task's bits the same alone and in its batch), the three experiments at
the paper's width through ``repro_torch.configs.paper_mlp`` (exp 3 under
Manager and Handler crashes equal to its crash-free run bit for bit), the
float32 MLP against the CPU's, and the MLP beside full-width smollm_360m as
two tenants of one ACANCloud under crashes, each keeping its trajectory.
Per-path counters show that every
bf16 projection took tile_matmul's wgmma kernel (prefill) or its streaming
kernel (decode), and every bf16 prefill attention and scan the mma path of
flash_attention and ssd_scan; ptxas and SASS are checked for spills, wgmma,
TMA and the mma paths' tensor-core instructions. For each model it
profiles one prefill and one decode step and checks float32 logits of the
kernel path against the plain path on the CPU (smollm at full depth,
mamba2 at full width and 8 layers).

The gradient products (``dx = dz @ w^T``, ``dw = x^T @ dz`` through
tile_matmul's transposed layouts, at both models' projection shapes),
flash_attention's backward and ssd_scan's backward are checked against
their plain versions (and for repeat launches giving the same bits) and
timed beside ``torch.matmul`` and SDPA's backward (no single PyTorch call
computes the scan's gradient).

Usage (from the repository root, on a host with a CUDA device)::

    python3 chip_smoke.py

Prints the device and its power limit, one ``{"phase": ...}`` JSON line for
each of the MLP phases, a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase raises
and exits non-zero. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
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
# One layer's block projections, (K, N, activation): smollm_360m's seven
# (q, k, v, o, gate, up, down) and mamba2_2_7b's six (z, x, B, C, dt, out).
LAYER = {"smollm_360m": ((960, 960, "none"), (960, 320, "none"), (960, 320, "none"),
                         (960, 960, "none"), (960, 2560, "silu"), (960, 2560, "none"),
                         (2560, 960, "none")),
         "mamba2_2_7b": ((2560, 5120, "none"), (2560, 5120, "none"), (2560, 128, "none"),
                         (2560, 128, "none"), (2560, 80, "none"), (5120, 2560, "none"))}
BATCH, PROMPT, GEN, CACHE = 8, 512, 32, 1024
# ssd_scan: (Bt, T, H, P, G, N) of one mamba2_2_7b layer's prefill scan.
SSD_PATH = (BATCH, PROMPT, 80, 64, 1, 128)
SSD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-3}
MAMBA_PARITY_LAYERS = 8


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


def _graph_ms(fn, iters=20) -> float:
    """Device time of one call without the host's cost a call: ``iters``
    calls captured in a CUDA graph, the graph replayed and timed by CUDA
    events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _time_ms(graph.replay, iters=5) / iters


def _device_kernels(prof) -> list[tuple[str, float, int]]:
    """(name, device ms, launches) of each kernel in a torch.profiler trace,
    the longest first."""
    from torch.autograd import DeviceType

    kern = []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            kern.append((e.key, (us if us is not None else e.self_cuda_time_total) / 1e3,
                         e.count))
    return sorted(kern, key=lambda r: -r[1])


def _traced_ms(fn, names: tuple[str, ...], iters=10) -> dict:
    """Device time a launch of each kernel whose name holds one of
    ``names``, from a torch.profiler trace of ``iters`` calls after a
    warm-up call. Fails unless each ran once a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        hits = [(t, c) for k, t, c in _device_kernels(prof) if name in k]
        assert len(hits) == 1 and hits[0][1] == iters, (name, hits)
        out[name] = hits[0][0] / iters
    return out


def _bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return type(tree)(_to(v, device) for v in tree)


# Shapes beyond the serving paths', so that every tile_matmul path is held
# against the plain version: a ragged M (400) for the wgmma path, the GPU
# tests' unaligned (M, K, N) = (257, 40, 20), which bf16 takes through mma,
# and (3, 40, 20): mma in bf16 (40-byte weight rows), skinny in float32.
TM_EXTRA = ((400, 2560, 5120), (400, 960, 320), (257, 40, 20), (3, 40, 20))


def check_tile_matmul(tm_kernel, tile_matmul_ref) -> dict:
    """Kernel vs plain version at every projection shape of both serving
    paths (prefill and decode M) and at ``TM_EXTRA``, every activation and
    dtype, with and without bias. Worst error per dtype and per path; every
    path must have run."""
    shapes = sorted({(k, n) for layer in LAYER.values() for k, n, _ in layer})
    cases = [(m, k, n) for m in (BATCH * PROMPT, BATCH) for k, n in shapes] + list(TM_EXTRA)
    paths = tm_kernel.tile_matmul.paths
    err: dict = {"by_path": {}}
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for m, k, n in cases:
            x = _randn((m, k), dtype, m + k)
            w = _randn((k, n), dtype, n, k ** -0.5)
            b = _randn((n,), dtype, 7)
            for act in ACTS:
                for bias in (None, b):
                    before = dict(paths)
                    out = tm_kernel.tile_matmul(x, w, bias, activation=act)
                    (path,) = [p for p in paths if paths[p] != before[p]]
                    ref = tile_matmul_ref(x, w, bias, activation=act)
                    torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                                               atol=TOL[dtype],
                                               msg=lambda e, c=(m, k, n, path): f"{c}: {e}")
                    e = (out.float() - ref.float()).abs().max().item()
                    worst = max(worst, e)
                    key = f"{path} {dtype}"
                    err["by_path"][key] = max(err["by_path"].get(key, 0.0), e)
        err[str(dtype)] = worst
    torch.cuda.synchronize()
    ran = {k.split()[0] for k in err["by_path"]}
    assert ran == set(paths), f"paths checked: {sorted(ran)}"
    return err


def _ptxas_kernels(ptxas: str) -> dict:
    """Registers, shared memory and spills of each kernel, from ptxas -v."""
    kernels, name = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            kernels[name] = {"spill": line.split(",", 1)[1].strip()}
        elif name and "Used" in line and name in kernels:
            kernels[name]["used"] = line.split(":", 1)[1].strip()
    return kernels


def _sass_ops(so: Path, ops) -> dict:
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    return {op: sass.count(op) for op in ops}


# Kernels that must not spill, by a substring of their mangled names, and the
# SASS each library must hold: wgmma (HGMMA) in tile_matmul (with TMA,
# UTMALDG) and in the attention backward at D = 64, the mma paths'
# tensor-core products (HMMA) and ldmatrix (LDSM) loads.
NO_SPILL = {"tile_matmul": ("wgmma", "skinny"), "flash_attention": ("flash_fwd_mma",),
            "ssd_scan": ("ssd_fwd_mma",),
            "flash_attention_bwd": ("_mmaI", "_wgmma"),
            "ssd_scan_bwd": ("ssd_bwd_mma",)}
SASS_OPS = {"tile_matmul": ("HGMMA", "UTMALDG", "LDL", "STL"),
            "flash_attention": ("HMMA", "LDSM", "LDGSTS", "LDL", "STL"),
            "ssd_scan": ("HMMA", "LDSM", "LDGSTS", "LDL", "STL"),
            "flash_attention_bwd": ("HGMMA", "HMMA", "LDSM", "LDGSTS", "LDL", "STL"),
            "ssd_scan_bwd": ("HMMA", "LDSM", "LDGSTS", "LDL", "STL")}
SASS_NEED = {"tile_matmul": ("HGMMA", "UTMALDG"), "flash_attention": ("HMMA", "LDSM"),
             "ssd_scan": ("HMMA", "LDSM"), "flash_attention_bwd": ("HGMMA", "HMMA", "LDSM"),
             "ssd_scan_bwd": ("HMMA", "LDSM", "LDGSTS")}


def kernel_build_report(build, ptxas: dict) -> dict:
    """What ptxas said of each kernel of each library (registers, shared
    memory, spills) and the counts of ``SASS_OPS`` in each library. Fails on
    a spill in a kernel of ``NO_SPILL``, and on a library without the
    instructions of ``SASS_NEED`` (the wgmma of tile_matmul and of the
    attention backward, tile_matmul's TMA, the mma paths' HMMA and LDSM)."""
    report = {}
    no_spill = "0 bytes spill stores, 0 bytes spill loads"
    for lib, keys in NO_SPILL.items():
        kernels = _ptxas_kernels(ptxas[lib])
        ops = _sass_ops(build._target(lib), SASS_OPS[lib])
        checked = [k for k in kernels if any(key in k for key in keys)]
        assert kernels and (checked or not keys), (lib, sorted(kernels))
        for kname in checked:
            assert kernels[kname]["spill"].startswith(no_spill), (kname, kernels[kname])
        assert all(ops[op] > 0 for op in SASS_NEED[lib]), (lib, ops)
        report[lib] = {"kernels": kernels, "sass_ops": ops}
    return report


FLASH_CASES = (  # (name, BH, G, Tq, Tkv, window, softcap)
    ("causal", 40, 3, 512, 512, 0, 0.0),
    ("window", 40, 3, 512, 512, 128, 0.0),
    ("softcap", 40, 3, 512, 512, 0, 30.0),
    ("q_offset", 40, 3, 256, 512, 0, 0.0),
)


# The path each dtype must take at the checks' shapes.
DTYPE_PATH = {torch.bfloat16: "mma", torch.float32: "ffma"}


def _took(fn, path: str, before: dict) -> None:
    after = fn.paths
    assert {p: after[p] - before[p] for p in after} == {p: int(p == path) for p in after}, \
        (path, before, dict(after))


def check_flash(fa_kernel, flash_attention_ref) -> dict:
    """Kernel vs plain version at the serving shape and its window, softcap
    and q_offset variants: the mma path in bf16, the ffma path in float32."""
    err = {}
    fn = fa_kernel.flash_attention
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for name, bh, g, tq, tkv, window, softcap in FLASH_CASES:
            q = _randn((bh, g, tq, 64), dtype, 1)
            k = _randn((bh, tkv, 64), dtype, 2)
            v = _randn((bh, tkv, 64), dtype, 3)
            kw = dict(causal=True, window=window, softcap=softcap, q_offset=tkv - tq)
            before = dict(fn.paths)
            out = fn(q, k, v, **kw)
            _took(fn, DTYPE_PATH[dtype], before)
            ref = flash_attention_ref(q, k, v, **kw)
            torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                                       atol=TOL[dtype], msg=lambda m, c=name: f"{c}: {m}")
            worst = max(worst, (out.float() - ref.float()).abs().max().item())
        err[str(dtype)] = worst
        err[DTYPE_PATH[dtype]] = worst
    torch.cuda.synchronize()
    return err


def _grad_operands(m: int, k: int, n: int, dtype, seed: int):
    """x (m, k), w (k, n) and an output gradient dz (m, n) scaled so that
    dx and dw are of order 1."""
    return (_randn((m, k), dtype, seed), _randn((k, n), dtype, seed + 1, k ** -0.5),
            _randn((m, n), dtype, seed + 2, m ** -0.5))


def check_tile_matmul_grad(tm_kernel, tile_matmul_ref) -> dict:
    """The gradient products of smollm_360m's seven and mamba2_2_7b's six
    projections at M = 4096 (mamba2's give K = 80 for the dt projection's
    dx and N = 80 and 128 for dw: TMA boxes the tiles overhang): dx = dz @
    w^T (w read in place, ``trans_w``) and dw = x^T @ dz (x read in place,
    ``trans_x``) against the plain version, bf16 through wgmma and float32
    through ffma; two launches of dw give the same bits."""
    fn = tm_kernel.tile_matmul
    err: dict = {}
    shapes = [kn for layer in LAYER.values() for kn in layer]
    for dtype in (torch.bfloat16, torch.float32):
        worst = {"dx": 0.0, "dw": 0.0}
        for i, (k, n, _) in enumerate(shapes):
            x, w, dz = _grad_operands(BATCH * PROMPT, k, n, dtype, 10 * i)
            for name, a, b, kw in (("dx", dz, w, dict(trans_w=True)),
                                   ("dw", x, dz, dict(trans_x=True))):
                before, layouts = dict(fn.paths), dict(fn.layouts)
                out = fn(a, b, **kw)
                _took(fn, {torch.bfloat16: "wgmma", torch.float32: "ffma"}[dtype], before)
                layout = tm_kernel.layout_of(kw.get("trans_x", False), kw.get("trans_w", False))
                assert fn.layouts[layout] == layouts[layout] + 1, (layout, fn.layouts)
                ref = tile_matmul_ref(a, b, **kw)
                torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                                           atol=TOL[dtype],
                                           msg=lambda e, c=(name, k, n): f"{c}: {e}")
                worst[name] = max(worst[name], (out.float() - ref.float()).abs().max().item())
                if name == "dw":
                    assert torch.equal(out, fn(a, b, **kw)), ("dw not deterministic", k, n)
        err[str(dtype)] = worst
    torch.cuda.synchronize()
    return err


def check_flash_bwd(fa_kernel, flash_attention_ref, flash_attention_bwd_ref) -> dict:
    """The backward kernels against the explicit formula at ``check_flash``'s
    cases (the forward's lse against the plain version's first): the mma
    path in bf16, the ffma path in float32; two launches give the same bits."""
    err = {}
    bwd = fa_kernel.flash_attention_bwd
    for dtype in (torch.bfloat16, torch.float32):
        worst = {"lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
        for name, bh, g, tq, tkv, window, softcap in FLASH_CASES:
            q = _randn((bh, g, tq, 64), dtype, 1)
            k = _randn((bh, tkv, 64), dtype, 2)
            v = _randn((bh, tkv, 64), dtype, 3)
            do = _randn((bh, g, tq, 64), dtype, 4)
            kw = dict(causal=True, window=window, softcap=softcap, q_offset=tkv - tq)
            o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
            _, lse_ref = flash_attention_ref(q, k, v, return_lse=True, **kw)
            torch.testing.assert_close(lse, lse_ref, rtol=TOL[dtype], atol=TOL[dtype],
                                       msg=lambda m, c=name: f"lse {c}: {m}")
            worst["lse"] = max(worst["lse"], (lse - lse_ref).abs().max().item())
            before = dict(bwd.paths)
            grads = bwd(q, k, v, o, do, lse, **kw)
            _took(bwd, DTYPE_PATH[dtype], before)
            refs = flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
            for gname, got, want in zip(("dq", "dk", "dv"), grads, refs):
                torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                                           atol=TOL[dtype],
                                           msg=lambda m, c=(name, gname): f"{c}: {m}")
                worst[gname] = max(worst[gname], (got.float() - want.float()).abs().max().item())
            again = bwd(q, k, v, o, do, lse, **kw)
            assert all(torch.equal(a, b) for a, b in zip(grads, again)), ("bwd", name)
        err[str(dtype)] = worst
    torch.cuda.synchronize()
    return err


def _time_layer(layer, m: int, copies: int, tm_kernel, tile_matmul_ref) -> dict:
    """One layer's bf16 projections ``layer`` at M = ``m``, cycling through
    ``copies`` sets of weights. Kernel and ``torch.matmul`` in turns
    (kernel, library, kernel, library); times are the mean of the turns."""
    dt = torch.bfloat16
    xs = {k: _randn((m, k), dt, k) for k in {k for k, _, _ in layer}}
    ws = [[_randn((k, n), dt, 10 * c + i, k ** -0.5) for i, (k, n, _) in enumerate(layer)]
          for c in range(copies)]

    def run(fn):
        for wl in ws:
            for (k, _, act), w in zip(layer, wl):
                fn(xs[k], w, act)

    def lib(x, w, act):
        y = torch.matmul(x, w)
        return F.silu(y) if act == "silu" else y

    def kern():
        run(lambda x, w, a: tm_kernel.tile_matmul(x, w, activation=a))

    turns = [_time_ms(f) / copies for f in (kern, lambda: run(lib)) * 2]
    kern_ms, lib_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
    plain = _time_ms(lambda: run(lambda x, w, a: tile_matmul_ref(x, w, activation=a)))
    flops = sum(2 * m * k * n for k, n, _ in layer)
    nbytes = sum((m * k + k * n + m * n) * 2 for k, n, _ in layer)
    bound_ms, bound_by = _bound(flops, nbytes, dt)
    return dict(M=m, ms=kern_ms, plain_ms=plain / copies, library_ms=lib_ms,
                turns_ms=turns, vs_library=kern_ms / lib_ms,
                tflop_s=flops / kern_ms / 1e9, gb_s=nbytes / kern_ms / 1e6,
                flop=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)


def time_tile_matmul(tm_kernel, tile_matmul_ref) -> dict:
    """One layer of each model in prefill (M = 4096) and decode (M = 8).
    Decode cycles through enough weight copies to overflow the 50 MB L2, as
    a decode step finds each layer's weights cold."""
    out = {}
    for arch, layer, copies in (("", LAYER["smollm_360m"], 4),
                                ("mamba2_", LAYER["mamba2_2_7b"], 2)):
        out[arch + "prefill"] = _time_layer(layer, BATCH * PROMPT, 1, tm_kernel,
                                            tile_matmul_ref)
        out[arch + "decode"] = _time_layer(layer, BATCH, copies, tm_kernel, tile_matmul_ref)
    return out


def time_flash(fa_kernel, flash_attention_ref) -> dict:
    """Prefill attention of one layer, bf16: q (40, 3, 512, 64), causal,
    through the mma path (``ms``) and, once, the ffma path (``ffma_ms``),
    beside SDPA (``library_ms``); kernel and SDPA also by CUDA-graph replay
    (``device_ms``, ``library_device_ms``)."""
    dt, bh, g, t, d = torch.bfloat16, BATCH * 5, 3, PROMPT, 64
    q = _randn((bh, g, t, d), dt, 1)
    k = _randn((bh, t, d), dt, 2)
    v = _randn((bh, t, d), dt, 3)
    kern = _time_ms(lambda: fa_kernel.flash_attention(q, k, v, causal=True))
    ffma = _time_ms(lambda: fa_kernel.flash_attention(q, k, v, causal=True, path="ffma"))
    plain = _time_ms(lambda: flash_attention_ref(q, k, v, causal=True))
    qs = q.reshape(BATCH, 15, t, d)
    ks = k.reshape(BATCH, 5, t, d).repeat_interleave(g, dim=1)
    vs = v.reshape(BATCH, 5, t, d).repeat_interleave(g, dim=1)
    library = _time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
    device = _graph_ms(lambda: fa_kernel.flash_attention(q, k, v, causal=True))
    library_device = _graph_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                      is_causal=True))
    pairs = bh * g * t * (t + 1) // 2          # unmasked (query, key) pairs
    flops = 4 * d * pairs
    nbytes = (q.numel() * 2 + k.numel() + v.numel()) * 2
    bound_ms, bound_by = _bound(flops, nbytes, dt)
    return dict(ms=kern, ffma_ms=ffma, plain_ms=plain, library_ms=library,
                vs_library=kern / library, device_ms=device,
                library_device_ms=library_device, flop=flops, bytes=nbytes,
                bound_ms=bound_ms, bound_by=bound_by)


def time_tile_matmul_grad(tm_kernel, tile_matmul_ref, arch: str = "smollm_360m") -> dict:
    """The gradient products of one ``arch`` layer's projections at M =
    4096, bf16: dx = dz @ w^T and dw = x^T @ dz, by CUDA events (``ms``,
    kernel and ``torch.matmul`` on the same transposed views in turns) and
    by CUDA-graph replay (``device_ms``), each product apart and both
    together."""
    dt, m, layer = torch.bfloat16, BATCH * PROMPT, LAYER[arch]
    ops = [_grad_operands(m, k, n, dt, 10 * i) for i, (k, n, _) in enumerate(layer)]
    runs = {
        "dx": (lambda f: [f(dz, w, True, False) for _, w, dz in ops]),
        "dw": (lambda f: [f(x, dz, False, True) for x, _, dz in ops]),
    }
    kern = lambda a, b, tw, tx: tm_kernel.tile_matmul(a, b, trans_w=tw, trans_x=tx)  # noqa: E731
    lib = lambda a, b, tw, tx: torch.matmul(a.t() if tx else a, b.t() if tw else b)  # noqa: E731
    plain = lambda a, b, tw, tx: tile_matmul_ref(a, b, trans_w=tw, trans_x=tx)  # noqa: E731
    out = {}
    for name, run in runs.items():
        turns = [_time_ms(lambda f=f: run(f)) for f in (kern, lib) * 2]
        flops = sum(2 * m * k * n for k, n, _ in layer)
        nbytes = sum((m * k + k * n + m * n) * 2 for k, n, _ in layer)
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        kern_ms, lib_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
        out[name] = dict(ms=kern_ms, library_ms=lib_ms, turns_ms=turns,
                         vs_library=kern_ms / lib_ms,
                         device_ms=_graph_ms(lambda: run(kern), iters=5),
                         plain_ms=_time_ms(lambda: run(plain), iters=5),
                         flop=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                         tflop_s=flops / kern_ms / 1e9)
    both = {k: out["dx"][k] + out["dw"][k]
            for k in ("ms", "library_ms", "device_ms", "plain_ms", "flop", "bytes")}
    both["bound_ms"], both["bound_by"] = _bound(both["flop"], both["bytes"], dt)
    out["both"] = both
    return out


def time_flash_bwd(fa_kernel, flash_attention_bwd_ref) -> dict:
    """One layer's attention backward at the training shape, q (40, 3, 512,
    64) causal, bf16: the mma path by CUDA events (``ms``) and graph replay
    (``device_ms``), the ffma path on the same inputs once (``ffma_ms``),
    the explicit plain formula, and SDPA's backward with K/V repeated to the
    15 query heads: its aten op (``_scaled_dot_product_flash_attention_
    backward``, from the forward's own outputs) by CUDA events
    (``library_ms``) and by graph replay (``library_device_ms``); each of the
    two kernels' device time a launch from a profiler trace (``dq_ms``,
    ``dkv_ms``). Work: the five products of the function, 2 D operations
    each a visible (query, key) pair."""
    dt, bh, g, t, d = torch.bfloat16, BATCH * 5, 3, PROMPT, 64
    q = _randn((bh, g, t, d), dt, 1)
    k = _randn((bh, t, d), dt, 2)
    v = _randn((bh, t, d), dt, 3)
    do = _randn((bh, g, t, d), dt, 4)
    o, lse = fa_kernel.flash_attention(q, k, v, causal=True, return_lse=True)
    kern = _time_ms(lambda: fa_kernel.flash_attention_bwd(q, k, v, o, do, lse))
    ffma = _time_ms(lambda: fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, path="ffma"),
                    iters=5)
    device = _graph_ms(lambda: fa_kernel.flash_attention_bwd(q, k, v, o, do, lse), iters=5)
    traced = _traced_ms(lambda: fa_kernel.flash_attention_bwd(q, k, v, o, do, lse),
                        ("flash_bwd_dq_wgmma", "flash_bwd_dkv_wgmma"))
    plain = _time_ms(lambda: flash_attention_bwd_ref(q, k, v, o, do, lse), iters=3)
    qs = q.reshape(BATCH, 15, t, d)
    ks = k.reshape(BATCH, 5, t, d).repeat_interleave(g, dim=1)
    vs = v.reshape(BATCH, 5, t, d).repeat_interleave(g, dim=1)
    dos = do.reshape(BATCH, 15, t, d)
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(qs, ks, vs, 0.0, True, False)
    out_f, lse_f, cq, ck, mq, mk, seed, offset = fwd[:8]

    def sdpa_bwd():
        return aten._scaled_dot_product_flash_attention_backward(
            dos, qs, ks, vs, out_f, lse_f, cq, ck, mq, mk, 0.0, True, seed, offset)

    library = _time_ms(sdpa_bwd)
    library_device = _graph_ms(sdpa_bwd, iters=5)
    pairs = bh * g * t * (t + 1) // 2
    flops = 10 * d * pairs
    nbytes = (4 * q.numel() + 4 * k.numel()) * 2 + lse.numel() * 4
    bound_ms, bound_by = _bound(flops, nbytes, dt)
    return dict(ms=kern, ffma_ms=ffma, device_ms=device, dq_ms=traced["flash_bwd_dq_wgmma"],
                dkv_ms=traced["flash_bwd_dkv_wgmma"], plain_ms=plain, library_ms=library, library_device_ms=library_device, vs_library=kern / library,
                device_vs_library=device / library_device, flop=flops, bytes=nbytes,
                bound_ms=bound_ms, bound_by=bound_by, tflop_s=flops / kern / 1e9)


def _ssd_inputs(bt, t, h, p, g, n, dtype, seed):
    x = _randn((bt, t, h, p), dtype, seed, 0.5)
    dt = F.softplus(_randn((bt, t, h), torch.float32, seed + 1))
    a = -torch.exp(_randn((h,), torch.float32, seed + 2, 0.3))
    b = _randn((bt, t, g, n), dtype, seed + 3, 0.5)
    c = _randn((bt, t, g, n), dtype, seed + 4, 0.5)
    d = 1.0 + _randn((h,), torch.float32, seed + 5, 0.1)
    return x, dt, a, b, c, d


SSD_CASES = (  # (name, Bt, T, H, P, G, N)
    ("path", *SSD_PATH),
    ("ragged", 2, 200, 80, 64, 1, 128),
    ("groups", 2, 256, 80, 64, 8, 128),
)


def check_ssd(ssd_kernel, ssd_plain) -> dict:
    """Kernel vs the per-timestep plain version: y and the final state, at
    the path's shape, a ragged T and G > 1: the mma path in bf16, the ffma
    path in float32."""
    err = {}
    fn = ssd_kernel.ssd_scan
    for dtype in (torch.bfloat16, torch.float32):
        worst = {"y": 0.0, "state": 0.0}
        for name, *shape in SSD_CASES:
            args = _ssd_inputs(*shape, dtype, seed=sum(shape))
            before = dict(fn.paths)
            y, s = fn(*args)
            _took(fn, DTYPE_PATH[dtype], before)
            yr, sr = ssd_plain(*args)
            tol = SSD_TOL[dtype]
            torch.testing.assert_close(y.float(), yr.float(), rtol=tol, atol=tol,
                                       msg=lambda m, c=name: f"ssd y {c}: {m}")
            torch.testing.assert_close(s, sr, rtol=1e-3, atol=1e-3,
                                       msg=lambda m, c=name: f"ssd state {c}: {m}")
            worst["y"] = max(worst["y"], (y.float() - yr.float()).abs().max().item())
            worst["state"] = max(worst["state"], (s - sr).abs().max().item())
        err[str(dtype)] = err[DTYPE_PATH[dtype]] = worst
    torch.cuda.synchronize()
    return err


def time_ssd(ssd_kernel, ssd_plain) -> dict:
    """One mamba2_2_7b layer's prefill scan, bf16. Operations are the
    function's own work, whatever the algorithm's chunk: the recurrence's
    state update and readout, 2 N P each a (batch, head, step); bytes read
    each input and write each output once. Bound under the bf16 tensor-core
    peak (the least time the card could take) and under the float32 FFMA
    peak the ffma path computes at. ``ms`` is the mma path, ``ffma_ms`` the
    ffma path on the same bf16 inputs, ``device_ms`` the mma path by
    CUDA-graph replay. No single PyTorch call computes an SSD scan: no
    library time."""
    bt, t, h, p, g, n = SSD_PATH
    dt = torch.bfloat16
    args = _ssd_inputs(bt, t, h, p, g, n, dt, seed=5)
    kern = _time_ms(lambda: ssd_kernel.ssd_scan(*args))
    ffma = _time_ms(lambda: ssd_kernel.ssd_scan(*args, path="ffma"), iters=5)
    device = _graph_ms(lambda: ssd_kernel.ssd_scan(*args))
    plain = _time_ms(lambda: ssd_plain(*args), iters=5)
    flops = 4 * bt * h * t * n * p
    nbytes = (2 * bt * t * h * p * 2 + bt * h * n * p * 4 + bt * t * h * 4
              + 2 * bt * t * g * n * 2 + 2 * h * 4)
    bound_ms, bound_by = _bound(flops, nbytes, dt)
    bound_f32_ms, bound_f32_by = _bound(flops, nbytes, torch.float32)
    return dict(ms=kern, ffma_ms=ffma, device_ms=device, plain_ms=plain, library_ms=None,
                flop=flops, bytes=nbytes,
                bound_ms=bound_ms, bound_by=bound_by, bound_f32_ms=bound_f32_ms,
                bound_f32_by=bound_f32_by)


def _ssd_cotangents(bt, t, h, p, _g, n, dtype, seed):
    """dy in ``dtype`` and a non-zero float32 final-state gradient."""
    return _randn((bt, t, h, p), dtype, seed + 6, 0.5), _randn((bt, h, n, p), torch.float32,
                                                                seed + 7, 0.5)


SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


def check_ssd_bwd(ssd_kernel, ssd_plain_bwd) -> dict:
    """The scan's backward against the plain adjoint at ``SSD_CASES``, with
    a non-zero final-state gradient: the mma path in bf16, the ffma path in
    float32, each reading the chunk states the forward wrote, as training
    does. Each gradient within ``SSD_TOL`` of
    its largest entry (bf16 2e-2, float32 1e-3); two launches give the same
    bits. Worst error per gradient relative to that largest entry (``rel``)
    and absolute (``abs``)."""
    err = {}
    fn = ssd_kernel.ssd_scan_bwd
    for dtype in (torch.bfloat16, torch.float32):
        worst = {"rel": dict.fromkeys(SSD_GRADS, 0.0), "abs": dict.fromkeys(SSD_GRADS, 0.0)}
        for name, *shape in SSD_CASES:
            seed = sum(shape)
            args = _ssd_inputs(*shape, dtype, seed=seed)
            dy, ds = _ssd_cotangents(*shape, dtype, seed)
            states = torch.empty(ssd_kernel.chunk_states_shape(args[0], args[3]),
                                 dtype=torch.float32, device="cuda")
            ssd_kernel.ssd_scan(*args, chunk_states=states)
            refs = ssd_plain_bwd(*args, dy, ds)
            before = dict(fn.paths)
            grads = fn(*args, dy, ds, states)
            _took(fn, DTYPE_PATH[dtype], before)
            for gname, got, want in zip(SSD_GRADS, grads, refs):
                e = (got.float() - want.float()).abs().max().item()
                rel = e / want.float().abs().max().item()
                assert rel <= SSD_TOL[dtype], (name, gname, dtype, rel)
                worst["rel"][gname] = max(worst["rel"][gname], rel)
                worst["abs"][gname] = max(worst["abs"][gname], e)
            again = fn(*args, dy, ds, states)
            assert all(torch.equal(a, b) for a, b in zip(grads, again)), ("ssd bwd", name)
            del refs, states
        err[str(dtype)] = err[DTYPE_PATH[dtype]] = worst
    torch.cuda.synchronize()
    return err


def time_ssd_bwd(ssd_kernel, ssd_plain_bwd) -> dict:
    """One mamba2_2_7b layer's scan backward at the training shape, bf16,
    with a final-state gradient, reading the chunk states the forward wrote:
    the mma path by CUDA events (``ms``) and by CUDA-graph replay
    (``device_ms``), each of its two kernels' device time a launch from a
    profiler trace (the walk over the chunks, ``walk_ms``, and the head sum
    of B's and C's gradients, ``head_sum_ms``), the ffma path on the same
    inputs (``ffma_ms``), and the plain adjoint.
    Work: the recurrence's adjoint, 6 N P multiply-adds a (batch, head,
    step); bytes: each input read and each output written once (the chunk
    states the kernel also reads, ``states_bytes``, are not the function's
    inputs). No single PyTorch call computes the scan's gradient: no
    library time."""
    bt, t, h, p, g, n = SSD_PATH
    dt = torch.bfloat16
    args = _ssd_inputs(bt, t, h, p, g, n, dt, seed=5)
    dy, ds = _ssd_cotangents(bt, t, h, p, g, n, dt, 5)
    fn = ssd_kernel.ssd_scan_bwd
    states = torch.empty(ssd_kernel.chunk_states_shape(args[0], args[3]), dtype=torch.float32,
                         device="cuda")
    ssd_kernel.ssd_scan(*args, chunk_states=states)
    kern = _time_ms(lambda: fn(*args, dy, ds, states))
    ffma = _time_ms(lambda: fn(*args, dy, ds, states, path="ffma"), iters=5)
    device = _graph_ms(lambda: fn(*args, dy, ds, states), iters=5)
    traced = _traced_ms(lambda: fn(*args, dy, ds, states), ("ssd_bwd_mma", "ssd_bwd_reduce"))
    states_bytes = states.numel() * 4
    del states
    plain = _time_ms(lambda: ssd_plain_bwd(*args, dy, ds), iters=2)
    flops = 12 * bt * h * t * n * p
    nbytes = (3 * bt * t * h * p * 2 + bt * h * n * p * 4 + 2 * bt * t * h * 4
              + 4 * bt * t * g * n * 2 + 4 * h * 4)
    bound_ms, bound_by = _bound(flops, nbytes, dt)
    return dict(ms=kern, ffma_ms=ffma, device_ms=device, walk_ms=traced["ssd_bwd_mma"],
                head_sum_ms=traced["ssd_bwd_reduce"], plain_ms=plain, library_ms=None, flop=flops,
                bytes=nbytes, states_bytes=states_bytes, bound_ms=bound_ms, bound_by=bound_by)


def _zero(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0
        for per in (getattr(fn, "paths", {}), getattr(fn, "layouts", {})):
            for key in per:
                per[key] = 0


def _read(counters: dict) -> dict:
    return {k: fn.launches for k, fn in counters.items()}


def serve_path(serve, M, cfg, params, counters: dict) -> dict:
    """Serve full-width ``cfg`` through ``serve``: a short warm-up serve
    first, so the timed run holds no first-call set-up, then the timed run
    with every launch count set to 0 just before it and read just after."""
    kw = dict(reduced=False, batch=BATCH, prompt_len=PROMPT, cache_len=CACHE, seed=0,
              device="cuda", params=params)
    serve(cfg.name, gen=2, log=lambda _: None, **kw)
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    res = serve(cfg.name, gen=GEN, **kw)
    launches = _read(counters)
    by_path = {k: dict(fn.paths) for k, fn in counters.items() if hasattr(fn, "paths")}
    paths = by_path["tile_matmul"]
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    assert toks.shape == (BATCH, GEN), toks.shape
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    out = dict(arch=cfg.name, batch=BATCH, prompt_len=PROMPT, gen=GEN, cache_len=CACHE,
               prefill_s=res["t_prefill"], decode_s=res["t_decode"],
               decode_tok_s=BATCH * GEN / res["t_decode"], peak_mem_bytes=peak,
               launches=launches, tile_matmul_paths=paths, launches_by_path=by_path,
               params=M.param_count(cfg))
    print(f"serve {cfg.name}: prefill {BATCH}x{PROMPT} {res['t_prefill']:.4f} s, decode "
          f"{out['decode_tok_s']:.1f} tok/s, peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}, by path {by_path}")
    # Every bf16 projection takes wgmma in prefill and skinny in decode;
    # every bf16 prefill attention and scan takes mma.
    per_pass = launches["tile_matmul"] // (1 + GEN)
    assert paths == {"wgmma": per_pass, "mma": 0, "skinny": per_pass * GEN, "ffma": 0}, paths
    for k in ("flash_attention", "ssd_scan"):
        assert by_path[k] == {"mma": launches[k], "ffma": 0}, (k, by_path[k])
    return out


def profile_steps(M, cfg, params, rehome, counters: dict) -> dict:
    """One prefill (8 x 512) and one decode step of the served model: host
    wall time without tracing (median of 3), device kernel time from a
    torch.profiler trace of one more run, their ratio as the device's busy
    share, the kernels that take the most device time, and the launches of
    the traced run."""
    from torch.profiler import ProfilerActivity, profile

    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (BATCH, PROMPT)),
                             device="cuda")
    small, logits = M.prefill(params, cfg, {"tokens": tokens})
    cache = rehome(M.init_cache(cfg, BATCH, CACHE, "cuda"), small)
    del small
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
        _zero(counters)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        launches = _read(counters)
        paths = dict(counters["tile_matmul"].paths)
        kern = _device_kernels(prof)
        wall_ms = sorted(walls)[1] * 1e3
        device_ms = sum(r[1] for r in kern)
        out[name] = dict(wall_ms=wall_ms, device_ms=device_ms,
                         busy_share=device_ms / wall_ms, launches=launches,
                         tile_matmul_paths=paths,
                         top_kernels=[dict(name=k[:90], ms=t, calls=c) for k, t, c in kern[:10]])
    return out


def parity_f32(M, cfg, rehome, prompt_len: int) -> float:
    """Full-width float32 logits of ``cfg``: kernel path on the card vs the
    plain path on the CPU, prefill of 2 x ``prompt_len`` tokens then 4
    decode steps."""
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda",
                           dtype_override=torch.float32)
    plain = _to(params, "cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, prompt_len))
    worst = 0.0
    runs = {}
    for dev, p in (("cuda", params), ("cpu", plain)):
        caches, logits = M.prefill(p, cfg, {"tokens": torch.as_tensor(tokens, device=dev)})
        cache = rehome(M.init_cache(cfg, 2, prompt_len + 8, dev, dtype=torch.float32), caches)
        runs[dev] = (p, cache, [logits.cpu()])
    for step in range(4):
        tok = torch.argmax(runs["cpu"][2][-1], dim=-1)
        for dev, (p, cache, outs) in runs.items():
            logits, _ = M.decode_step(p, cfg, cache,
                                      {"token": tok.to(dev), "cur_len": prompt_len + step})
            outs.append(logits.cpu())
    for got, want in zip(runs["cuda"][2], runs["cpu"][2]):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
        worst = max(worst, (got - want).abs().max().item())
    return worst


TRAIN_STEPS = 5


def _train_want(cfg) -> tuple[dict, dict, dict]:
    """The launches ``TRAIN_STEPS`` steps of ``cfg`` make: by kernel, by
    kernel and path (every bf16 product on wgmma, every attention and scan
    and their backward on mma), and tile_matmul's by layout."""
    n = cfg.n_layers * TRAIN_STEPS
    if cfg.name == "smollm_360m":
        # Each step: every projection forward, again where remat recomputes
        # it, once more for the SiLU gate's z (float32, no activation) and
        # its two gradient products; every attention forward twice and its
        # backward once.
        launches = {"tile_matmul": 7 * n * 4 + n, "flash_attention": 2 * n,
                    "flash_attention_bwd": n, "ssd_scan": 0, "ssd_scan_bwd": 0}
        layouts = {"x@w": 7 * n * 2 + n, "x@w^T": 7 * n, "x^T@w": 7 * n}
    else:
        # Mamba-2: six projections (no activation) forward, recomputed, and
        # their two gradient products; the scan forward twice, its backward
        # once.
        launches = {"tile_matmul": 6 * n * 4, "flash_attention": 0,
                    "flash_attention_bwd": 0, "ssd_scan": 2 * n, "ssd_scan_bwd": n}
        layouts = {"x@w": 6 * n * 2, "x@w^T": 6 * n, "x^T@w": 6 * n}
    by_path = {k: ({"wgmma": v, "mma": 0, "skinny": 0, "ffma": 0} if k == "tile_matmul"
                   else {"mma": v, "ffma": 0}) for k, v in launches.items()}
    return launches, by_path, layouts


def train_path(train, cfg, counters: dict) -> tuple[dict, dict]:
    """Train full-width, full-depth ``cfg`` for ``TRAIN_STEPS`` steps of
    8 x 512 cyclic tokens through ``train`` (seed 0, bf16, float32 AdamW
    moments, remat "nothing"), every launch count set to 0 just before and
    read just after. A step's time is the host clock between two of its log
    lines (each step ends by reading its loss to the host); the median of
    steps 2-5 gives tokens/s."""
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    res = train(cfg.name, reduced=False, steps=TRAIN_STEPS, batch=BATCH, seq=PROMPT,
                data_mode="cyclic", ckpt_every=0, resume=False, seed=0, device="cuda",
                ckpt_dir=str(ROOT / "build" / "chip_smoke_train"),
                log=lambda line: (stamps.append(time.perf_counter()), print(line)))
    launches = _read(counters)
    by_path = {k: dict(fn.paths) for k, fn in counters.items() if hasattr(fn, "paths")}
    layouts = dict(counters["tile_matmul"].layouts)
    peak = torch.cuda.max_memory_allocated()
    losses = res["losses"]
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    steps_s = np.diff([t0] + stamps)
    median = float(np.median(steps_s[1:]))
    out = dict(arch=cfg.name, batch=BATCH, seq=PROMPT, steps=TRAIN_STEPS, losses=losses,
               step_s=steps_s.tolist(), median_step_s=median,
               tokens_per_s=BATCH * PROMPT / median, peak_mem_bytes=peak,
               launches=launches, launches_by_path=by_path, tile_matmul_layouts=layouts,
               watchdog=res["watchdog"])
    print(f"train {cfg.name}: losses {losses}, median step {median:.4f} s "
          f"({out['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}, by path {by_path}, tile_matmul layouts {layouts}")
    want, want_paths, want_layouts = _train_want(cfg)
    assert launches == want, (launches, want)
    assert layouts == want_layouts, (layouts, want_layouts)
    assert by_path == want_paths, (by_path, want_paths)
    return out, res


def profile_train_step(steps_mod, cfg, res, counters: dict) -> dict:
    """One more train step from ``train``'s final state: host wall time
    without tracing (median of 3), device kernel time from a torch.profiler
    trace of a fourth, their ratio as the busy share, the top kernels, and
    the host's top operations by their own time (traced, so inflated)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.optim.optimizer import OptConfig

    opt = OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=TRAIN_STEPS, weight_decay=0.0)
    step = steps_mod.make_train_step(cfg, opt)
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=BATCH, seq=PROMPT,
                                         mode="cyclic")).batch_at(TRAIN_STEPS)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    params, opt_state = res["params"], res["opt_state"]
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        walls.append(time.perf_counter() - t0)
    _zero(counters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    kern = _device_kernels(prof)
    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:10]
    wall_ms = sorted(walls)[1] * 1e3
    device_ms = sum(r[1] for r in kern)
    return dict(wall_ms=wall_ms, device_ms=device_ms, busy_share=device_ms / wall_ms,
                launches=_read(counters),
                top_kernels=[dict(name=k[:90], ms=t, calls=c) for k, t, c in kern[:12]],
                top_host=[dict(name=e.key[:60], self_ms=e.self_cpu_time_total / 1e3,
                               calls=e.count) for e in host])


def parity_train_f32(M, steps_mod, cfg) -> dict:
    """One float32 train step of full-width ``cfg`` cut to 4 layers, batch
    2 x 128: the kernel path on the card against the plain path on the CPU,
    from the same seeded weights and batch. Loss and grad norm at 1e-3 (the
    logits' bar). The gradients, read back from the first moment (after one
    step from zero, m = 0.1 x the clipped gradient), within 1e-3 of each
    tensor's largest entry. The updated weights within half the learning
    rate: Adam's first step moves a weight by lr g / (|g| + 1e-8), which
    turns the two devices' float32 rounding of a gradient entry near 1e-8
    into a visible part of lr; the gradient check above is the close one."""
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.optim.optimizer import OptConfig, init_opt_state, tree_leaves

    pcfg = dataclasses.replace(cfg, n_periods=4, param_dtype="float32")
    opt = OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=TRAIN_STEPS, weight_decay=0.0)
    params = M.init_params(pcfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    batch = TokenPipeline(PipelineConfig(vocab=cfg.vocab, batch=2, seq=128,
                                         mode="cyclic")).batch_at(0)
    step = steps_mod.make_train_step(pcfg, opt)
    runs = {}
    for dev in ("cuda", "cpu"):
        p = _to(params, dev)
        runs[dev] = step(p, init_opt_state(p, opt), {k: torch.as_tensor(v, device=dev)
                                                     for k, v in batch.items()})
    (pg, sg, mg), (pc, sc, mc) = runs["cuda"], runs["cpu"]
    lr = mc["lr"]
    assert abs(mg["loss"] - mc["loss"]) <= 1e-3, (mg, mc)
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-3 * max(1.0, mc["grad_norm"]), (mg, mc)
    grad_err = 0.0
    for a, b in zip(tree_leaves(sg["m"]), tree_leaves(sc["m"])):
        err = (a.cpu() - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        grad_err = max(grad_err, err)
    param_err = max((a.cpu() - b).abs().max().item()
                    for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
    out = dict(loss_gpu=mg["loss"], loss_cpu=mc["loss"], grad_norm_gpu=mg["grad_norm"],
               grad_norm_cpu=mc["grad_norm"], lr=lr, max_grad_err_rel=grad_err,
               max_param_err=param_err, max_param_err_in_lr=param_err / lr)
    assert grad_err <= 1e-3, out
    assert param_err <= 0.5 * lr, out
    return out


# The ACAN path: full-width, full-depth smollm_360m trained by the paper's
# runtime, each microbatch gradient one task of a Manager/Handler plane over
# the tuple space (4 x 2 x 512 = 4096 tokens a step, train_path's 8 x 512).
ACAN = dict(n_handlers=4, n_micro=4, micro_batch=2, seq=PROMPT, steps=6, lr=0.05,
            data_mode="cyclic", ts_backend="checked+local")
ACAN_KERNELS = ("tile_matmul", "flash_attention", "flash_attention_bwd")


def _acan_runner(step_runner, cfg, params, **kw):
    """A runner whose space starts from ``params`` (its setup then puts none)."""
    runner = step_runner.ACANStepRunner(cfg, step_runner.ACANTrainConfig(**(ACAN | kw)))
    runner.ts.put(("params", 0), params)
    return runner


def _acan_run(runner, counters: dict) -> tuple:
    """``runner.run()`` with every launch count set to 0 just before and read
    just after; also each step's host seconds (``step_seconds``), and the
    seconds of the pouch rounds that ended at their deadline with a task
    unfinished."""
    from repro_torch.core.space import ANY
    from repro_torch.ts_exec.step_runner import step_seconds

    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.time()
    res = runner.run()
    launches = _read(counters)
    by_path = {k: dict(fn.paths) for k, fn in counters.items() if hasattr(fn, "paths")}
    steps_s = step_seconds(runner, t0)
    rounds = [runner.ts.try_read(k)[1] for k in runner.ts.keys(("thist", ANY, ANY))]
    waited = sum(r["elapsed"] for r in rounds if r["done_frac"] < 1.0)
    return res, launches, by_path, steps_s, waited


def acan_path(step_runner, M, cfg, counters: dict) -> dict:
    """Train full-width, full-depth ``cfg`` (bf16) through the ACAN runner
    twice from the same seeded weights: without crashes, then with a
    handler crash probability of 0.25. Both commit every version once, give
    the same losses and final weights bit for bit, break no tuple-space
    protocol rule and leak nothing; the crash-free run re-issues nothing.
    Each kernel's launches are a whole multiple (the same for all three) of
    one microbatch gradient's, measured first on this thread, and at least
    n_micro x steps of them, all on the tensor-core paths. A step's time is
    the host clock between two committed versions; the median of steps 2-6
    gives tokens/s."""
    from repro_torch.core.space import find_checked
    from repro_torch.optim.optimizer import tree_leaves

    steps, n_micro = ACAN["steps"], ACAN["n_micro"]
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    clean = _acan_runner(step_runner, cfg, params, handler_crash_prob=0.0)
    _zero(counters)
    clean.warm_up()
    torch.cuda.synchronize()
    per_grad = _read(counters)
    want = {k: v // TRAIN_STEPS for k, v in _train_want(cfg)[0].items()}
    assert per_grad == want, (per_grad, want)
    torch.cuda.reset_peak_memory_stats()
    res, launches, by_path, steps_s, waited_clean = _acan_run(clean, counters)
    peak = torch.cuda.max_memory_allocated()
    crashed = _acan_runner(step_runner, cfg, params, handler_crash_prob=0.25)
    res_c, launches_c, by_path_c, steps_c, waited = _acan_run(crashed, counters)
    final = [tree_leaves(r.ts.try_read(("params", steps))[1]) for r in (clean, crashed)]
    median = float(np.median(steps_s[1:]))
    tokens = n_micro * ACAN["micro_batch"] * ACAN["seq"]
    out = dict(arch=cfg.name, **ACAN, losses=res.losses, losses_crash=res_c.losses,
               reissues=res.reissues, crashes=res.crashes, reissues_crash=res_c.reissues,
               crashes_crash=res_c.crashes, param_versions=[res.param_versions,
                                                            res_c.param_versions],
               ts_violations=[res.ts_violations, res_c.ts_violations],
               ts_leaks=[res.ts_leaks, res_c.ts_leaks], step_s=steps_s,
               median_step_s=median, tokens_per_s=tokens / median, step_s_crash=steps_c,
               timeout_wait_s=waited, timeout_wait_s_clean=waited_clean,
               peak_mem_bytes=peak, launches_per_grad=per_grad, launches=launches,
               launches_by_path=by_path, launches_crash=launches_c,
               launches_by_path_crash=by_path_c)
    print(f"acan {cfg.name}: losses {res.losses}, crash run losses {res_c.losses}; "
          f"crash-free run {res.crashes} crashes, {res.reissues} re-issues; crash run "
          f"{res_c.crashes} crashes, {res_c.reissues} re-issues, {waited:.3f} s of "
          f"rounds ended at their deadline; median step (2-{steps}) {median:.4f} s "
          f"({out['tokens_per_s']:.0f} tokens/s), steps {steps_s}; peak memory "
          f"{peak / 2**30:.3f} GiB; launches a gradient {per_grad}, crash-free run "
          f"{launches}, by path {by_path}; crash run {launches_c}")
    out["violation_samples"] = [find_checked(r.ts.backend).protocol_report()["violation_samples"]
                                for r in (clean, crashed)]
    for r in (res, res_c):
        assert r.param_versions == steps, out
        assert r.ts_violations == 0 and r.ts_leaks == {}, out
        assert len(r.losses) == steps and all(np.isfinite(r.losses)), out
    assert res.reissues == 0 and res.crashes == 0, out
    assert res_c.crashes + res_c.reissues >= 1, out
    assert res_c.losses == res.losses, out
    assert all(torch.equal(a, b) for a, b in zip(*final)), "crash run's weights differ"
    for run, paths in ((launches, by_path), (launches_c, by_path_c)):
        grads = {k: run[k] // per_grad[k] for k in ACAN_KERNELS}
        assert all(run[k] % per_grad[k] == 0 for k in ACAN_KERNELS), (run, per_grad)
        assert len(set(grads.values())) == 1 and grads["tile_matmul"] >= n_micro * steps, grads
        assert run["ssd_scan"] == run["ssd_scan_bwd"] == 0, run
        assert paths["tile_matmul"]["ffma"] == paths["tile_matmul"]["skinny"] == 0, paths
        assert paths["flash_attention"]["ffma"] == paths["flash_attention_bwd"]["ffma"] == 0
    return out


def profile_acan_step(step_runner, M, cfg, counters: dict, median_step_s: float) -> dict:
    """One ACAN step (a runner of one step, warmed first) traced by
    torch.profiler: its device kernel time over the untraced median step
    as the busy share, and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    runner = _acan_runner(step_runner, cfg, params, steps=1)
    runner.warm_up()
    torch.cuda.synchronize()
    _zero(counters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = runner.run()
        torch.cuda.synchronize()
    assert res.param_versions == 1, res
    kern = _device_kernels(prof)
    device_ms = sum(r[1] for r in kern)
    return dict(device_ms=device_ms, wall_ms=median_step_s * 1e3,
                busy_share=device_ms / (median_step_s * 1e3), launches=_read(counters),
                top_kernels=[dict(name=k[:90], ms=t, calls=c) for k, t, c in kern[:10]])


def parity_acan_f32(step_runner, M, cfg) -> dict:
    """The ACAN runner in float32 on full-width ``cfg`` cut to 4 layers
    (2 handlers, 2 microbatches of 2 x 128 tokens, 3 steps) on the card
    and on the CPU from the same seeded weights: losses within 1e-3, the
    bar of parity_train_f32, and the final weights within 1e-3 of the
    largest distance a weight moved on the CPU (the relative bar of
    parity_train_f32's gradients): a wrong mean or update on the card
    misses a weight by about as much as the update itself."""
    from repro_torch.optim.optimizer import tree_leaves

    pcfg = dataclasses.replace(cfg, n_periods=4, param_dtype="float32")
    params = M.init_params(pcfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    runs = {}
    for dev in ("cuda", "cpu"):
        runner = step_runner.ACANStepRunner(pcfg, step_runner.ACANTrainConfig(
            n_handlers=2, n_micro=2, micro_batch=2, seq=128, steps=3, lr=0.05,
            ts_backend="checked+local"), device=dev)
        runner.ts.put(("params", 0), _to(params, dev))
        res = runner.run()
        assert res.param_versions == 3 and res.ts_violations == 0, res
        runs[dev] = (res.losses, tree_leaves(runner.ts.try_read(("params", 3))[1]))
    (lg, pg), (lc, pc) = runs["cuda"], runs["cpu"]
    err = max(abs(a - b) for a, b in zip(lg, lc))
    param_err = max((a.cpu() - b).abs().max().item() for a, b in zip(pg, pc))
    moved = max((b - a.cpu()).abs().max().item() for a, b in zip(tree_leaves(params), pc))
    out = dict(losses_gpu=lg, losses_cpu=lc, max_loss_err=err, max_param_err=param_err,
               max_moved_cpu=moved, max_param_err_in_moved=param_err / moved)
    assert err <= 1e-3, out
    assert param_err <= 1e-3 * moved, out
    return out


# The paper's §6 MLP on the card: N = 256 -> 256 -> 1, its forward and
# backward tile products through tile_matmul in float32, each launch
# SKINNY_MAX_M rows (the skinny path; ffma where N = 1); then the three
# experiments, the float32 card-against-CPU parity, and a two-tenant cloud
# with full-width smollm_360m beside the MLP.
MLP_TOL = 2e-4
MLP_CASES = (("paper", ((256, 256), (256, 1)), 256.0),   # 16 x 16 tiles
             ("ragged", ((40, 24), (24, 1)), 12.0))       # (2|3) x (1|2) tiles
MLP_BATCH = 16                                            # CloudConfig.handler_batch
MLP_PRODUCTS = {"forward": "fwd", "backward": "bwd"}


def _mlp_spaces(layers) -> dict:
    """A tuple space on the card and one on the CPU holding, for data_id 0,
    every tuple the forward and backward op bodies read: seeded numpy,
    float32."""
    from repro_torch.core.space import TupleSpace

    rng = np.random.default_rng(0)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    tuples = {("x", 0): f(layers[0].n_in)}
    for l, spec in enumerate(layers):
        tuples |= {("w", l): f(spec.n_out, spec.n_in) / np.float32(spec.n_in ** 0.5),
                   ("dy", l, 0): f(spec.n_out)}
        if l + 1 < len(layers):
            tuples[("act", l, 0)] = np.tanh(f(spec.n_out))
    spaces = {}
    for dev in ("cuda", "cpu"):
        spaces[dev] = TupleSpace()
        for k, v in tuples.items():
            spaces[dev].put(k, torch.tensor(v, device=dev))
    return spaces


def _mlp_time(tm_kernel, tile_matmul_ref, k: int, n: int) -> dict:
    """One launch of the MLP's shape (16 masked rows of K, times (K, N)):
    kernel, plain version and torch.matmul by CUDA events, both also by
    graph replay; the bound of the dense product the launch computes."""
    m = tm_kernel.SKINNY_MAX_M
    rows = _randn((m, k), torch.float32, 30 + k)
    w = _randn((k, n), torch.float32, 31 + n, k ** -0.5)
    fn = tm_kernel.tile_matmul
    flops, nbytes = 2 * m * k * n, (m * k + k * n + m * n) * 4
    bound_ms, bound_by = _bound(flops, nbytes, torch.float32)
    return dict(shape=(m, k, n), path=tm_kernel.choose_path(m, n, k, torch.float32, True),
                ms=_time_ms(lambda: fn(rows, w), iters=200),
                device_ms=_graph_ms(lambda: fn(rows, w), iters=200),
                plain_ms=_time_ms(lambda: tile_matmul_ref(rows, w), iters=200),
                library_ms=_time_ms(lambda: torch.matmul(rows, w), iters=200),
                library_device_ms=_graph_ms(lambda: torch.matmul(rows, w), iters=200),
                flops=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)


def check_mlp_ops(tm_kernel, tile_matmul_ref) -> dict:
    """The MLP's forward and backward op bodies on the card against the
    plain bodies on the CPU (float32, 2e-4), on the paper's width (16 x 16
    tiles, handler batches of 16) and on a ragged layer pair (four tile
    shapes in one batch); every task run alone gives the bits it gave
    inside its batch. Then one launch of each of the paper's product
    shapes timed beside torch.matmul."""
    from repro_torch.core.executor import ExecContext
    from repro_torch.core.program import GLOBAL_OPS
    from repro_torch.programs import mlp

    fn = tm_kernel.tile_matmul
    before = dict(fn.paths)
    err, tasks_run = {}, {}
    for name, dims, cap in MLP_CASES:
        layers = [mlp.LayerSpec(*d) for d in dims]
        ctx = {dev: ExecContext(ts, {"lr": 0.002}) for dev, ts in _mlp_spaces(layers).items()}
        for op, stage in MLP_PRODUCTS.items():
            body = GLOBAL_OPS.resolve(op).batch_fn
            for l in range(len(layers)):
                tasks = [p for t in mlp.prototype_tasks(layers, 0, 0)[f"{stage}_{l}"]
                         for p in GLOBAL_OPS.partition(t, cap)]
                tasks_run[f"{name} {stage}_{l}"] = len(tasks)
                e = 0.0
                for c in range(0, len(tasks), MLP_BATCH):
                    batch = tasks[c:c + MLP_BATCH]
                    got = dict(body(ctx["cuda"], batch))
                    want = dict(body(ctx["cpu"], batch))
                    assert got.keys() == want.keys()
                    for k, v in got.items():
                        assert v.is_cuda and v.dtype == torch.float32, k
                        e = max(e, (v.cpu() - want[k]).abs().max().item())
                    for t in batch:
                        for k, v in body(ctx["cuda"], [t]):
                            assert torch.equal(v, got[k]), ("alone != in its batch", k)
                err[f"{name} {stage}_{l}"] = e
    launched = {p: fn.paths[p] - before[p] for p in fn.paths}
    times = {f"{k}x{n}": _mlp_time(tm_kernel, tile_matmul_ref, k, n)
             for k, n in ((256, 256), (256, 1), (1, 256))}
    out = dict(max_abs_err=err, tasks=tasks_run, launches_by_path=launched, times=times)
    assert max(err.values()) <= MLP_TOL, err
    assert launched["skinny"] > 0 and launched["ffma"] > 0, launched
    assert launched["wgmma"] == launched["mma"] == 0, launched
    return out


def _cloud_run(cloud, counters: dict) -> tuple:
    """``cloud.run()`` with every launch count set to 0 just before and read
    just after: (result, wall s, launches, launches by path)."""
    torch.cuda.synchronize()
    _zero(counters)
    t0 = time.perf_counter()
    res = cloud.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (res, wall, _read(counters),
            {k: dict(fn.paths) for k, fn in counters.items() if hasattr(fn, "paths")})


def _final_weights(cloud) -> list:
    return [cloud.ts.try_read((name, l))[1] for l in range(2) for name in ("w", "b")]


def _mlp_summary(res, wall: float, launches: dict, by_path: dict, epochs: int) -> dict:
    losses = [loss for _, loss in res.loss_history]
    n = len(losses) // epochs
    return dict(rounds=len(losses), mse_epoch_means=[float(np.mean(losses[i * n:(i + 1) * n]))
                                                     for i in range(epochs)],
                manager_revivals=res.manager_revivals, handler_revivals=res.handler_revivals,
                speed_changes=res.speed_changes, ledger_ok=res.ledger_ok, pouches=res.pouches,
                ts_violations=res.ts_violations, ts_leaks=res.ts_leaks, wall_s=wall,
                launches=launches, launches_by_path=by_path, losses=losses)


def paper_path(counters: dict) -> dict:
    """The paper's three experiments at its width (N = 256, task cap 256,
    pouch 100, 4 handler threads) through ``repro_torch.configs.paper_mlp``
    on a ``checked+local`` space, on the card: exp 1 on 20 samples (the
    paper's 100 cut to keep the script's time) for 2 epochs, exp 2 and exp 3
    on their own 20, and exp 3's config without faults. Exp 1's second
    epoch beats its first; exp 3 survives Manager and Handler crashes with
    the crash-free run's losses and weights bit for bit; no run breaks a
    protocol rule, leaks or breaks its ledger; every MLP product launched
    tile_matmul (skinny or ffma) and nothing else ran."""
    from repro_torch.configs import paper_mlp
    from repro_torch.core import ACANCloud, FaultPlan

    cfgs = {"exp1": paper_mlp.feasibility_config(epochs=2, n_samples=20, device="cuda"),
            "exp2": paper_mlp.adaptability_config(device="cuda"),
            "exp3": paper_mlp.robustness_config(device="cuda"),
            "exp3_no_faults": paper_mlp.robustness_config(device="cuda")}
    cfgs["exp3_no_faults"].fault_plan = FaultPlan(interval=1e9)
    out, weights = {}, {}
    for name, cfg in cfgs.items():
        cfg.ts_backend = "checked+local"
        cloud = ACANCloud(cfg)
        res, wall, launches, by_path = _cloud_run(cloud, counters)
        rec = out[name] = _mlp_summary(res, wall, launches, by_path, cfg.epochs)
        weights[name] = _final_weights(cloud)
        if name == "exp2":
            t, p = (np.array([h[i] for h in res.timeout_history]) for i in (1, 2))
            rec["corr_timeout_power"] = float(np.corrcoef(t[p > 0], p[p > 0])[0, 1])
        assert rec["rounds"] == cfg.epochs * cfg.n_samples, rec
        assert rec["ledger_ok"] and rec["ts_violations"] == 0 and rec["ts_leaks"] == {}, rec
        assert all(w.is_cuda and w.dtype == torch.float32 for w in weights[name]), name
        assert launches["tile_matmul"] > 0 and all(
            launches[k] == 0 for k in launches if k != "tile_matmul"), launches
        tm = by_path["tile_matmul"]
        assert tm["skinny"] > 0 and tm["ffma"] > 0 and tm["wgmma"] == tm["mma"] == 0, tm
    e1, e3, e3c = out["exp1"], out["exp3"], out["exp3_no_faults"]
    assert e1["mse_epoch_means"][1] < e1["mse_epoch_means"][0], e1["mse_epoch_means"]
    assert e1["manager_revivals"] == 0, e1
    assert e3["manager_revivals"] > 0 and e3["handler_revivals"] > 0, e3
    assert e3c["manager_revivals"] == e3c["handler_revivals"] == 0, e3c
    assert e3["losses"] == e3c["losses"], "exp 3's losses differ from its crash-free run's"
    assert all(torch.equal(a, b) for a, b in zip(weights["exp3"], weights["exp3_no_faults"]))
    out["launches"] = {k: sum(out[e]["launches"][k] for e in cfgs) for k in counters}
    out["launches_by_path"] = {k: {p: sum(out[e]["launches_by_path"][k][p] for e in cfgs)
                                   for p in counters[k].paths} for k in counters}
    return out


def parity_mlp_f32() -> dict:
    """Exp 1 at the paper's width for 10 rounds (one epoch of 10 samples)
    on the card and on the CPU: loss history and final weights within 1e-4
    relative (the weights relative to each tensor's largest entry)."""
    from repro_torch.configs import paper_mlp
    from repro_torch.core import ACANCloud

    runs = {}
    for dev in ("cuda", "cpu"):
        cloud = ACANCloud(paper_mlp.feasibility_config(epochs=1, n_samples=10, device=dev))
        res = cloud.run()
        runs[dev] = ([loss for _, loss in res.loss_history],
                     [w.cpu() for w in _final_weights(cloud)])
    (lg, wg), (lc, wc) = runs["cuda"], runs["cpu"]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    w_err = max((a - b).abs().max().item() / b.abs().max().item() for a, b in zip(wg, wc))
    out = dict(rounds=len(lg), losses_gpu=lg, losses_cpu=lc, max_loss_rel_err=loss_err,
               max_weight_err_rel=w_err)
    assert len(lg) == len(lc) == 10, out
    assert loss_err <= 1e-4 and w_err <= 1e-4, out
    return out


def cloud_tenants(counters: dict) -> dict:
    """One ACANCloud running the paper's MLP (1 epoch of 8 samples) beside
    full-width, full-depth smollm_360m trained by ``TorchSGDProgram`` (3
    steps of 4 microbatch gradients of 2 x 512 tokens), on 4 shared handler
    threads (at most one gradient a handler batch), under Manager and
    Handler crashes at p = 0.5 every 3 gradients' time (measured first).
    The kernels are built and warmed before ``run()``. The MLP keeps its
    single-tenant trajectory and the smollm tenant a crash-free run's
    losses, bit for bit; no protocol violation and no leak."""
    from repro_torch.configs import paper_mlp
    from repro_torch.configs.base import get_config
    from repro_torch.core import ACANCloud, FaultPlan, MLPProgram
    from repro_torch.core.space import TupleSpace
    from repro_torch.programs.torch_sgd import TorchSGDProgram

    scfg = get_config("smollm_360m")
    sgd = dict(steps=3, n_micro=4, micro_batch=2, seq=PROMPT, lr=0.05, seed=0, device="cuda")
    base = paper_mlp.feasibility_config(epochs=1, n_samples=8, device="cuda")
    base.initial_timeout = 5.0
    base.ts_backend = "checked+local"
    base.tenant_caps = {"torch_sgd": 1}

    # Warm: one microbatch gradient from the tenant's own initial params.
    probe = TorchSGDProgram(scfg, **sgd)
    ts = TupleSpace()
    probe.setup(ts)
    params = ts.try_read(("params", 0))[1]
    grad_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probe.grad(params, probe.batch(0, 0))
        torch.cuda.synchronize()
        grad_s.append(time.perf_counter() - t0)
    del probe, ts, params
    interval = max(3 * max(grad_s[1:]), 0.5)

    def mlp_prog():
        return MLPProgram(base.layers, epochs=base.epochs, n_samples=base.n_samples,
                          seed=base.seed, device="cuda")

    runs = {}
    for name, plan, progs in (
            ("mlp_alone", FaultPlan(interval=1e9), lambda: [mlp_prog()]),
            ("smollm_alone", FaultPlan(interval=1e9), lambda: [TorchSGDProgram(scfg, **sgd)]),
            ("both_with_crashes", FaultPlan(interval=interval, p_handler_crash=0.5,
                                            p_manager_crash=0.5, seed=4),
             lambda: [mlp_prog(), TorchSGDProgram(scfg, **sgd)])):
        cfg = dataclasses.replace(base, fault_plan=plan)
        programs = progs()
        if len(programs) == 1:
            cfg.tenant_caps = None
            cloud = ACANCloud(cfg, program=programs[0])
        else:
            cloud = ACANCloud(cfg, programs=programs)
        torch.cuda.reset_peak_memory_stats()
        res, wall, launches, by_path = _cloud_run(cloud, counters)
        per = res.per_program if len(programs) > 1 else {programs[0].name: res}
        runs[name] = dict(
            losses={ns: [loss for _, loss in r.loss_history] for ns, r in per.items()},
            manager_revivals={ns: r.manager_revivals for ns, r in per.items()},
            handler_revivals=res.handler_revivals, speed_changes=res.speed_changes,
            ledger_ok=res.ledger_ok, ts_violations=res.ts_violations, ts_leaks=res.ts_leaks,
            wall_s=wall, peak_mem_bytes=torch.cuda.max_memory_allocated(),
            launches=launches, launches_by_path=by_path)
        del cloud, programs, res, per
        torch.cuda.empty_cache()
    both = runs["both_with_crashes"]
    out = dict(grad_s=grad_s, fault_interval_s=interval, **runs,
               launches=both["launches"], launches_by_path=both["launches_by_path"])
    for r in runs.values():
        assert r["ledger_ok"] and r["ts_violations"] == 0 and r["ts_leaks"] == {}, r
    assert both["losses"]["mlp"] == runs["mlp_alone"]["losses"]["mlp"], out
    assert both["losses"]["torch_sgd"] == runs["smollm_alone"]["losses"]["torch_sgd"], out
    assert len(both["losses"]["mlp"]) == 8 and len(both["losses"]["torch_sgd"]) == 3, out
    assert all(np.isfinite(both["losses"]["torch_sgd"])), out
    assert sum(both["manager_revivals"].values()) + both["handler_revivals"] > 0, out
    tm = both["launches_by_path"]["tile_matmul"]
    assert tm["skinny"] > 0 and tm["ffma"] > 0 and tm["wgmma"] > 0, tm
    assert both["launches"]["flash_attention"] > 0 and both["launches"]["flash_attention_bwd"] > 0
    return out


def _record(phase: str, out: dict) -> None:
    """One phase's record: a JSON object on a line of its own."""
    print(json.dumps({"phase": phase} | out, default=str))


def _print_profile(arch: str, prof: dict) -> None:
    for phase, p in prof.items():
        print(f"profile {arch} {phase}: wall {p['wall_ms']:.3f} ms, device kernels "
              f"{p['device_ms']:.3f} ms, busy share {p['busy_share']:.3f}, "
              f"launches {p['launches']}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU host", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_ref)
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.ssd_scan.ops import ssd_plain, ssd_plain_bwd
    from repro_torch.kernels.tile_matmul import kernel as tm_kernel
    from repro_torch.kernels.tile_matmul.ref import tile_matmul_ref
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.serve import rehome, serve
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.ts_exec import step_runner

    counters = {"tile_matmul": tm_kernel.tile_matmul,
                "flash_attention": fa_kernel.flash_attention,
                "flash_attention_bwd": fa_kernel.flash_attention_bwd,
                "ssd_scan": ssd_kernel.ssd_scan,
                "ssd_scan_bwd": ssd_kernel.ssd_scan_bwd}

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
    detail["kernel_build"] = kernel_build_report(_build, detail["ptxas"])
    for k, rep in detail["kernel_build"].items():
        print(f"{k} build: {rep}")

    # 3. Each kernel against its plain version at the paths' shapes.
    detail["tile_matmul_err"] = check_tile_matmul(tm_kernel, tile_matmul_ref)
    detail["flash_attention_err"] = check_flash(fa_kernel, flash_attention_ref)
    detail["ssd_scan_err"] = check_ssd(ssd_kernel, ssd_plain)
    detail["tile_matmul_grad_err"] = check_tile_matmul_grad(tm_kernel, tile_matmul_ref)
    detail["flash_attention_bwd_err"] = check_flash_bwd(fa_kernel, flash_attention_ref,
                                                        flash_attention_bwd_ref)
    detail["ssd_scan_bwd_err"] = check_ssd_bwd(ssd_kernel, ssd_plain_bwd)
    detail["mlp_ops"] = check_mlp_ops(tm_kernel, tile_matmul_ref)
    _record("check_mlp_ops", detail["mlp_ops"])
    print(f"checks: tile_matmul max |err| {detail['tile_matmul_err']}, "
          f"flash_attention max |err| {detail['flash_attention_err']}, "
          f"ssd_scan max |err| {detail['ssd_scan_err']}, "
          f"tile_matmul dx/dw max |err| {detail['tile_matmul_grad_err']}, "
          f"flash_attention_bwd max |err| {detail['flash_attention_bwd_err']}, "
          f"ssd_scan_bwd max |err| / max |grad| {detail['ssd_scan_bwd_err']}")

    # 4. Times: kernel, plain version, one PyTorch call as yardstick.
    detail["tile_matmul_time"] = time_tile_matmul(tm_kernel, tile_matmul_ref)
    detail["flash_attention_time"] = time_flash(fa_kernel, flash_attention_ref)
    detail["ssd_scan_time"] = time_ssd(ssd_kernel, ssd_plain)
    detail["tile_matmul_grad_time"] = time_tile_matmul_grad(tm_kernel, tile_matmul_ref)
    detail["flash_attention_bwd_time"] = time_flash_bwd(fa_kernel, flash_attention_bwd_ref)
    detail["tile_matmul_grad_mamba2_time"] = time_tile_matmul_grad(tm_kernel, tile_matmul_ref,
                                                                   "mamba2_2_7b")
    detail["ssd_scan_bwd_time"] = time_ssd_bwd(ssd_kernel, ssd_plain_bwd)
    for k in ("tile_matmul", "flash_attention", "ssd_scan", "tile_matmul_grad",
              "flash_attention_bwd", "tile_matmul_grad_mamba2", "ssd_scan_bwd"):
        print(f"times (ms): {k} {detail[k + '_time']}")

    # 5. Path 1: serve full-width smollm_360m from seeded random weights.
    cfg = get_config("smollm_360m")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    sm = detail["serve"] = serve_path(serve, M, cfg, params, counters)
    assert sm["launches"] == {"tile_matmul": 7 * cfg.n_layers * (1 + GEN),
                              "flash_attention": cfg.n_layers, "flash_attention_bwd": 0,
                              "ssd_scan": 0, "ssd_scan_bwd": 0}, sm["launches"]
    detail["profile"] = profile_steps(M, cfg, params, rehome, counters)
    _print_profile(cfg.name, detail["profile"])
    del params
    detail["parity_f32_max_err"] = parity_f32(M, cfg, rehome, 128)
    print(f"parity f32 smollm_360m full depth: max |logit err| "
          f"{detail['parity_f32_max_err']:.3e}")
    torch.cuda.empty_cache()

    # 6. Path 2: serve full-width, full-depth mamba2_2_7b: six tile_matmul
    # projections a layer each forward pass, one ssd_scan a layer in prefill.
    mcfg = get_config("mamba2_2_7b")
    params = M.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    ms = detail["serve_mamba2"] = serve_path(serve, M, mcfg, params, counters)
    assert ms["launches"] == {"tile_matmul": 6 * mcfg.n_layers * (1 + GEN),
                              "flash_attention": 0, "flash_attention_bwd": 0,
                              "ssd_scan": mcfg.n_layers, "ssd_scan_bwd": 0}, ms["launches"]
    prof = detail["profile_mamba2"] = profile_steps(M, mcfg, params, rehome, counters)
    _print_profile(mcfg.name, prof)
    assert prof["prefill"]["launches"]["ssd_scan"] == mcfg.n_layers, prof
    assert prof["decode"]["launches"]["ssd_scan"] == 0, prof
    del params
    torch.cuda.empty_cache()
    pcfg = dataclasses.replace(mcfg, n_periods=MAMBA_PARITY_LAYERS)
    detail["parity_f32_mamba2_max_err"] = parity_f32(M, pcfg, rehome, 200)
    print(f"parity f32 mamba2_2_7b full width, {MAMBA_PARITY_LAYERS} layers: max |logit err| "
          f"{detail['parity_f32_mamba2_max_err']:.3e}")
    torch.cuda.empty_cache()

    # 7. Path 3: train full-width, full-depth smollm_360m through ``train``.
    # 8. Path 4: the same for full-width, full-depth mamba2_2_7b.
    trains = {}
    for key, tcfg in (("", cfg), ("_mamba2", mcfg)):
        tr, res = train_path(train, tcfg, counters)
        detail["train" + key] = tr
        prof = detail["profile_train" + key] = profile_train_step(steps_mod, tcfg, res,
                                                                  counters)
        print(f"profile {tcfg.name} train step: wall {prof['wall_ms']:.3f} ms, device "
              f"kernels {prof['device_ms']:.3f} ms, busy share {prof['busy_share']:.3f}, "
              f"launches {prof['launches']}, top {prof['top_kernels'][:5]}")
        assert prof["launches"] == {k: v // TRAIN_STEPS
                                    for k, v in _train_want(tcfg)[0].items()}, prof["launches"]
        trains[tcfg.name] = tr
        del res
        torch.cuda.empty_cache()
        detail["parity_train_f32" + key] = parity_train_f32(M, steps_mod, tcfg)
        print(f"parity f32 train step {tcfg.name} full width, 4 layers: "
              f"{detail['parity_train_f32' + key]}")
        torch.cuda.empty_cache()
    tr, mt = trains[cfg.name], trains[mcfg.name]

    # 9. Path 5: train full-width, full-depth smollm_360m through the ACAN
    # runner (Manager and Handler threads over the tuple space), with and
    # without handler crashes; one step profiled; float32 against the CPU.
    ac = detail["acan"] = acan_path(step_runner, M, cfg, counters)
    torch.cuda.empty_cache()
    prof = detail["profile_acan"] = profile_acan_step(step_runner, M, cfg, counters,
                                                      ac["median_step_s"])
    print(f"profile {cfg.name} acan step: device kernels {prof['device_ms']:.3f} ms, "
          f"busy share {prof['busy_share']:.3f} of the {prof['wall_ms']:.3f} ms median "
          f"step, launches {prof['launches']}, top {prof['top_kernels'][:5]}")
    assert all(prof["launches"][k] % ac["launches_per_grad"][k] == 0
               and prof["launches"][k] >= ACAN["n_micro"] * ac["launches_per_grad"][k]
               for k in ACAN_KERNELS), prof["launches"]
    torch.cuda.empty_cache()
    detail["parity_acan_f32"] = parity_acan_f32(step_runner, M, cfg)
    print(f"parity f32 acan {cfg.name} full width, 4 layers: {detail['parity_acan_f32']}")
    torch.cuda.empty_cache()

    # 10. Path 6: the paper's three experiments at its width, the MLP's tile
    # products through tile_matmul (float32 skinny / ffma); the float32 MLP
    # against the CPU's; the MLP and full-width smollm_360m as two tenants of
    # one cloud under Manager and Handler crashes.
    pp = detail["paper"] = paper_path(counters)
    _record("paper_path", pp)
    detail["parity_mlp_f32"] = parity_mlp_f32()
    _record("parity_mlp_f32", detail["parity_mlp_f32"])
    ct = detail["cloud_tenants"] = cloud_tenants(counters)
    _record("cloud_tenants", ct)

    # 11. Results. A kernel that runs on several paths: its launches are the sum.
    tmt, fat = detail["tile_matmul_time"]["prefill"], detail["flash_attention_time"]
    sst, gt = detail["ssd_scan_time"], detail["tile_matmul_grad_time"]
    fbt, sbt = detail["flash_attention_bwd_time"], detail["ssd_scan_bwd_time"]
    runs = (sm, ms, tr, mt, ac, pp, ct)
    mlp_t = detail["mlp_ops"]["times"]["256x256"]

    def summed(name: str) -> dict:
        """Launches of ``name`` over the seven paths (the ACAN path's
        crash-free run, the paper's four MLP runs, the two-tenant cloud's
        crash run), in all and by path."""
        by = {p: sum(r["launches_by_path"][name][p] for r in runs)
              for p in sm["launches_by_path"][name]}
        return dict(launches=sum(r["launches"][name] for r in runs), launches_by_path=by)

    kernels = [
        dict(name="tile_matmul", route="cuda", source="src/repro_torch/csrc/tile_matmul.cu",
             replaces="src/repro/kernels/tile_matmul/kernel.py:58",
             **summed("tile_matmul"),
             launches_by_layout_in_training={
                 k: tr["tile_matmul_layouts"][k] + mt["tile_matmul_layouts"][k]
                 for k in tr["tile_matmul_layouts"]},
             max_abs_err=detail["tile_matmul_err"][str(torch.bfloat16)],
             ms=tmt["ms"], plain_ms=tmt["plain_ms"], bound_ms=tmt["bound_ms"],
             bound_by=tmt["bound_by"], library_ms=tmt["library_ms"],
             timed="one smollm layer's 7 prefill projections, M=4096, bf16; mamba2's "
                   "6 in chip_smoke.json",
             grad={k: gt["both"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}
             | {"max_abs_err": detail["tile_matmul_grad_err"][str(torch.bfloat16)],
                "timed": "dx = dz @ w^T (w read in place, K-major wgmma B) and "
                         "dw = x^T @ dz (x read in place, MN-major wgmma A) of one "
                         "smollm layer's 7 projections, M=4096, bf16"},
             mlp_f32={k: mlp_t[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                            "library_device_ms", "bound_ms", "bound_by",
                                            "path")}
             | {"max_abs_err": max(detail["mlp_ops"]["max_abs_err"].values()),
                "launches": pp["launches_by_path"]["tile_matmul"]["skinny"]
                + pp["launches_by_path"]["tile_matmul"]["ffma"],
                "timed": "one launch of the paper MLP's layer-0 product: 16 masked rows "
                         "(16, 256) @ (256, 256), float32; launches: the paper's four "
                         "runs, skinny + ffma"}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:88",
             **summed("flash_attention"),
             max_abs_err=detail["flash_attention_err"][str(torch.bfloat16)],
             ms=fat["ms"], plain_ms=fat["plain_ms"], bound_ms=fat["bound_ms"],
             bound_by=fat["bound_by"], library_ms=fat["library_ms"], ffma_ms=fat["ffma_ms"],
             device_ms=fat["device_ms"], library_device_ms=fat["library_device_ms"],
             timed="one layer's prefill attention, q (40, 3, 512, 64), causal, bf16, "
                   "mma path"),
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:70",
             **summed("ssd_scan"),
             max_abs_err=detail["ssd_scan_err"][str(torch.bfloat16)]["y"],
             ms=sst["ms"], plain_ms=sst["plain_ms"], bound_ms=sst["bound_ms"],
             bound_by=sst["bound_by"], library_ms=None, ffma_ms=sst["ffma_ms"],
             device_ms=sst["device_ms"],
             timed="one mamba2 layer's prefill scan, x (8, 512, 80, 64), N 128, bf16, "
                   "mma path"),
        dict(name="flash_attention_bwd", route="cuda",
             source="src/repro_torch/csrc/flash_attention_bwd.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:88",
             replaces_part="the gradient of flash_attention (the Pallas kernel has none; "
                           "the reference differentiates plain jnp attention)",
             **summed("flash_attention_bwd"),
             max_abs_err=max(detail["flash_attention_bwd_err"][str(torch.bfloat16)][g]
                             for g in ("dq", "dk", "dv")),
             ms=fbt["ms"], plain_ms=fbt["plain_ms"], bound_ms=fbt["bound_ms"],
             bound_by=fbt["bound_by"], library_ms=fbt["library_ms"],
             device_ms=fbt["device_ms"], library_device_ms=fbt["library_device_ms"],
             dq_ms=fbt["dq_ms"], dkv_ms=fbt["dkv_ms"], ffma_ms=fbt["ffma_ms"],
             timed="one layer's attention backward, q (40, 3, 512, 64), causal, bf16, "
                   "mma path (wgmma at D = 64); library: SDPA's flash backward op, K/V "
                   "repeated"),
        dict(name="ssd_scan_bwd", route="cuda", source="src/repro_torch/csrc/ssd_scan_bwd.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:70",
             replaces_part="the gradient of ssd_scan, which the Pallas kernel lacks; the "
                           "reference differentiates plain ssd_chunked "
                           "(src/repro/models/mamba2.py:80)",
             **summed("ssd_scan_bwd"),
             max_abs_err=max(detail["ssd_scan_bwd_err"][str(torch.bfloat16)]["abs"].values()),
             max_rel_err=max(detail["ssd_scan_bwd_err"][str(torch.bfloat16)]["rel"].values()),
             ms=sbt["ms"], plain_ms=sbt["plain_ms"], bound_ms=sbt["bound_ms"],
             bound_by=sbt["bound_by"], library_ms=None, ffma_ms=sbt["ffma_ms"],
             device_ms=sbt["device_ms"], walk_ms=sbt["walk_ms"],
             head_sum_ms=sbt["head_sum_ms"],
             timed="one mamba2 layer's scan backward, x (8, 512, 80, 64), N 128, bf16, "
                   "with a final-state gradient, mma path"),
    ]
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(detail, indent=1, default=str))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
