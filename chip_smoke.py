#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc``, holds
each against its plain PyTorch version at the serving and training paths'
shapes, times them, and drives the port's two serving paths through its
``serve`` entry point (batch 8 x 512-token prompts, 32 greedy tokens each):
full-width smollm_360m (tile_matmul + flash_attention) and full-width,
full-depth mamba2_2_7b (tile_matmul + ssd_scan); then the three
dense-attention configs at full width, each its own phase and record:
gemma3_12b at full depth (4 x 2048 prompts; sliding window, qk-norm,
sandwich norms, flash_attention at D 256), h2o_danube_1_8b at full depth
(2 x 8192; window 4096, D 80) and command_r_plus_104b at 8 of its 64 layers
(8 x 512; parallel residual, G 12), each with exact launch counts, one
prefill and one decode step profiled and float32 logits against the CPU's
at 1e-4 (reduced depth); then qwen2_moe_a2_7b at full width and depth (8 x
1024; 60 experts top-4, each expert product one batched tile_matmul launch
over the experts, the float32 router, D 128 attention at G 1), its float32
routing and then logits held against the CPU's on 2 layers; then
deepseek_v2_lite_16b the same way (MLA); then the two frontends as the
dense configs are served: musicgen_medium at full width and depth (8 x
512; codebooks: (B, T, 4) prompts, a token a codebook a step, the GELU
FFN's biases and GELU in tile_matmul's epilogue, MHA at D 64) and
internvl2_76b at full width, 16 of its 80 layers (8 x 512; embeds: seeded
prompt embeddings and a fresh one a decode step; G 8, D 128); then
jamba_1_5_large_398b at full width, the first 4 layers of its period of 8
(8 x 512; attention + dense FFN, then Mamba layers with MoE, dense and MoE
FFNs: the hybrid cache, ssd_scan at 256 heads in 8 groups, 16 experts
top-2 whose weight tensors pass 2^31 elements), float32 routing and logits
against the CPU's on its layers 0 and 7, and the reduced config served
and one float32 train step on the card against the CPU's; then the twin
of examples/serve_batched.py (reduced smollm_360m, mamba2_2_7b,
deepseek_v2_lite_16b and musicgen_medium in float32 on the ffma and skinny
paths, launches by path exact, tokens against the CPU's); then the training path
through ``train``: five AdamW steps of full-width, full-depth smollm_360m on
8 x 512 tokens, every projection's forward and both gradient products
through tile_matmul, every attention through flash_attention and its
backward kernel, and one float32 train step held against the CPU's; then
the same for full-width, full-depth mamba2_2_7b, every scan through
ssd_scan and its gradient through ssd_scan_bwd; then full-width, full-depth
h2o_danube_1_8b (2 x 8192) and full-width gemma3_12b at 12 of its 48 layers
(2 x 2048), every attention's gradient through flash_attention_bwd at D 80
and 256, each its own phase and record with one float32 train step of 2
layers held against the CPU's; then full-width qwen2_moe_a2_7b at 4 of its
24 layers (8 x 1024), each expert product's gradients two batched
tile_matmul launches (``x@w^T`` and ``x^T@w``), the attention's gradient
through flash_attention_bwd at D 128 on wgmma, remat "nothing" against
"none" bit for bit, and a float32 step of 2 layers against the CPU's,
routing first; then full-width deepseek_v2_lite_16b at 5 of its 27 layers
(the dense first layer and 4 MoE layers, 8 x 1024) the same way, MLA's
five products a layer and their gradients through tile_matmul, every
attention's gradient through flash_attention_bwd at q/k head dim 192 and
v head dim 128 on wgmma; then full-width, full-depth
smollm_360m trained by the paper's ACAN runtime (``ACANStepRunner``: Manager
and Handler threads over the tuple space, one task a microbatch gradient,
4 x 2 x 512 tokens a step) without and with injected handler crashes, whose
losses and weights must agree bit for bit, one of its steps profiled, and
the float32 runner held against the CPU's; then the twin of
examples/acan_jax_train.py (reduced deepseek_v2_lite_16b in float32 on
the ffma paths, the attention at q/k 24 and v 16) without and with the
example's handler crashes, equal bit for bit; then the paper's own system
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
flash_attention's backward (at every case of ``FLASH_CASES``: D 64, 80,
128 and 256, and of ``FLASH_MLA_CASES``: (192, 128) and (24, 16)) and
ssd_scan's backward are checked against their plain
versions (and for repeat launches giving the same bits) and timed beside
``torch.matmul`` and SDPA's backward (no single PyTorch call computes the
scan's gradient), the attention backward at each trained config's shape.

Usage (from the repository root, on a host with a CUDA device)::

    python3 chip_smoke.py

Prints the device and its power limit, one ``{"phase": ...}`` JSON line for
each of the dense-attention, MoE and frontend serves, the serve_batched
twin, the trains and the deepseek ACAN twin, the MLP, fleet and MoE
phases, a
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase raises
and exits non-zero. Imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import gc
import importlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

# The caching allocator maps pages into growing segments instead of carving
# fixed ones: gemma3_12b's training frees the old moments leaf by leaf
# (hundreds of 60-240 MB blocks) and then asks for 4 GB loss-chunk tensors,
# which fixed segments left 27 GB short (OOM at 50 of 79 GiB in use).
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

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
# One layer of each config served in slice 20, (K, N, activation, bias),
# timed only: musicgen_medium's six (q, k, v, o, then the FFN's up with GELU
# and down, both with biases) and internvl2_76b's seven (q, k, v, o, gate
# with SiLU, up, down).
SERVED_LAYER = {"musicgen_medium": ((1536, 1536, "none", False), (1536, 1536, "none", False),
                                    (1536, 1536, "none", False), (1536, 1536, "none", False),
                                    (1536, 6144, "gelu", True), (6144, 1536, "none", True)),
                "internvl2_76b": ((8192, 8192, "none", False), (8192, 1024, "none", False),
                                  (8192, 1024, "none", False), (8192, 8192, "none", False),
                                  (8192, 28672, "silu", False), (8192, 28672, "none", False),
                                  (28672, 8192, "none", False))}
BATCH, PROMPT, GEN, CACHE = 8, 512, 32, 1024
# ssd_scan: (Bt, T, H, P, G, N) of one mamba2_2_7b layer's prefill scan,
# and of one jamba_1_5_large_398b Mamba layer's (256 heads in 8 groups).
SSD_PATH = (BATCH, PROMPT, 80, 64, 1, 128)
SSD_JAMBA = (BATCH, PROMPT, 256, 64, 8, 128)
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


def _raw_events(prof) -> list:
    """The trace's events as the profiler recorded them. Reading them
    directly takes a fraction of a second where ``prof.key_averages()``
    first builds torch.profiler's event tree: about 9 s for the 100k events
    of a 48-layer train step, on the host's clock and checking nothing."""
    return [e for e in prof.profiler.kineto_results.events()
            if not (e.is_user_annotation() or e.is_hidden_event())]


def _device_kernels(prof) -> list[tuple[str, float, int]]:
    """(name, device ms, launches) of each kernel (and copy) in a
    torch.profiler trace, the longest first."""
    from torch.autograd import DeviceType

    kern: dict = {}
    for e in _raw_events(prof):
        if e.device_type() == DeviceType.CUDA:
            ns, n = kern.get(e.name(), (0, 0))
            kern[e.name()] = (ns + e.duration_ns(), n + 1)
    return sorted(((k, ns / 1e6, n) for k, (ns, n) in kern.items()), key=lambda r: -r[1])


def _host_ops(prof, top: int = 10) -> list[dict]:
    """The ``top`` host operations of a trace by their own time: each
    event's time less its direct children's on its thread (nested by start
    and end), summed by name."""
    from torch.autograd import DeviceType

    threads: dict = {}
    for e in _raw_events(prof):
        if e.device_type() == DeviceType.CPU and not e.is_async() and e.duration_ns() > 0:
            threads.setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), -e.end_ns(), e.name()))
    own: dict = {}
    for spans in threads.values():
        stack: list = []                    # [end, name, own ns] of open events
        for start, neg_end, name in sorted(spans):
            while stack and stack[-1][0] <= start:
                _, done, ns = stack.pop()
                t, n = own.get(done, (0, 0))
                own[done] = (t + ns, n + 1)
            if stack:
                stack[-1][2] -= -neg_end - start
            stack.append([-neg_end, name, -neg_end - start])
        for _, done, ns in stack:
            t, n = own.get(done, (0, 0))
            own[done] = (t + ns, n + 1)
    rows = sorted(own.items(), key=lambda kv: -kv[1][0])[:top]
    return [dict(name=k[:60], self_ms=ns / 1e6, calls=n) for k, (ns, n) in rows]


def _traced_ms(fn, names: tuple[str, ...], iters=10, tries=5) -> dict:
    """Device time a launch of each kernel whose name holds one of
    ``names``, from a torch.profiler trace of ``iters`` calls after a
    warm-up call and, inside the trace, one small kernel. A trace can lose
    a launch (at gemma3's shape 1 of the 3 dQ launches, in 3 traces of 3),
    or every launch of a kernel (gemma3's D 256 pair, in 3 traces of 3 once):
    up to ``tries`` traces are taken until each name matches one kernel
    that ran once a call; failing that, the last is used if each kernel
    ran at least ``iters`` - 1 times, and the time is over the launches
    traced. Fails otherwise. ``traces`` counts the traces taken,
    ``traced_launches`` each kernel's launches in the one used."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for n in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = _device_kernels(prof)
        hits = {name: [(t, c) for k, t, c in kernels if name in k] for name in names}
        if all(len(h) == 1 and h[0][1] == iters for h in hits.values()):
            break
    assert all(len(h) == 1 and iters - 1 <= h[0][1] <= iters for h in hits.values()), \
        ("launches missing from every trace", iters, hits)
    return {name: h[0][0] / h[0][1] for name, h in hits.items()} | dict(
        traces=n, traced_launches={name: h[0][1] for name, h in hits.items()})


def _bound(flops: float, nbytes: float, dtype) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


# Bytes of the pinned buffer that card-to-host copies of large tensors go
# through: a pageable copy (CUDA's own staging and its first touch of the
# new host pages on one thread) runs at about half the rate of a DMA into
# pinned memory and a multi-threaded copy out of it.
PINNED_BYTES = 1 << 28
_pinned: list = []
_pinned_lock = threading.Lock()


def _host_copy(t: torch.Tensor) -> torch.Tensor:
    """A CUDA tensor's bytes on the host, through ``_pinned``'s buffer in
    runs of ``PINNED_BYTES`` (each a DMA into the buffer, then a copy out),
    one copy at a time."""
    out = torch.empty(t.shape, dtype=t.dtype)
    src = t.contiguous().reshape(-1).view(torch.uint8)
    dst = out.reshape(-1).view(torch.uint8)
    with _pinned_lock:
        if not _pinned:
            _pinned.append(torch.empty(PINNED_BYTES, dtype=torch.uint8, pin_memory=True))
        buf = _pinned[0]
        for i in range(0, src.numel(), buf.numel()):
            n = min(buf.numel(), src.numel() - i)
            buf[:n].copy_(src[i:i + n])
            dst[i:i + n].copy_(buf[:n])
    return out


def _to(tree, device):
    """Every tensor of a tree of dicts, lists and tuples moved to ``device``
    (from the card to the host through a pinned buffer where it is large);
    other leaves as they are."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda and str(device) == "cpu" and tree.nbytes >= PINNED_BYTES // 4:
            return _host_copy(tree)
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


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
    """Registers, shared memory, stack and spills of each kernel, from
    ptxas -v, and whether ptxas serialized its wgmmas (its C7514 note)."""
    kernels, name = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif name and "spill stores" in line:
            stack, spill = line.split(",", 1)
            kernels[name] = {"spill": spill.strip(), "stack": stack.strip()}
        elif name and "Used" in line and name in kernels:
            kernels[name]["used"] = line.split(":", 1)[1].strip()
    for line in ptxas.splitlines():
        if "C7514" in line:
            for kname, info in kernels.items():
                if kname in line:
                    info["wgmma_serialized"] = True
    return kernels


def sass_start(so: Path) -> tuple:
    """``cuobjdump -sass`` of the library ``so`` started, writing beside it
    (a library takes seconds): (process, file), for :func:`_sass_ops`."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    path = so.with_suffix(".sass")
    with path.open("w") as f:
        proc = subprocess.Popen([cuobjdump, "-sass", str(so)], stdout=f,
                                stderr=subprocess.PIPE, text=True)
    return proc, path


def start_sass(build) -> dict:
    """:func:`sass_start` of every library of ``NO_SPILL``, all at once (the
    card's checks run meanwhile), for :func:`kernel_build_report`."""
    return {lib: sass_start(build._target(lib)) for lib in NO_SPILL}


def _sass_ops(started, ops) -> tuple[dict, dict]:
    """Counts of each of ``ops`` in a library's SASS, in all and by kernel
    (a ``Function :`` section of ``cuobjdump -sass``), from its
    :func:`sass_start` process and file."""
    proc, path = started
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, (path, err)
    sass = path.read_text()
    by_kernel = {}
    for part in sass.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        by_kernel[name.strip()] = {op: body.count(op) for op in ops}
    return {op: sass.count(op) for op in ops}, by_kernel


# Kernels that must not spill, by a substring of their mangled names, and the
# SASS each library must hold: wgmma (HGMMA) in tile_matmul (with TMA,
# UTMALDG), in the attention forward at D = 80, 128 and 256 (with TMA) and
# in the attention backward at D = 64, 80, 128 and 256, the mma paths'
# tensor-core products (HMMA) and ldmatrix (LDSM) loads. The attention
# backward's kernels at the dense configs' head dims (80, 256) are held on
# both paths. Every attention kernel whose name holds ``WGMMA_KERNEL`` must
# itself hold HGMMA, and ptxas must not have serialized its wgmmas.
WGMMA_KERNEL = "_wg"
NO_SPILL = {"tile_matmul": ("wgmma", "skinny"),
            "flash_attention": ("flash_fwd_mma", "flash_fwd_wg"),
            "ssd_scan": ("ssd_fwd_mma",),
            "flash_attention_bwd": ("_mmaI", "_wgmma", "_wg256", "_wgsplit", "Li80E",
                                    "Li256E"),
            "ssd_scan_bwd": ("ssd_bwd_mma",)}
SASS_OPS = {"tile_matmul": ("HGMMA", "UTMALDG", "LDL", "STL"),
            "flash_attention": ("HGMMA", "UTMALDG", "HMMA", "LDSM", "LDGSTS", "LDL", "STL"),
            "ssd_scan": ("HMMA", "LDSM", "LDGSTS", "LDL", "STL"),
            "flash_attention_bwd": ("HGMMA", "HMMA", "LDSM", "LDGSTS", "LDL", "STL"),
            "ssd_scan_bwd": ("HMMA", "LDSM", "LDGSTS", "LDL", "STL")}
SASS_NEED = {"tile_matmul": ("HGMMA", "UTMALDG"),
             "flash_attention": ("HGMMA", "UTMALDG", "HMMA", "LDSM"),
             "ssd_scan": ("HMMA", "LDSM"), "flash_attention_bwd": ("HGMMA", "HMMA", "LDSM"),
             "ssd_scan_bwd": ("HMMA", "LDSM", "LDGSTS")}
# The attention's kernel (forward) and two kernels (backward) at each head
# dim chip_smoke.py times, as named in a profiler trace.
FLASH_FWD_KERNELS = {64: "flash_fwd_mma<64>", 80: "flash_fwd_wg<80, 80>",
                     128: "flash_fwd_wg<128, 128>", 256: "flash_fwd_wg256",
                     (192, 128): "flash_fwd_wg<192, 128>"}
FLASH_BWD_KERNELS = {64: ("flash_bwd_dq_wgmma<64>", "flash_bwd_dkv_wgmma<64>"),
                     80: ("flash_bwd_dq_wgmma<80>", "flash_bwd_dkv_wgmma<80>"),
                     128: ("flash_bwd_dq_wgmma<128>", "flash_bwd_dkv_wgmma<128>"),
                     256: ("flash_bwd_dq_wg256", "flash_bwd_dkv_wgsplit<256>"),
                     (192, 128): ("flash_bwd_dq_wgmma<192>", "flash_bwd_dkv_wgsplit<192>"),
                     # the reduced deepseek config's pair: ffma only, float32
                     (24, 16): ("flash_bwd_dq<float, 24>", "flash_bwd_dkv<float, 24>")}


def kernel_build_report(build, ptxas: dict, sass: dict) -> dict:
    """What ptxas said of each kernel of each library (registers, shared
    memory, spills) and the counts of ``SASS_OPS`` in each library. Fails on
    a spill or a stack frame in a kernel of ``NO_SPILL``, on an attention
    wgmma kernel (``WGMMA_KERNEL``) without HGMMA or with its wgmmas
    serialized by ptxas, and on a library without the instructions of
    ``SASS_NEED`` (the wgmma of tile_matmul and of the attention forward and
    backward, the TMA of tile_matmul and of the attention forward, the mma
    paths' HMMA and LDSM). ``sass``: :func:`start_sass`'s processes."""
    report = {}
    no_spill = "0 bytes spill stores, 0 bytes spill loads"
    for lib, keys in NO_SPILL.items():
        kernels = _ptxas_kernels(ptxas[lib])
        ops, by_kernel = _sass_ops(sass[lib], SASS_OPS[lib])
        checked = [k for k in kernels if any(key in k for key in keys)]
        assert kernels and (checked or not keys), (lib, sorted(kernels))
        for kname in checked:
            assert kernels[kname]["spill"].startswith(no_spill), (kname, kernels[kname])
            assert kernels[kname]["stack"].startswith("0 bytes stack"), (kname, kernels[kname])
        if lib.startswith("flash_attention"):
            for kname in (k for k in kernels if WGMMA_KERNEL in k):
                assert not kernels[kname].get("wgmma_serialized"), (kname, kernels[kname])
                kernels[kname]["sass_ops"] = by_kernel[kname]
                assert by_kernel[kname]["HGMMA"] > 0, (kname, by_kernel[kname])
        assert all(ops[op] > 0 for op in SASS_NEED[lib]), (lib, ops)
        report[lib] = {"kernels": kernels, "sass_ops": ops}
    return report


FLASH_CASES = (  # (name, BH, G, Tq, Tkv, D, window, softcap)
    ("causal", 40, 3, 512, 512, 64, 0, 0.0),
    ("window", 40, 3, 512, 512, 64, 128, 0.0),
    ("softcap", 40, 3, 512, 512, 64, 0, 30.0),
    ("q_offset", 40, 3, 256, 512, 64, 0, 0.0),
    # The dense-attention configs' prefill layers at the shapes their serves
    # launch: gemma3_12b's global and local (window 1024) layers (batch 4 x 8
    # kv heads, G 2, D 256), h2o_danube_1_8b's (batch 2 x 8 kv heads, window
    # 4096, G 4, D 80) and command_r_plus_104b's (batch 8 x 8 kv heads, G 12,
    # D 128) and qwen2_moe_a2_7b's (batch 8 x 16 kv heads, G 1, D 128);
    # then each new D with the other configs' G, windowed and global, Tq
    # ragged; then musicgen_medium's MHA (batch 8 x 24 heads, G 1, D 64) and
    # internvl2_76b's (batch 8 x 8 kv heads, G 8, D 128).
    ("gemma3_global", 32, 2, 2048, 2048, 256, 0, 0.0),
    ("gemma3_local", 32, 2, 2048, 2048, 256, 1024, 0.0),
    ("danube", 16, 4, 8192, 8192, 80, 4096, 0.0),
    ("command_r", 64, 12, 512, 512, 128, 0, 0.0),
    ("qwen2", 128, 1, 1024, 1024, 128, 0, 0.0),
    ("d256_g4_window_ragged", 8, 4, 1000, 1500, 256, 300, 0.0),
    ("d256_g12_ragged", 4, 12, 333, 333, 256, 0, 0.0),
    ("d80_g2_global_ragged", 8, 2, 1000, 1000, 80, 0, 0.0),
    ("d80_g12_window_ragged", 4, 12, 777, 1200, 80, 256, 0.0),
    ("musicgen", 192, 1, 512, 512, 64, 0, 0.0),
    ("internvl2", 64, 8, 512, 512, 128, 0, 0.0),
)
# MLA's head dims, q/k 192 and v 128, forward and backward:
# deepseek_v2_lite_16b's layer (batch 8 x 16 heads, G 1), then ragged, and
# G 2 with a window; and its reduced config's (24, 16), which only the ffma
# path takes (bf16 too): the ACAN twin's layer (2 x 4 heads, 32 tokens),
# and ragged with a window.
FLASH_MLA_CASES = (
    ("deepseek", 128, 1, 1024, 1024, (192, 128), 0, 0.0),
    ("mla_g1_ragged", 8, 1, 1000, 1000, (192, 128), 0, 0.0),
    ("mla_g2_window_ragged", 4, 2, 777, 1200, (192, 128), 300, 0.0),
    ("mla_reduced", 8, 1, 32, 32, (24, 16), 0, 0.0),
    ("mla_reduced_g2_window_ragged", 6, 2, 77, 133, (24, 16), 20, 0.0),
)


def _dims(d) -> tuple[int, int]:
    """(head dim of q and k, head dim of v and the output) of a case's D:
    one int, or MLA's pair."""
    return d if isinstance(d, tuple) else (d, d)


def _flash_limit(ref: torch.Tensor, dtype) -> torch.Tensor:
    """The forward's limit per element, TOL (|plain| + min(1, rms of the
    plain output's row)). An output row that sees N keys is of size
    sqrt(e / N), 0.03 at N = 4096, so a limit of TOL alone would hide a key
    tile dropped or misplaced; the rows that see few keys are of size 1,
    where P rounded to bf16 at other points than the plain version's moves
    an element near 0 by about 2^-8 of its row."""
    rms = ref.square().mean(-1, keepdim=True).sqrt().clamp(max=1.0)
    return TOL[dtype] * (ref.abs() + rms)


def _flash_bwd_limit(ref: torch.Tensor, dtype) -> torch.Tensor:
    """The backward's limit per element, TOL (|plain| + max(rms of the
    plain gradient's row, rms of the whole)). A gradient row whose query
    sees N keys (or whose key is seen by N query rows) is of size about
    sqrt(e / N): 0.026 for danube's dq, so a limit of TOL alone would hide
    a 64 x 64 tile pair dropped (about 0.003 a dq row) or a window edge one
    key off. The whole's rms floors the rows whose gradient is rounding
    noise: a row that sees one key has dS = P (dP - Dv) = 0 exactly."""
    rms = ref.square().mean(-1, keepdim=True).sqrt().clamp(min=ref.square().mean().sqrt().item())
    return TOL[dtype] * (ref.abs() + rms)


# The bytes of one float32 score tensor (a slice's G x Tq x Tkv) the plain
# version forms, at most: it runs over batch x kv-head slices of the layer
# where the whole would not fit. Its forward holds up to three such tensors
# at once (the masked scores, P, P in the values' dtype).
PLAIN_SCORE_BYTES = 2.2e9


def _plain_step(bh: int, g: int, tq: int, tkv: int) -> int:
    """Batch x kv-head slices of a layer the plain version takes at once."""
    return max(1, min(bh, int(PLAIN_SCORE_BYTES // (g * tq * tkv * 4))))


# The path each dtype must take at the checks' shapes.
DTYPE_PATH = {torch.bfloat16: "mma", torch.float32: "ffma"}
# The attention head-dim pairs that take ffma in either dtype: the reduced
# deepseek config's (24, 16), whose rows are narrower than the mma path's
# 128-byte atoms.
FLASH_FFMA_PAIRS = ((24, 16),)


def _flash_path(dtype, d) -> str:
    """The attention path the checks expect at head dim (or pair) ``d``."""
    return "ffma" if d in FLASH_FFMA_PAIRS else DTYPE_PATH[dtype]


def _took(fn, path: str, before: dict) -> None:
    after = fn.paths
    assert {p: after[p] - before[p] for p in after} == {p: int(p == path) for p in after}, \
        (path, before, dict(after))


def check_flash(fa_kernel, flash_attention_ref) -> dict:
    """Kernel vs plain version at the serving shapes of ``FLASH_CASES``
    (smollm's with its window, softcap and q_offset variants, and the dense
    configs' at D 80, 128 and 256) and ``FLASH_MLA_CASES`` (deepseek's MLA
    at q/k head dim 192 and v head dim 128), each case launched whole and held slice
    by slice where the plain version's scores would not fit at once: the
    mma path in bf16, the ffma path in float32, each element within
    ``flash_limit`` (the reduced deepseek pair, (24, 16), on ffma in either
    dtype). Worst error per dtype, per path and per case; per case also
    ``margin``, the largest |error| / limit (at most 1)."""
    err: dict = {"by_case": {}}
    fn = fa_kernel.flash_attention
    for dtype in (torch.bfloat16, torch.float32):
        worst = 0.0
        for name, bh, g, tq, tkv, d, window, softcap in FLASH_CASES + FLASH_MLA_CASES:
            dk, dv = _dims(d)
            q = _randn((bh, g, tq, dk), dtype, 1)
            k = _randn((bh, tkv, dk), dtype, 2)
            v = _randn((bh, tkv, dv), dtype, 3)
            kw = dict(causal=True, window=window, softcap=softcap, q_offset=tkv - tq)
            before = dict(fn.paths)
            out = fn(q, k, v, **kw)
            _took(fn, _flash_path(dtype, d), before)
            e = margin = 0.0
            step = _plain_step(bh, g, tq, tkv)
            for i in range(0, bh, step):
                ref = flash_attention_ref(q[i:i + step], k[i:i + step], v[i:i + step],
                                          **kw).float()
                diff = (out[i:i + step].float() - ref).abs()
                limit = _flash_limit(ref, dtype)
                e = max(e, diff.max().item())
                margin = max(margin, (diff / limit).max().item())
                assert bool((diff <= limit).all()), (name, str(dtype), i, e, margin)
                del ref, diff, limit
            err["by_case"][f"{name} {dtype}"] = dict(max_abs_err=e, margin=margin)
            worst = max(worst, e)
            del q, k, v, out
        err[str(dtype)] = worst
        err[DTYPE_PATH[dtype]] = worst
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return err


def _grad_operands(m: int, k: int, n: int, dtype, seed: int):
    """x (m, k), w (k, n) and an output gradient dz (m, n) scaled so that
    dx and dw are of order 1."""
    return (_randn((m, k), dtype, seed), _randn((k, n), dtype, seed + 1, k ** -0.5),
            _randn((m, n), dtype, seed + 2, m ** -0.5))


def check_tile_matmul_grad(tm_kernel, tile_matmul_ref) -> dict:
    """The gradient products of smollm_360m's seven and mamba2_2_7b's six
    projections at M = 4096 (mamba2's give K = 80 for the dt projection's
    dx and N = 80 and 128 for dw: TMA boxes the tiles overhang), bf16
    through wgmma and float32 through ffma, and of musicgen_medium's six and
    internvl2_76b's seven (``SERVED_LAYER``) in bf16: dx = dz @ w^T (w read
    in place, ``trans_w``) and dw = x^T @ dz (x read in place, ``trans_x``)
    against the plain version; two launches of dw give the same bits. Each
    of the latter two's fused products also launches its float32 ``z``
    (the product before the activation, with its bias), as its backward
    does: its worst error is ``z``."""
    fn = tm_kernel.tile_matmul
    err: dict = {}
    shapes = [(k, n, "none", False) for layer in LAYER.values() for k, n, _ in layer]
    served = [kn for layer in SERVED_LAYER.values() for kn in layer]
    for dtype in (torch.bfloat16, torch.float32):
        worst = {"dx": 0.0, "dw": 0.0} | ({"z": 0.0} if dtype == torch.bfloat16 else {})
        cases = shapes + (served if dtype == torch.bfloat16 else [])
        for i, (k, n, act, has_bias) in enumerate(cases):
            x, w, dz = _grad_operands(BATCH * PROMPT, k, n, dtype, 10 * i)
            runs = [("dx", dz, w, None, dict(trans_w=True)),
                    ("dw", x, dz, None, dict(trans_x=True))]
            if act != "none":
                b = _randn((n,), dtype, 10 * i + 3, 0.1) if has_bias else None
                runs.append(("z", x, w, b, dict(out_dtype=torch.float32)))
            for name, a, b, bias, kw in runs:
                before, layouts = dict(fn.paths), dict(fn.layouts)
                out = fn(a, b, bias, **kw)
                _took(fn, {torch.bfloat16: "wgmma", torch.float32: "ffma"}[dtype], before)
                layout = tm_kernel.layout_of(kw.get("trans_x", False), kw.get("trans_w", False))
                assert fn.layouts[layout] == layouts[layout] + 1, (layout, fn.layouts)
                ref = tile_matmul_ref(a, b, bias, **kw)
                tol = TOL[torch.float32 if name == "z" else dtype]
                torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                                           msg=lambda e, c=(name, k, n): f"{c}: {e}")
                worst[name] = max(worst[name], (out.float() - ref.float()).abs().max().item())
                if name == "dw":
                    assert torch.equal(out, fn(a, b, **kw)), ("dw not deterministic", k, n)
        err[str(dtype)] = worst
    torch.cuda.synchronize()
    return err


# The explicit backward formula holds up to six float32 score tensors at
# once (s, P, dP, dP - Dv, P (dP - Dv) and dS; the softcap factor besides),
# twice the forward's three: its slices are this many times thinner.
PLAIN_BWD_SCORES = 2


def check_flash_bwd(fa_kernel, flash_attention_ref, flash_attention_bwd_ref) -> dict:
    """The backward kernels against the explicit formula at every case of
    ``FLASH_CASES`` (smollm's training shape and its variants at D 64, the
    dense configs' layers at D 80, 128 and 256, the ragged ones) and of
    ``FLASH_MLA_CASES`` (deepseek's layer at (192, 128), the reduced
    config's (24, 16) on ffma), the forward's lse against the plain
    version's first: the mma path in bf16, the ffma path in float32 (and at
    (24, 16)), each launched whole and held slice by slice
    where the plain formula's scores would not fit at once, each gradient
    element within ``_flash_bwd_limit``; two launches give the same bits.
    Worst error per dtype and per case; per case also each gradient's
    ``margin``, the largest |error| / limit (at most 1)."""
    err: dict = {"by_case": {}}
    bwd = fa_kernel.flash_attention_bwd
    for dtype in (torch.bfloat16, torch.float32):
        worst = {"lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
        for name, bh, g, tq, tkv, d, window, softcap in FLASH_CASES + FLASH_MLA_CASES:
            dk, dv = _dims(d)
            q = _randn((bh, g, tq, dk), dtype, 1)
            k = _randn((bh, tkv, dk), dtype, 2)
            v = _randn((bh, tkv, dv), dtype, 3)
            do = _randn((bh, g, tq, dv), dtype, 4)
            kw = dict(causal=True, window=window, softcap=softcap, q_offset=tkv - tq)
            o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)
            before = dict(bwd.paths)
            grads = bwd(q, k, v, o, do, lse, **kw)
            _took(bwd, _flash_path(dtype, d), before)
            again = bwd(q, k, v, o, do, lse, **kw)
            assert all(torch.equal(a, b) for a, b in zip(grads, again)), ("bwd", name)
            del again
            case = dict.fromkeys(worst, 0.0) | {"margin": dict.fromkeys(("dq", "dk", "dv"), 0.0)}
            step = max(1, _plain_step(bh, g, tq, tkv) // PLAIN_BWD_SCORES)
            for i in range(0, bh, step):
                sl = slice(i, i + step)
                _, lse_ref = flash_attention_ref(q[sl], k[sl], v[sl], return_lse=True, **kw)
                torch.testing.assert_close(lse[sl], lse_ref, rtol=TOL[dtype], atol=TOL[dtype],
                                           msg=lambda m, c=(name, i): f"lse {c}: {m}")
                case["lse"] = max(case["lse"], (lse[sl] - lse_ref).abs().max().item())
                refs = flash_attention_bwd_ref(q[sl], k[sl], v[sl], o[sl], do[sl], lse[sl], **kw)
                for gname, got, want in zip(("dq", "dk", "dv"), grads, refs):
                    want = want.float()
                    diff = (got[sl].float() - want).abs()
                    limit = _flash_bwd_limit(want, dtype)
                    case[gname] = max(case[gname], diff.max().item())
                    case["margin"][gname] = max(case["margin"][gname],
                                                (diff / limit).max().item())
                    assert bool((diff <= limit).all()), (name, str(dtype), gname, i, case)
                    del want, diff, limit
                del lse_ref, refs
            err["by_case"][f"{name} {dtype}"] = case
            worst = {key: max(worst[key], case[key]) for key in worst}
            del q, k, v, do, o, lse, grads
        err[str(dtype)] = worst
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return err


# The library's activations, applied to torch.matmul's product.
LIB_ACTS = {"none": lambda y: y, "silu": F.silu,
            "gelu": lambda y: F.gelu(y, approximate="tanh")}


def _time_layer(layer, m: int, copies: int, tm_kernel, tile_matmul_ref,
                plain_iters: int = 20, graph_iters: int = 20) -> dict:
    """One layer's bf16 projections ``layer``, (K, N, activation[, bias]),
    at M = ``m``, cycling through ``copies`` sets of weights (and biases).
    Kernel and ``torch.matmul`` (``torch.addmm`` with a bias, then the
    activation) in turns (kernel, library, kernel, library); times are the
    mean of the turns. Both also by CUDA-graph replay (``device_ms``,
    ``library_device_ms``), ``graph_iters`` layers a graph."""
    dt = torch.bfloat16
    layer = [(k, n, act, bool(rest and rest[0])) for k, n, act, *rest in layer]
    xs = {k: _randn((m, k), dt, k) for k in {k for k, _, _, _ in layer}}
    ws = [[(_randn((k, n), dt, 10 * c + i, k ** -0.5),
            _randn((n,), dt, 10 * c + i + 5) if bias else None)
           for i, (k, n, _, bias) in enumerate(layer)] for c in range(copies)]

    def run(fn):
        for wl in ws:
            for (k, _, act, _), (w, b) in zip(layer, wl):
                fn(xs[k], w, b, act)

    def lib(x, w, b, act):
        return LIB_ACTS[act](torch.matmul(x, w) if b is None else torch.addmm(b, x, w))

    def kern():
        run(lambda x, w, b, a: tm_kernel.tile_matmul(x, w, b, activation=a))

    turns = [_time_ms(f) / copies for f in (kern, lambda: run(lib)) * 2]
    kern_ms, lib_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
    plain = _time_ms(lambda: run(lambda x, w, b, a: tile_matmul_ref(x, w, b, activation=a)),
                     iters=plain_iters)
    device = _graph_ms(kern, graph_iters) / copies
    library_device = _graph_ms(lambda: run(lib), graph_iters) / copies
    flops = sum(2 * m * k * n for k, n, _, _ in layer)
    nbytes = sum((m * k + k * n + m * n + n * bias) * 2 for k, n, _, bias in layer)
    bound_ms, bound_by = _bound(flops, nbytes, dt)
    return dict(M=m, ms=kern_ms, plain_ms=plain / copies, library_ms=lib_ms,
                device_ms=device, library_device_ms=library_device,
                turns_ms=turns, vs_library=kern_ms / lib_ms,
                tflop_s=flops / kern_ms / 1e9, gb_s=nbytes / kern_ms / 1e6,
                flop=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by)


def time_tile_matmul(tm_kernel, tile_matmul_ref) -> dict:
    """One layer of each model in prefill (M = 4096) and decode (M = 8):
    smollm's and mamba2's, then musicgen's (the GELU and biases in the
    epilogue) and internvl2's (its float32 plain version timed 3 times, its
    prefill layer replayed 3 times a graph).
    Decode cycles through enough weight copies to overflow the 50 MB L2, as
    a decode step finds each layer's weights cold."""
    out = {}
    for arch, layer, copies, iters in (
            ("", LAYER["smollm_360m"], 4, 20), ("mamba2_", LAYER["mamba2_2_7b"], 2, 20),
            ("musicgen_", SERVED_LAYER["musicgen_medium"], 4, 20),
            ("internvl2_", SERVED_LAYER["internvl2_76b"], 1, 3)):
        out[arch + "prefill"] = _time_layer(layer, BATCH * PROMPT, 1, tm_kernel,
                                            tile_matmul_ref, iters, iters)
        out[arch + "decode"] = _time_layer(layer, BATCH, copies, tm_kernel, tile_matmul_ref)
    return out


# One prefill layer's attention of each served config, bf16, causal:
# (batch, kv heads, G, T, D or (Dk, Dv), window).
FLASH_TIMED = {"smollm_360m": (BATCH, 5, 3, PROMPT, 64, 0),
               "gemma3_12b global": (4, 8, 2, 2048, 256, 0),
               "gemma3_12b local": (4, 8, 2, 2048, 256, 1024),
               "h2o_danube_1_8b": (2, 8, 4, 8192, 80, 4096),
               "command_r_plus_104b": (8, 8, 12, 512, 128, 0),
               "qwen2_moe_a2_7b": (8, 16, 1, 1024, 128, 0),
               "deepseek_v2_lite_16b": (8, 16, 1, 1024, (192, 128), 0),
               "musicgen_medium": (BATCH, 24, 1, PROMPT, 64, 0),
               "internvl2_76b": (BATCH, 8, 8, PROMPT, 128, 0)}
def _visible_pairs(tq: int, tkv: int, window: int) -> int:
    """(query, key) pairs a causal, windowed query row block sees (q_offset
    tkv - tq): the attention's work, counted as the kernel skips the rest."""
    qpos = np.arange(tkv - tq, tkv)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else np.zeros_like(qpos)
    return int((qpos + 1 - lo).sum())


def _sdpa_backend(fn) -> str:
    """Which of SDPA's kernels ``fn`` ran, from a torch.profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(k for k, _, _ in _device_kernels(prof)).lower()
    for backend, keys in (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                          ("efficient", ("fmha", "efficient", "cutlass"))):
        if any(key in names for key in keys):
            return backend
    return "math"


def time_flash(fa_kernel, flash_attention_ref) -> dict:
    """One prefill layer's attention of each served config (``FLASH_TIMED``),
    bf16: the mma path (``ms``; ``kernel``, the kernel it launches, as a
    trace names it) and, once, the ffma path (``ffma_ms``), the
    plain version (in batch x kv-head slices where its scores would not fit
    at once), and SDPA (``library_ms``, K/V repeated to every head; a window
    as a boolean mask, ``library_backend`` says which kernel SDPA took);
    kernel and SDPA also by CUDA-graph replay (``device_ms``,
    ``library_device_ms``), and the kernel's TFLOP/s by graph replay."""
    dt, out = torch.bfloat16, {}
    for name, (b, hkv, g, t, d, window) in FLASH_TIMED.items():
        bh, (dk, dv) = b * hkv, _dims(d)
        q = _randn((bh, g, t, dk), dt, 1)
        k = _randn((bh, t, dk), dt, 2)
        v = _randn((bh, t, dv), dt, 3)
        kw = dict(causal=True, window=window)
        kern = _time_ms(lambda: fa_kernel.flash_attention(q, k, v, **kw))
        ffma = _time_ms(lambda: fa_kernel.flash_attention(q, k, v, path="ffma", **kw), iters=5)
        step = _plain_step(bh, g, t, t)
        plain = _time_ms(lambda: [flash_attention_ref(q[i:i + step], k[i:i + step],
                                                      v[i:i + step], **kw)
                                  for i in range(0, bh, step)], iters=3)
        qs = q.reshape(b, hkv * g, t, dk)
        ks = k.reshape(b, hkv, t, dk).repeat_interleave(g, dim=1)
        vs = v.reshape(b, hkv, t, dv).repeat_interleave(g, dim=1)
        if window > 0:
            pos = torch.arange(t, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)

            def sdpa():
                return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)
        else:
            def sdpa():
                return F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        library = _time_ms(sdpa)
        device = _graph_ms(lambda: fa_kernel.flash_attention(q, k, v, **kw))
        library_device = _graph_ms(sdpa)
        flops = 2 * (dk + dv) * bh * g * _visible_pairs(t, t, window)
        nbytes = (q.numel() + bh * g * t * dv + k.numel() + v.numel()) * 2
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        out[name] = dict(q_shape=(bh, g, t, dk), v_shape=(bh, t, dv), window=window,
                         kernel=FLASH_FWD_KERNELS[d],
                         ms=kern, ffma_ms=ffma,
                         plain_ms=plain, plain_slices=-(-bh // step), library_ms=library,
                         library_backend=_sdpa_backend(sdpa), vs_library=kern / library,
                         device_ms=device, library_device_ms=library_device,
                         vs_library_device=device / library_device, flop=flops,
                         bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                         vs_bound=device / bound_ms, tflop_s=flops / device / 1e9)
        del q, k, v, qs, ks, vs
        torch.cuda.empty_cache()
    return out


def time_tile_matmul_grad(tm_kernel, tile_matmul_ref, arch: str = "smollm_360m") -> dict:
    """The gradient products of one ``arch`` layer's projections at M =
    4096, bf16: dx = dz @ w^T and dw = x^T @ dz, by CUDA events (``ms``,
    kernel and ``torch.matmul`` on the same transposed views in turns) and
    by CUDA-graph replay (``device_ms``), each product apart and both
    together. A layer with a fused activation (``SERVED_LAYER``'s) also
    times ``z``: the float32 product (with its bias) that each such
    product's backward launches, against ``torch.addmm`` (or
    ``torch.matmul``) of the same bf16 operands, which writes bf16."""
    dt, m = torch.bfloat16, BATCH * PROMPT
    layer = LAYER[arch] if arch in LAYER else tuple(l[:3] for l in SERVED_LAYER[arch])
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
    fused = [i for i, (_, _, act) in enumerate(layer) if act != "none"]
    if arch in SERVED_LAYER and fused:
        bias = {i: _randn((layer[i][1],), dt, 90 + i, 0.1) if SERVED_LAYER[arch][i][3] else None
                for i in fused}

        def z_run(f):
            return [f(ops[i][0], ops[i][1], bias[i]) for i in fused]

        z_kern = lambda: z_run(lambda x, w, b: tm_kernel.tile_matmul(  # noqa: E731
            x, w, b, out_dtype=torch.float32))
        z_lib = lambda: z_run(lambda x, w, b: torch.matmul(x, w) if b is None  # noqa: E731
                              else torch.addmm(b, x, w))
        turns = [_time_ms(f) for f in (z_kern, z_lib) * 2]
        flops = sum(2 * m * layer[i][0] * layer[i][1] for i in fused)
        nbytes = sum((m * layer[i][0] + layer[i][0] * layer[i][1]) * 2 + m * layer[i][1] * 4
                     for i in fused)
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        kern_ms, lib_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
        out["z"] = dict(products=fused, ms=kern_ms, library_ms=lib_ms, turns_ms=turns,
                        device_ms=_graph_ms(z_kern, iters=5),
                        plain_ms=_time_ms(lambda: z_run(lambda x, w, b: tile_matmul_ref(
                            x, w, b, out_dtype=torch.float32)), iters=5),
                        flop=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                        tflop_s=flops / kern_ms / 1e9)
    return out


# One layer's attention backward at each trained config's training shape,
# bf16, causal: (batch, kv heads, G, T, D, window).
FLASH_BWD_TIMED = {"smollm_360m": (BATCH, 5, 3, PROMPT, 64, 0),
                   "h2o_danube_1_8b": (2, 8, 4, 8192, 80, 4096),
                   "gemma3_12b global": (2, 8, 2, 2048, 256, 0),
                   "gemma3_12b local": (2, 8, 2, 2048, 256, 1024),
                   "qwen2_moe_a2_7b": (8, 16, 1, 1024, 128, 0),
                   "deepseek_v2_lite_16b": (8, 16, 1, 1024, (192, 128), 0),
                   "musicgen_medium": (BATCH, 24, 1, PROMPT, 64, 0),
                   "internvl2_76b": (BATCH, 8, 8, PROMPT, 128, 0),
                   # the ACAN twin's layer (float32, ffma): 2 x 4 heads, 32 tokens
                   "deepseek_v2_lite_16b reduced": (2, 4, 1, 32, (24, 16), 0)}


def time_flash_bwd(fa_kernel, flash_attention_bwd_ref) -> dict:
    """One layer's attention backward at each shape of ``FLASH_BWD_TIMED``,
    bf16: the mma path by CUDA events (``ms``) and graph replay
    (``device_ms``), the ffma path on the same inputs once (``ffma_ms``),
    the explicit plain formula (in batch x kv-head slices where its scores
    would not fit at once), each of the two kernels' device time a launch
    from a profiler trace (``dq_ms``, ``dkv_ms``), and SDPA's backward with
    K/V repeated to every query head (``library_ms``): at smollm's shape its
    flash backward op from the forward's own outputs (also by graph replay,
    ``library_device_ms``); at the dense configs' the backward alone of an
    SDPA call under autograd, a window as a boolean mask
    (``library_backend`` says which kernel SDPA took), and at gemma3's
    global layer and deepseek's (192, 128) also cuDNN's backward op by graph
    replay (``library_device_ms``; ``library_error`` where no backend takes
    the shape). The reduced deepseek pair (24, 16) in float32, the dtype its
    ACAN twin trains in (``ms`` and ``ffma_ms`` both the ffma path). Work:
    the five products of the function, 2 D operations each a visible
    (query, key) pair at q/k head dim D (S, dQ, dK) or v head dim Dv (dP,
    dV)."""
    out = {}
    for name, (b, hkv, g, t, d, window) in FLASH_BWD_TIMED.items():
        bh, (dk, dv) = b * hkv, _dims(d)
        dt = torch.float32 if d in FLASH_FFMA_PAIRS else torch.bfloat16
        q = _randn((bh, g, t, dk), dt, 1)
        k = _randn((bh, t, dk), dt, 2)
        v = _randn((bh, t, dv), dt, 3)
        do = _randn((bh, g, t, dv), dt, 4)
        kw = dict(causal=True, window=window)
        o, lse = fa_kernel.flash_attention(q, k, v, return_lse=True, **kw)

        def kern_bwd(**extra):
            return fa_kernel.flash_attention_bwd(q, k, v, o, do, lse, **kw, **extra)

        kern = _time_ms(kern_bwd)
        ffma = _time_ms(lambda: kern_bwd(path="ffma"), iters=2)
        device = _graph_ms(kern_bwd, iters=5)
        names = FLASH_BWD_KERNELS[d]
        traced = _traced_ms(kern_bwd, names, iters=3)
        step = max(1, _plain_step(bh, g, t, t) // PLAIN_BWD_SCORES)
        plain = _time_ms(lambda: [flash_attention_bwd_ref(q[i:i + step], k[i:i + step],
                                                          v[i:i + step], o[i:i + step],
                                                          do[i:i + step], lse[i:i + step], **kw)
                                  for i in range(0, bh, step)], iters=2)
        qs = q.reshape(b, hkv * g, t, dk)
        ks = k.reshape(b, hkv, t, dk).repeat_interleave(g, dim=1)
        vs = v.reshape(b, hkv, t, dv).repeat_interleave(g, dim=1)
        dos = do.reshape(b, hkv * g, t, dv)
        extra = {}
        if name == "smollm_360m":
            aten = torch.ops.aten
            fwd = aten._scaled_dot_product_flash_attention(qs, ks, vs, 0.0, True, False)
            out_f, lse_f, cq, ck, mq, mk, seed, offset = fwd[:8]

            def sdpa_bwd():
                return aten._scaled_dot_product_flash_attention_backward(
                    dos, qs, ks, vs, out_f, lse_f, cq, ck, mq, mk, 0.0, True, seed, offset)

            extra["library_device_ms"] = _graph_ms(sdpa_bwd, iters=5)
        else:
            leaves = [x.detach().requires_grad_() for x in (qs, ks, vs)]
            if window > 0:
                pos = torch.arange(t, device="cuda")
                mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
                sdpa_out = F.scaled_dot_product_attention(*leaves, attn_mask=mask)
            else:
                sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=True)

            def sdpa_bwd():
                return torch.autograd.grad(sdpa_out, leaves, dos, retain_graph=True)

            extra["library_backend"] = _sdpa_backend(sdpa_bwd)
            if window == 0 and dt == torch.bfloat16:
                # The same cuDNN backward by graph replay: its op called on
                # its own forward's outputs (autograd.grad fails under capture).
                aten = torch.ops.aten
                try:
                    fwd = aten._scaled_dot_product_cudnn_attention(qs, ks, vs, None, True, 0.0,
                                                                   True, False)
                    out_c, lse_c, cq, ck, mq, mk, seed, offset = fwd[:8]

                    def cudnn_bwd():
                        return aten._scaled_dot_product_cudnn_attention_backward(
                            dos, qs, ks, vs, out_c, lse_c, seed, offset, None, cq, ck, mq, mk,
                            0.0, True)

                    extra["library_device_ms"] = _graph_ms(cudnn_bwd, iters=5)
                    del fwd, out_c, lse_c
                except RuntimeError as e:  # a shape cuDNN's op does not take
                    extra["library_device_ms"] = None
                    extra["library_device_error"] = str(e).splitlines()[0][:200]
        library = _time_ms(sdpa_bwd, iters=5)
        flops = 2 * (3 * dk + 2 * dv) * bh * g * _visible_pairs(t, t, window)
        nbytes = 2 * (q.numel() + do.numel() + k.numel() + v.numel()) * q.element_size() \
            + lse.numel() * 4
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        out[name] = dict(q_shape=(bh, g, t, dk), v_shape=(bh, t, dv), dtype=str(dt),
                         window=window, kernels=names, ms=kern,
                         ffma_ms=ffma, device_ms=device, dq_ms=traced[names[0]],
                         dkv_ms=traced[names[1]], device_tflop_s=flops / device / 1e9,
                         traces=traced["traces"], traced_launches=traced["traced_launches"],
                         plain_ms=plain, plain_slices=-(-bh // step), library_ms=library,
                         vs_library=kern / library, flop=flops, bytes=nbytes,
                         bound_ms=bound_ms, bound_by=bound_by, vs_bound=device / bound_ms,
                         tflop_s=flops / kern / 1e9, **extra)
        del q, k, v, do, o, lse, qs, ks, vs, dos
        sdpa_bwd = sdpa_out = leaves = None
        torch.cuda.empty_cache()
    return out


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
# Served only (no backward on the card at this width): jamba's prefill scan.
SSD_SERVED_CASES = (("jamba", *SSD_JAMBA),)


def check_ssd(ssd_kernel, ssd_plain) -> dict:
    """Kernel vs the per-timestep plain version: y and the final state, at
    the paths' shapes (mamba2's and jamba's, 32 heads a group), a ragged T
    and G > 1: the mma path in bf16, the ffma path in float32. ``by_case``:
    each case's worst y error."""
    err: dict = {"by_case": {}}
    fn = ssd_kernel.ssd_scan
    for dtype in (torch.bfloat16, torch.float32):
        worst = {"y": 0.0, "state": 0.0}
        for name, *shape in SSD_CASES + SSD_SERVED_CASES:
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
            err["by_case"][f"{name} {dtype}"] = (y.float() - yr.float()).abs().max().item()
            worst["y"] = max(worst["y"], err["by_case"][f"{name} {dtype}"])
            worst["state"] = max(worst["state"], (s - sr).abs().max().item())
            del args, y, s, yr, sr
        err[str(dtype)] = err[DTYPE_PATH[dtype]] = worst
    torch.cuda.synchronize()
    return err


def time_ssd(ssd_kernel, ssd_plain, shape: tuple = SSD_PATH) -> dict:
    """One layer's prefill scan at ``shape`` (mamba2_2_7b's by default;
    ``SSD_JAMBA``), bf16. Operations are the
    function's own work, whatever the algorithm's chunk: the recurrence's
    state update and readout, 2 N P each a (batch, head, step); bytes read
    each input and write each output once. Bound under the bf16 tensor-core
    peak (the least time the card could take) and under the float32 FFMA
    peak the ffma path computes at. ``ms`` is the mma path, ``ffma_ms`` the
    ffma path on the same bf16 inputs, ``device_ms`` the mma path by
    CUDA-graph replay. No single PyTorch call computes an SSD scan: no
    library time."""
    bt, t, h, p, g, n = shape
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
    return dict(shape=f"x {(bt, t, h, p)}, G {g}, N {n}", ms=kern, ffma_ms=ffma,
                device_ms=device, plain_ms=plain, library_ms=None, flop=flops, bytes=nbytes,
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
                head_sum_ms=traced["ssd_bwd_reduce"], traces=traced["traces"],
                traced_launches=traced["traced_launches"], plain_ms=plain, library_ms=None,
                flop=flops, bytes=nbytes, states_bytes=states_bytes, bound_ms=bound_ms,
                bound_by=bound_by)


def _zero(counters: dict) -> None:
    for fn in counters.values():
        fn.launches = 0
        for per in (getattr(fn, "paths", {}), getattr(fn, "layouts", {}),
                    getattr(fn, "outputs", {})):
            for key in per:
                per[key] = 0


def _read(counters: dict) -> dict:
    return {k: fn.launches for k, fn in counters.items()}


def serve_path(serve, M, cfg, params, counters: dict, batch: int = BATCH,
               prompt_len: int = PROMPT, cache_len: int = CACHE,
               want_paths: dict | None = None) -> dict:
    """Serve ``cfg`` at full width and the depth of ``params`` through
    ``serve``: a short warm-up serve first, so the timed run holds no
    first-call set-up, then the timed run with every launch count set to 0
    just before it and read just after. ``want_paths``: tile_matmul's
    launches by path, where not every product is a bf16 projection (by
    default each takes wgmma in prefill and skinny in decode). The tokens
    are one a step, or one a codebook a step, below the vocab."""
    kw = dict(reduced=False, batch=batch, prompt_len=prompt_len, cache_len=cache_len,
              seed=0, device="cuda", params=params)
    serve(cfg.name, gen=2, log=lambda _: None, **kw)
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    res = serve(cfg.name, gen=GEN, **kw)
    launches = _read(counters)
    by_path = {k: dict(fn.paths) for k, fn in counters.items() if hasattr(fn, "paths")}
    paths = by_path["tile_matmul"]
    peak = torch.cuda.max_memory_allocated()
    toks = res["tokens"]
    assert toks.shape == (batch, GEN) + _books(cfg), toks.shape
    assert ((toks >= 0) & (toks < cfg.vocab)).all()
    out = dict(arch=cfg.name, batch=batch, prompt_len=prompt_len, gen=GEN,
               cache_len=cache_len, prefill_s=res["t_prefill"], decode_s=res["t_decode"],
               decode_tok_s=batch * GEN / res["t_decode"], peak_mem_bytes=peak,
               launches=launches, tile_matmul_paths=paths, launches_by_path=by_path,
               params=M.param_count(cfg))
    print(f"serve {cfg.name}: prefill {batch}x{prompt_len} {res['t_prefill']:.4f} s, decode "
          f"{out['decode_tok_s']:.1f} tok/s, peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}, by path {by_path}")
    # Every bf16 projection takes wgmma in prefill and skinny in decode;
    # every bf16 prefill attention and scan takes mma.
    if want_paths is None:
        per_pass = launches["tile_matmul"] // (1 + GEN)
        want_paths = {"wgmma": per_pass, "mma": 0, "skinny": per_pass * GEN, "ffma": 0}
    assert paths == want_paths, (paths, want_paths)
    for k in ("flash_attention", "ssd_scan"):
        assert by_path[k] == {"mma": launches[k], "ffma": 0}, (k, by_path[k])
    return out


def _books(cfg) -> tuple:
    """The trailing axis of a codebooks config's tokens, (K,); else ()."""
    return (cfg.n_codebooks,) if cfg.frontend == "codebooks" else ()


def profile_steps(M, cfg, params, rehome, counters: dict, batch: int = BATCH,
                  prompt_len: int = PROMPT, cache_len: int = CACHE) -> dict:
    """One prefill (``batch`` x ``prompt_len``) and one decode step of the
    served model: host wall time without tracing (median of 3), device
    kernel time from a torch.profiler trace of one more run, their ratio as
    the device's busy share, the kernels that take the most device time, and
    the launches of the traced run. The inputs are the frontend's
    (``serve``'s ``prompt_inputs`` and ``step_inputs``), drawn from seed 2."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import pick, prompt_inputs, step_inputs

    rng = np.random.default_rng(2)
    prompt = prompt_inputs(cfg, rng, batch, prompt_len, "cuda")
    small, logits = M.prefill(params, cfg, prompt)
    cache = rehome(M.init_cache(cfg, batch, cache_len, "cuda"), small)
    del small
    step = step_inputs(cfg, pick(cfg, logits, True, None), rng, "cuda") | {"cur_len": prompt_len}
    fns = {"prefill": lambda: M.prefill(params, cfg, prompt),
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


def _f32_logits(M, cfg, rehome, prompt_len: int, batch: int, wrap=None,
                decode_steps: int = 4) -> tuple[list, list]:
    """Full-width float32 logits of ``cfg`` on the card (kernel path) and
    on the CPU (plain path) from the same seeded weights: a prefill of
    ``batch`` x ``prompt_len`` positions, then ``decode_steps`` decode steps
    of the CPU's greedy tokens (one a codebook), or of fresh embeddings; the frontend's
    inputs as ``serve`` draws them, from seed 1, the same on both devices.
    ``wrap(device, call)`` (optional) runs each forward pass. Returns
    (card's logits, CPU's logits), one entry a pass."""
    from repro_torch.launch.serve import pick, prompt_inputs, step_inputs

    wrap = wrap or (lambda _dev, call: call())
    # A float32 config: the embeds frontend casts its inputs to the model's
    # dtype (the token frontends take the table's); nothing else reads it.
    cfg = dataclasses.replace(cfg, param_dtype="float32")
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda",
                           dtype_override=torch.float32)
    rng = np.random.default_rng(1)
    prompt = prompt_inputs(cfg, rng, batch, prompt_len, "cpu")
    runs = {}

    def prefill(dev, p):
        caches, logits = wrap(dev, lambda: M.prefill(p, cfg, _to(prompt, dev)))
        cache = rehome(M.init_cache(cfg, batch, prompt_len + 8, dev, dtype=torch.float32),
                       caches)
        runs[dev] = (p, cache, [logits.cpu()])

    plain, card = _card_beside_host(prefill, params)
    prefill("cpu", plain)
    card()
    for step in range(decode_steps):
        inputs = step_inputs(cfg, pick(cfg, runs["cpu"][2][-1], True, None), rng, "cpu")
        for dev, (p, cache, outs) in runs.items():
            logits, _ = wrap(dev, lambda: M.decode_step(
                p, cfg, cache, _to(inputs, dev) | {"cur_len": prompt_len + step}))
            outs.append(logits.cpu())
    return runs["cuda"][2], runs["cpu"][2]


def parity_f32(M, cfg, rehome, prompt_len: int, batch: int = 2, tol: float = 1e-3) -> float:
    """Full-width float32 logits of ``cfg``: kernel path on the card vs the
    plain path on the CPU, prefill of ``batch`` x ``prompt_len`` tokens then
    4 decode steps, held at ``tol`` (relative and absolute)."""
    worst = 0.0
    for got, want in zip(*_f32_logits(M, cfg, rehome, prompt_len, batch)):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        worst = max(worst, (got - want).abs().max().item())
    return worst


# The dense-attention configs (gemma3_12b: sliding window, qk-norm,
# sandwich norms, embeddings scaled by sqrt(d), D 256; h2o_danube_1_8b:
# window 4096, D 80; command_r_plus_104b: parallel residual, G 12), each
# served at full width: its serving run (batch, prompt, decode cache), its
# depth (all of it, but command_r's 64 layers, 208 GB in bf16, are cut to 8)
# and its float32 parity run (periods kept, batch, prompt; each prompt longer
# than the window, so the ring runs at full width). gemma3's parity run keeps
# one local and one global layer; command_r's one layer (6.3 GB in float32,
# beside a 12.6 GB embedding). Then the two frontends: musicgen_medium
# (codebooks: (B, T, 4) prompts, a token a codebook a step; MHA at D 64, the
# GELU FFN with biases) at full depth, and internvl2_76b (embeds: seeded
# (B, T, d) prompts and a fresh (B, d) embedding a step; G 8, D 128) cut from
# 80 to 16 layers; its parity run one layer (3.4 GB in float32, beside a
# 4.2 GB head).
DENSE_SERVE = {
    "gemma3_12b": dict(run=dict(batch=4, prompt_len=2048, cache_len=4096), n_periods=None,
                       parity_periods=1, parity=dict(batch=2, prompt_len=1280)),
    "h2o_danube_1_8b": dict(run=dict(batch=2, prompt_len=8192, cache_len=8224),
                            n_periods=None, parity_periods=2,
                            parity=dict(batch=1, prompt_len=4608)),
    "command_r_plus_104b": dict(run=dict(batch=BATCH, prompt_len=PROMPT, cache_len=CACHE),
                                n_periods=8, parity_periods=1,
                                parity=dict(batch=2, prompt_len=256)),
    "musicgen_medium": dict(run=dict(batch=BATCH, prompt_len=PROMPT, cache_len=CACHE),
                            n_periods=None, parity_periods=2,
                            parity=dict(batch=2, prompt_len=512)),
    "internvl2_76b": dict(run=dict(batch=BATCH, prompt_len=PROMPT, cache_len=CACHE),
                          n_periods=16, parity_periods=1, parity=dict(batch=2, prompt_len=256),
                          reduced_why="80 layers are 139 GB in bf16; the init draws each "
                                      "stacked leaf whole in float32 (15 GB for w_gate "
                                      "at 16 layers), so 24 layers' FFN leaves would not "
                                      "fit 80 GB while w_down is drawn; 16 layers are "
                                      "14.74 B parameters, 29.5 GB"),
}
DENSE_PARITY_TOL = 1e-4


def _leaves(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in (tree.values() if isinstance(tree, dict) else tree) for t in _leaves(v)]


def _layer_projections(M, cfg) -> list[tuple[int, int, str, torch.dtype, bool]]:
    """(K, N, activation, dtype, bias) of each 2-D product of each distinct
    layer of ``cfg``, from the model's parameter specs: the prefix layers'
    2-D weights, the period layers' (stacked on n_periods), and MLA's
    up-projections ``w_uk`` / ``w_uv`` (R, H, D), multiplied as (R, H D).
    The SwiGLU gate's SiLU and the GELU FFN's GELU (on ``w_up``) are fused
    into their products, and a weight ``w_x`` / ``wx`` with a bias ``b_x``
    / ``bx`` beside it adds it in the epilogue; expert tensors (the batched
    launch's) and a Mamba mixer's depthwise conv kernels are left out."""
    out = []

    def walk(tree, stacked: int, acts: dict):
        for key, v in tree.items():
            if isinstance(v, dict):
                walk(v, stacked, acts)
                continue
            shape = v.shape[stacked:]
            if key.startswith("conv"):       # a Mamba mixer's depthwise conv: plain
                continue
            if key in ("w_uk", "w_uv"):
                shape = (shape[0], shape[1] * shape[2])
            if len(shape) == 2:
                out.append((shape[0], shape[1], acts.get(key, "none"), v.dtype,
                            f"b{key[1:]}" in tree))

    def acts(lcfg) -> dict:
        gelu = lcfg.ffn_kind == "dense" and lcfg.dense.kind == "gelu"
        return {"w_gate": "silu"} | ({"w_up": "gelu"} if gelu else {})

    specs = M.param_specs(cfg)
    for lcfg, spec in zip(cfg.prefix, specs["prefix"]):
        walk(spec, 0, acts(lcfg))
    for lcfg, spec in zip(cfg.period, specs["period"]):
        walk(spec, 1, acts(lcfg))
    return sorted(set(out), key=str)


def check_dense_projections(tm_kernel, tile_matmul_ref, M, get_config) -> dict:
    """tile_matmul against its plain version at each 2-D product of the
    dense configs, of musicgen_medium and internvl2_76b, of
    deepseek_v2_lite_16b and of jamba_1_5_large_398b, with their
    activations and biases, at their prefill M (bf16 on wgmma, the float32
    router on ffma) and decode M (skinny): the first launches at K 12288
    and 33792 (command_r's widths), N 10944 and 576 (deepseek's dense first
    layer and ``w_dkv``), K 512 (its up-projections of the latent),
    musicgen's bias and GELU epilogue (1536 -> 6144 and back), internvl2's
    N and K 28672, and jamba's Mamba projections (N 16384, 1024 and 256; K
    16384) and 16-expert router."""
    err, paths = {}, tm_kernel.tile_matmul.paths
    runs = {arch: spec["run"] for arch, spec in DENSE_SERVE.items()} | {DEEPSEEK: DEEPSEEK_RUN,
                                                                          JAMBA: JAMBA_RUN}
    for arch, run in runs.items():
        for m, path in ((run["batch"] * run["prompt_len"], "wgmma"), (run["batch"], "skinny")):
            for k, n, act, dtype, bias in _layer_projections(M, get_config(arch)):
                x = _randn((m, k), dtype, m + k)
                w = _randn((k, n), dtype, n, k ** -0.5)
                b = _randn((n,), dtype, k + 1) if bias else None
                before = dict(paths)
                out = tm_kernel.tile_matmul(x, w, b, activation=act)
                _took(tm_kernel.tile_matmul,
                      "ffma" if dtype == torch.float32 and path == "wgmma" else path, before)
                ref = tile_matmul_ref(x, w, b, activation=act)
                torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype],
                                           atol=TOL[dtype],
                                           msg=lambda e, c=(arch, m, k, n): f"{c}: {e}")
                key = f"{arch} {m}x{k}x{n}{' ' + act if act != 'none' else ''}" \
                      f"{' bias' if bias else ''} {dtype}"
                err[key] = (out.float() - ref.float()).abs().max().item()
                del x, w, b, out, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return err


def dense_serve(serve, M, rehome, get_config, arch: str, counters: dict) -> dict:
    """Serve ``arch`` at full width through ``serve`` from seeded random
    weights, as ``DENSE_SERVE`` sizes it: every launch counted (tile_matmul
    once for each weight matrix of each layer, a forward pass, prefill and
    every decode step; flash_attention once a layer in prefill and never in
    decode; no other kernel), one prefill and one decode step profiled, then
    float32 logits of the kernel path against the CPU's at
    ``DENSE_PARITY_TOL``, the depth cut to the parity run's layers."""
    spec = DENSE_SERVE[arch]
    cfg = get_config(arch)
    if spec["n_periods"] is not None:
        cfg = dataclasses.replace(cfg, n_periods=spec["n_periods"])
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    # Each layer's weight matrices: one tile_matmul launch each a forward pass.
    projections = sum(t.dim() == 2 for t in _leaves((params["prefix"], params["period"])))
    out = serve_path(serve, M, cfg, params, counters, **spec["run"])
    want = dict.fromkeys(counters, 0) | {"tile_matmul": projections * (1 + GEN),
                                         "flash_attention": cfg.n_layers}
    assert out["launches"] == want, (out["launches"], want)
    prof = out["profile"] = profile_steps(M, cfg, params, rehome, counters, **spec["run"])
    _print_profile(cfg.name, prof)
    for phase, flash in (("prefill", cfg.n_layers), ("decode", 0)):
        assert prof[phase]["launches"] == want | {"tile_matmul": projections,
                                                  "flash_attention": flash}, prof[phase]
    out.update(layers=cfg.n_layers, projections=projections,
               param_bytes=sum(t.numel() * t.element_size()
                               for t in _leaves(params)))
    if spec["n_periods"] is not None:
        full = get_config(arch)
        out["reduced"] = {"n_periods": f"{full.n_periods} -> {cfg.n_periods}"}
        if "reduced_why" in spec:
            out["reduced_why"] = spec["reduced_why"]
    del params
    torch.cuda.empty_cache()
    pcfg = _parity_config(get_config(arch), spec["parity_periods"])
    out["parity_f32"] = dict(layers=pcfg.n_layers, **spec["parity"])
    out["parity_f32_max_err"] = parity_f32(M, pcfg, rehome, tol=DENSE_PARITY_TOL,
                                           **spec["parity"])
    print(f"parity f32 {arch} full width, {pcfg.n_layers} layers, "
          f"{spec['parity']['batch']}x{spec['parity']['prompt_len']}: max |logit err| "
          f"{out['parity_f32_max_err']:.3e}")
    torch.cuda.empty_cache()
    return out


def _parity_config(cfg, n_periods: int):
    """``cfg`` at full width with ``n_periods`` repetitions of its period,
    a mixed period cut to its first and last layers (gemma3: one local, one
    global)."""
    return dataclasses.replace(cfg, period=tuple(dict.fromkeys((cfg.period[0],
                                                                cfg.period[-1]))),
                               n_periods=n_periods)


def serve_gemma3(serve, M, rehome, get_config, counters: dict) -> dict:
    """gemma3_12b at full width and depth: 48 layers, 5 local (window 1024)
    to 1 global, qk-norm, sandwich norms, head dim 256."""
    return dense_serve(serve, M, rehome, get_config, "gemma3_12b", counters)


def serve_danube(serve, M, rehome, get_config, counters: dict) -> dict:
    """h2o_danube_1_8b at full width and depth: 24 layers, window 4096,
    head dim 80, an untied head."""
    return dense_serve(serve, M, rehome, get_config, "h2o_danube_1_8b", counters)


def serve_command_r(serve, M, rehome, get_config, counters: dict) -> dict:
    """command_r_plus_104b at full width, 8 of its 64 layers: parallel
    residual blocks, G 12, K up to 33792."""
    return dense_serve(serve, M, rehome, get_config, "command_r_plus_104b", counters)


# qwen2_moe_a2_7b served at full width and full depth (24 layers, 28.6 GB
# in bf16): 8 x 1024 prompts (prefill T 8192: four groups of 2048 tokens,
# capacity 43 a slot, so tokens drop; 4 slots x 4 groups x 43 = 688 rows an
# expert) and 32 decode steps of T 8 (one group, dropless: 4 x 8 = 32 rows an
# expert). Its float32 parity run: 2 layers, 2 x 512 (one group of 1024,
# capacity 22: tokens drop). A token whose top-k set differs between the
# card and the CPU is a fault unless the CPU's margin between its k-th and
# (k+1)-th probabilities is below NEAR_TIE; the logits are held where none
# flipped.
QWEN2 = "qwen2_moe_a2_7b"
QWEN2_RUN = dict(batch=BATCH, prompt_len=1024, cache_len=1056)
QWEN2_ROWS = {"prefill": 688, "decode": 32}
QWEN2_PARITY = dict(batch=2, prompt_len=512)
QWEN2_PARITY_PERIODS = 2
NEAR_TIE = 1e-5
# deepseek_v2_lite_16b served at full width and full depth (27 layers: the
# dense first one, then 26 MoE layers; 31.4 GB in bf16), as qwen2 is: 8 x
# 1024 prompts (four groups of 2048, capacity 40 a slot; 6 slots x 4 groups
# x 40 = 960 rows an expert) and 32 decode steps of T 8 (dropless: 6 x 8 =
# 48 rows an expert). MLA: prefill attention at q/k head dim 192 and v head
# dim 128; decode in the latent space, plain PyTorch. Its float32 parity
# run: 2 layers (the dense one and one MoE layer), 2 x 512 (one group of
# 1024, capacity 20: tokens drop).
DEEPSEEK = "deepseek_v2_lite_16b"
DEEPSEEK_RUN = QWEN2_RUN
DEEPSEEK_ROWS = {"prefill": 960, "decode": 48}
# jamba_1_5_large_398b served at full width, cut from 72 layers to the first
# 4 of its period (``SERVED_CUT``: attention + dense FFN, Mamba + MoE, Mamba
# + dense, Mamba + MoE; 23.03 B parameters, 46.05 GB in bf16), since one
# period of 8 is 45.25 B (90.5 GB): 8 x 512 prompts (two groups of 2048,
# capacity 160 a slot; 2 slots x 2 groups x 160 = 640 rows an expert) and 32
# decode steps of T 8 (dropless: 2 x 8 = 16 rows an expert). Its float32
# parity run: layer 0 (attention + dense) and layer 7 (Mamba + MoE), 11.91 B
# parameters, 47.7 GB in float32 on each device, 2 x 128 (one group of 256,
# capacity 20 a slot, 40 rows an expert), at which rows the float32 batched
# launch is also checked, then 2 decode steps. Its random router spreads a
# group's tokens about evenly over the 16 experts: at 2 x 512 (capacity 80 a
# slot, 64 tokens a slot on average) no pair dropped, so the run is short
# enough that some do. The CPU's half takes most of the phase: the weights'
# 47.7 GB reach the host at the rate its first touch of fresh pages allows
# (about 4 GB/s), and a decode step streams them all through 2-row products
# (about 3 s).
JAMBA = "jamba_1_5_large_398b"
JAMBA_RUN = dict(batch=BATCH, prompt_len=PROMPT, cache_len=CACHE)
MOE_SERVE = {QWEN2: dict(run=QWEN2_RUN, rows=QWEN2_ROWS, parity=QWEN2_PARITY,
                         parity_periods=QWEN2_PARITY_PERIODS),
             DEEPSEEK: dict(run=DEEPSEEK_RUN, rows=DEEPSEEK_ROWS,
                            parity=dict(batch=2, prompt_len=512), parity_periods=1),
             JAMBA: dict(run=JAMBA_RUN, rows={"prefill": 640, "decode": 16},
                         f32_rows={"parity": 40, "decode": 16},
                         parity=dict(batch=2, prompt_len=128, decode_steps=2),
                         parity_periods=1,
                         served_cut=True,
                         reduced_why="72 layers are 398.6 B parameters; one period of 8 "
                                     "is 45.25 B (90.5 GB in bf16), more than one card "
                                     "holds; its first 4 layers (23.03 B, 46.05 GB) run "
                                     "every layer kind at full width")}


def _moe_layers(cfg) -> int:
    """The layers of ``cfg`` with an MoE FFN (deepseek's first is dense,
    every other one of jamba's)."""
    return (sum(l.ffn_kind == "moe" for l in cfg.prefix)
            + cfg.n_periods * sum(l.ffn_kind == "moe" for l in cfg.period))


def _moe_cfg(cfg):
    """The MoE FFN of ``cfg``'s MoE layers, the same in each of them."""
    (moe,) = {l.moe for l in (*cfg.prefix, *cfg.period) if l.ffn_kind == "moe"}
    return moe


def _expert_products(cfg) -> tuple[int, tuple]:
    """(E, ((K, N, activation) of the gate, up and down expert products))."""
    moe, d = _moe_cfg(cfg), cfg.d_model
    return moe.n_experts, ((d, moe.d_ff, "silu"), (d, moe.d_ff, "none"), (moe.d_ff, d, "none"))


def _moe_grad_operands(E: int, m: int, k: int, n: int, dtype) -> tuple:
    """(name, a, b, kwargs, layout) of the two gradient products of the
    expert product x (E, m, k) @ w (E, k, n): dx = dz @ w^T (w read where it
    lies) and dw = x^T @ dz (x read where it lies, the reduction over an
    expert's m rows)."""
    x = _randn((E, m, k), dtype, m + k)
    w = _randn((E, k, n), dtype, n, k ** -0.5)
    dz = _randn((E, m, n), dtype, 3, m ** -0.5)
    return (("dx", dz, w, dict(trans_w=True), "batched x@w^T"),
            ("dw", x, dz, dict(trans_x=True), "batched x^T@w"))


def check_moe_batched(tm_kernel, tile_matmul_ref, get_config) -> dict:
    """The batched expert launch against its plain version (one product an
    expert) at qwen2's, deepseek's and jamba's three expert products,
    prefill and decode rows (E 60 at 688 and 32 rows an expert, E 64 at 960
    and 48, E 16 at 640 and 16, where each weight tensor holds 3.22 B
    elements, past 2^31, so the last expert's offsets need 64 bits; jamba's
    float32 at its parity run's 40 rows and at 16), and its two gradient
    layouts at qwen2's training rows (688 an expert): bf16 on wgmma (2e-2),
    float32 on ffma (2e-4), each launch counted once under its layout
    (``batched``, ``batched x@w^T``, ``batched x^T@w``). Every expert's
    output is held, the last one's too."""
    fn, err = tm_kernel.tile_matmul, {}

    def held(out, ref, dtype, case, layout, before, layouts):
        _took(fn, {torch.bfloat16: "wgmma", torch.float32: "ffma"}[dtype], before)
        assert {q: fn.layouts[q] - layouts[q] for q in fn.layouts} == {
            q: int(q == layout) for q in fn.layouts}, fn.layouts
        torch.testing.assert_close(out.float(), ref.float(), rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=lambda e: f"{case}: {e}")
        err[case] = (out.float() - ref.float()).abs().max().item()

    for dtype in (torch.bfloat16, torch.float32):
        for arch, spec in MOE_SERVE.items():
            E, prods = _expert_products(get_config(arch))
            rows = spec["rows"] if dtype == torch.bfloat16 else spec.get("f32_rows", spec["rows"])
            for (phase, m), (k, n, act) in itertools.product(rows.items(), prods):
                x = _randn((E, m, k), dtype, m + k)
                w = _randn((E, k, n), dtype, n, k ** -0.5)
                before, layouts = dict(fn.paths), dict(fn.layouts)
                out = tm_kernel.tile_matmul(x, w, activation=act)
                ref = torch.stack([tile_matmul_ref(x[e], w[e], activation=act)
                                   for e in range(E)])
                held(out, ref, dtype, f"{phase} {E}x{m}x{k}x{n} {act} {dtype}", "batched",
                     before, layouts)
                del x, w, out, ref
        E, prods = _expert_products(get_config(QWEN2))
        m = QWEN2_ROWS["prefill"]
        for k, n in dict.fromkeys((k, n) for k, n, _ in prods):   # gate and up share one
            for name, a, b, kw, layout in _moe_grad_operands(E, m, k, n, dtype):
                before, layouts = dict(fn.paths), dict(fn.layouts)
                out = tm_kernel.tile_matmul(a, b, **kw)
                ref = torch.stack([tile_matmul_ref(a[e], b[e], **kw) for e in range(E)])
                held(out, ref, dtype, f"train {name} {E}x{m}x{k}x{n} {dtype}", layout, before,
                     layouts)
                del a, b, out, ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return err


def time_moe_batched(tm_kernel, tile_matmul_batched_ref, get_config, arch: str = QWEN2) -> dict:
    """One ``arch`` layer's three expert products (``MOE_SERVE``), bf16, at
    its prefill and decode rows: the batched launches by CUDA events (kernel
    and ``torch.bmm`` in turns) and by CUDA-graph replay, the plain version
    (one float32 product an expert), and the bound of the three products.
    The decode products read 1.04 GB (qwen2), 1.11 GB (deepseek) or 19.3 GB
    (jamba) of weights, twenty times the L2 or more: every launch finds them
    cold, as a decode step does."""
    dt, out = torch.bfloat16, {}
    E, prods = _expert_products(get_config(arch))
    for phase, m in MOE_SERVE[arch]["rows"].items():
        xs = {k: _randn((E, m, k), dt, k) for k in {k for k, _, _ in prods}}
        ws = [_randn((E, k, n), dt, 10 + i, k ** -0.5) for i, (k, n, _) in enumerate(prods)]

        def run(fn):
            return [fn(xs[k], w, act) for (k, _, act), w in zip(prods, ws)]

        def kern():
            return run(lambda x, w, a: tm_kernel.tile_matmul(x, w, activation=a))

        def lib():
            return run(lambda x, w, a: F.silu(torch.bmm(x, w)) if a == "silu" else torch.bmm(x, w))

        turns = [_time_ms(f, iters=10) for f in (kern, lib) * 2]
        kern_ms, lib_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
        flops = sum(2 * E * m * k * n for k, n, _ in prods)
        nbytes = sum(E * (m * k + k * n + m * n) * 2 for k, n, _ in prods)
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        device = _graph_ms(kern, iters=5)
        out[phase] = dict(shape=f"E {E}, M {m}, (K, N) {[(k, n) for k, n, _ in prods]}",
                          ms=kern_ms, device_ms=device,
                          plain_ms=_time_ms(lambda: run(lambda x, w, a: tile_matmul_batched_ref(
                              x, w, activation=a)), iters=2),
                          library_ms=lib_ms, library_device_ms=_graph_ms(lib, iters=5),
                          turns_ms=turns, vs_library=kern_ms / lib_ms, flop=flops,
                          bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                          vs_bound=device / bound_ms, tflop_s=flops / device / 1e9,
                          gb_s=nbytes / device / 1e6)
        del xs, ws
        torch.cuda.empty_cache()
    return out


def time_moe_batched_grad(tm_kernel, tile_matmul_batched_ref, get_config) -> dict:
    """The gradient products of one qwen2 layer's three expert products at
    the training rows (688 an expert), bf16, each layout's three launches
    together: dx = dz @ w^T (``x@w^T``) and dw = x^T @ dz (``x^T@w``), by
    CUDA events (kernel and ``torch.bmm`` on the transposed views in turns)
    and by CUDA-graph replay, the plain version (one float32 product an
    expert), and the bound: 714.2 GFLOP a layout, as the forward's."""
    dt, out = torch.bfloat16, {}
    E, prods = _expert_products(get_config(QWEN2))
    m = QWEN2_ROWS["prefill"]
    ops = [_moe_grad_operands(E, m, k, n, dt) for k, n, _ in prods]
    for i, layout in enumerate(("x@w^T", "x^T@w")):
        calls = [op[i][1:4] for op in ops]

        def kern():
            return [tm_kernel.tile_matmul(a, b, **kw) for a, b, kw in calls]

        def lib():
            return [torch.bmm(a.transpose(1, 2) if "trans_x" in kw else a,
                              b.transpose(1, 2) if "trans_w" in kw else b)
                    for a, b, kw in calls]

        turns = [_time_ms(f, iters=10) for f in (kern, lib) * 2]
        kern_ms, lib_ms = (turns[0] + turns[2]) / 2, (turns[1] + turns[3]) / 2
        flops = sum(2 * E * m * k * n for k, n, _ in prods)
        nbytes = sum(E * (m * k + k * n + m * n) * 2 for k, n, _ in prods)
        bound_ms, bound_by = _bound(flops, nbytes, dt)
        device = _graph_ms(kern, iters=5)
        out[layout] = dict(shape=f"E {E}, rows {m}, (K, N) {[(k, n) for k, n, _ in prods]}",
                           product=ops[0][i][0], ms=kern_ms, device_ms=device,
                           plain_ms=_time_ms(lambda: [tile_matmul_batched_ref(a, b, **kw)
                                                      for a, b, kw in calls], iters=1),
                           library_ms=lib_ms, library_device_ms=_graph_ms(lib, iters=5),
                           turns_ms=turns, vs_library=kern_ms / lib_ms, flop=flops,
                           bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                           vs_bound=device / bound_ms, tflop_s=flops / device / 1e9)
    del ops
    torch.cuda.empty_cache()
    return out


def _routing_flips(routes: dict, k: int) -> dict:
    """Tokens whose top-k set differs between the card's and the CPU's
    routing, layer by layer and pass by pass; a flip where the CPU's margin
    between its k-th and (k+1)-th probabilities is NEAR_TIE or more is a
    fault."""
    assert len(routes["cuda"]) == len(routes["cpu"]) > 0, {d: len(r) for d, r in routes.items()}
    flips, margins, checked = 0, [], 0
    for (_, got), (probs, want) in zip(routes["cuda"], routes["cpu"]):
        differ = (got.cpu().sort(-1).values != want.sort(-1).values).any(-1)
        top = probs.sort(-1, descending=True).values
        margin = top[:, k - 1] - top[:, k]
        checked += len(want)
        if differ.any():
            flips += int(differ.sum())
            margins += margin[differ].tolist()
    assert all(m < NEAR_TIE for m in margins), ("top-k flipped past a near-tie", margins)
    return dict(tokens_checked=checked, near_tie_flips=flips, flip_margins=margins)


def _dropped_pairs(routes: list, moe, tokens: int) -> list[int]:
    """The (token, slot) pairs past capacity in each layer of ``routes``
    ((probs, top-k ids) of ``tokens`` tokens each)."""
    from repro_torch.models.moe import capacity

    group, cap = capacity(moe, tokens)
    return [int((F.one_hot(top_i.reshape(tokens // group, group, -1), moe.n_experts).sum(1)
                 - cap).clamp(min=0).sum()) for _, top_i in routes]


def parity_moe_f32(M, cfg, rehome, prompt_len: int, batch: int, decode_steps: int = 4) -> dict:
    """Full-width float32 MoE model (qwen2, deepseek, jamba) on the card against
    the CPU: the routing of every MoE layer and pass first
    (``_routing_flips``), then the logits at DENSE_PARITY_TOL where no
    near-tie flipped. Also the (token, slot) pairs the CPU's prefill
    dropped, MoE layer by MoE layer (some must drop)."""
    from repro_torch.models.moe import capacity, recording_routes

    routes: dict = {"cuda": [], "cpu": []}

    def wrap(dev, call):
        with recording_routes() as seen:
            out = call()
        routes[dev] += seen
        return out

    got, want = _f32_logits(M, cfg, rehome, prompt_len, batch, wrap=wrap,
                            decode_steps=decode_steps)
    moe = _moe_cfg(cfg)
    out = _routing_flips(routes, moe.top_k)
    tokens = batch * prompt_len
    group, cap = capacity(moe, tokens)
    out.update(group=group, capacity=cap,
               dropped_in_prefill=_dropped_pairs(routes["cpu"][:_moe_layers(cfg)], moe, tokens))
    assert sum(out["dropped_in_prefill"]) > 0, out
    out["max_logit_err"] = None
    if out["near_tie_flips"] == 0:
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=DENSE_PARITY_TOL, atol=DENSE_PARITY_TOL)
        out["max_logit_err"] = max((g - w).abs().max().item() for g, w in zip(got, want))
    return out


def _routed_bounds(routes: list, cfg, param_bytes: int, embed_bytes: int) -> dict:
    """The bounds of one serve's MoE work as its routing needs it, beside
    those of the padded batched launches that do it. ``routes``: the
    serve's (probs, top-k ids) of every MoE layer, prefill first, then each
    decode step. A decode step needs only the experts its (token, slot)
    pairs route to (the launches read all of them); a prefill's expert products
    need only the kept (token, slot) rows (the launches multiply every
    capacity row, padding too). Bytes: each weight read once, each row read
    and written once; per layer, means over layers and steps."""
    from repro_torch.models.moe import capacity

    moe, d, L = _moe_cfg(cfg), cfg.d_model, _moe_layers(cfg)
    E, k, f = moe.n_experts, moe.top_k, moe.d_ff
    per_expert = 3 * d * f * 2                        # gate, up, down; bf16
    dense = param_bytes - embed_bytes - L * E * per_expert
    passes = [routes[i:i + L] for i in range(0, len(routes), L)]
    decode = [[len(torch.unique(top_i)) for _, top_i in p] for p in passes[1:]]
    decode_bytes = [dense + sum(n) * per_expert for n in decode]
    (_, t0), = {len(t): (None, t) for _, t in passes[0]}.values()    # one prefill T
    T = len(t0)
    group, cap = capacity(moe, T)
    rows = [int(F.one_hot(t.reshape(T // group, group, k), E).sum(1).clamp(max=cap).sum())
            for _, t in passes[0]]
    used = [len(torch.unique(t)) for _, t in passes[0]]
    prefill = [_bound(2 * r * 3 * d * f, u * per_expert + r * 3 * (d + f) * 2, torch.bfloat16)
               for r, u in zip(rows, used)]
    padded = E * k * (T // group) * cap
    n_decode = sum(map(sum, decode)) / (len(decode) * L)
    pairs = len(passes[1][0][1]) * k                  # (token, slot) rows a decode layer
    return dict(
        decode_experts_per_layer=n_decode,
        decode_experts_bound_ms=(n_decode * per_expert + pairs * 3 * (d + f) * 2)
        / PEAK_BYTES * 1e3,
        decode_bound_ms=sum(decode_bytes) / len(decode_bytes) / PEAK_BYTES * 1e3,
        decode_padded_bound_ms=(dense + L * E * per_expert) / PEAK_BYTES * 1e3,
        prefill_rows_kept_per_layer=sum(rows) / L, prefill_rows_padded_per_layer=padded,
        prefill_experts_bound_ms=sum(ms for ms, _ in prefill) / L,
        prefill_experts_bound_by=prefill[0][1],
        prefill_experts_padded_bound_ms=_bound(
            2 * padded * 3 * d * f, E * per_expert + padded * 3 * (d + f) * 2,
            torch.bfloat16)[0])


def _layer_weights(params) -> dict:
    """Each layer's weight tensors by how the forward pass multiplies them:
    ``attn`` the attention's 2-D matrices (one tile_matmul launch each, every
    pass), ``latent_up`` MLA's 3-D ``w_uk`` / ``w_uv`` (one launch each as an
    (R, H D) matrix, in prefill only), ``mamba`` a Mamba mixer's six
    projections ``w_z``, ``w_x``, ``w_B``, ``w_C``, ``w_dt``, ``w_out`` (one
    launch each, every pass; its 2-D depthwise conv kernels ``conv_*`` are
    plain PyTorch), ``ffn`` the FFN's bf16 2-D matrices (a dense FFN's or
    the shared experts'), ``router`` the float32 routers, ``experts`` the
    3-D expert tensors (one batched launch each)."""
    out = dict.fromkeys(("attn", "latent_up", "mamba", "ffn", "router", "experts"), 0)
    for layer in [*params["prefix"], *(p for per in params["period"] for p in per)]:
        for t in layer.get("attn", {}).values():
            out["attn"] += t.dim() == 2
            out["latent_up"] += t.dim() == 3
        out["mamba"] += sum(t.dim() == 2 and k.startswith("w_")
                            for k, t in layer.get("mamba", {}).items())
        for t in layer.get("ffn", {}).values():
            out["ffn"] += t.dim() == 2 and t.dtype == torch.bfloat16
            out["router"] += t.dim() == 2 and t.dtype == torch.float32
            out["experts"] += t.dim() == 3
    return out


# Each MoE config's weights by kind (``_layer_weights``), a layer of L
# (MoE layers Lm): qwen2's four attention projections, three shared-expert
# products; deepseek's three (wq, w_dkv, wo) and two up-projections, its
# dense first layer's three FFN products and the shared experts' three;
# jamba's cut: one attention layer's four projections, three Mamba layers'
# six each, the two dense FFNs' three each (layers 0 and 2).
MOE_WEIGHTS = {QWEN2: lambda L, Lm: dict(attn=4 * L, latent_up=0, mamba=0, ffn=3 * Lm,
                                         router=Lm, experts=3 * Lm),
               DEEPSEEK: lambda L, Lm: dict(attn=3 * L, latent_up=2 * L, mamba=0, ffn=3 * L,
                                            router=Lm, experts=3 * Lm),
               JAMBA: lambda L, Lm: dict(attn=4, latent_up=0, mamba=6 * (L - 1),
                                         ffn=3 * (L - Lm), router=Lm, experts=3 * Lm)}


def _host_available_bytes() -> int:
    """The host's MemAvailable, from /proc/meminfo."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def serve_moe(serve, M, rehome, get_config, counters: dict, arch: str) -> dict:
    """An MoE config (``MOE_SERVE``: qwen2_moe_a2_7b and deepseek_v2_lite_16b
    at full depth, jamba_1_5_large_398b at its ``SERVED_CUT``) at full width
    from seeded random weights (the init's seconds and peak memory kept):
    every launch counted, prefill and each decode step (tile_matmul once for
    each 2-D weight matrix of each layer, bf16 ones on wgmma in prefill and
    skinny in decode, the float32 router on ffma and skinny, MLA's two
    up-projections of the latent on wgmma in prefill only, and three batched
    expert launches an MoE layer on wgmma, never a launch an expert;
    flash_attention once an attention layer and ssd_scan once a Mamba layer
    in prefill, neither in decode; no other kernel), one prefill and one
    decode step profiled beside the bounds of the work the timed serve's
    routing needs and of the padded launches (``_routed_bounds``), then
    float32 routing and logits against the CPU (``_parity_config``: qwen2 at
    2 layers, deepseek's dense layer and one MoE layer, jamba's first and
    last layers of its period), the host's free memory read first."""
    from repro_torch.models.moe import recording_routes

    spec, full = MOE_SERVE[arch], get_config(arch)
    cfg = full
    if spec.get("served_cut"):
        cut = importlib.import_module(f"repro_torch.configs.{arch}").SERVED_CUT
        cfg = dataclasses.replace(full, **cut)
    L, Lm, mixers = cfg.n_layers, _moe_layers(cfg), _mixers(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    seconds, init_peak = {"init": time.perf_counter() - t0}, torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    w = _layer_weights(params)
    assert w == MOE_WEIGHTS[arch](L, Lm), (w, MOE_WEIGHTS[arch](L, Lm))
    E = _moe_cfg(cfg).n_experts
    x_w = w["attn"] + w["mamba"] + w["ffn"] + w["router"]   # plain 2-D launches, every pass
    prefill_paths = {"wgmma": x_w - w["router"] + w["latent_up"] + w["experts"], "mma": 0,
                     "skinny": 0, "ffma": w["router"]}
    decode_paths = {"wgmma": w["experts"], "mma": 0, "skinny": x_w, "ffma": 0}
    per_prefill, per_decode = sum(prefill_paths.values()), sum(decode_paths.values())
    with recording_routes() as routes:
        out = serve_path(serve, M, cfg, params, counters, **spec["run"],
                         want_paths={p: prefill_paths[p] + GEN * decode_paths[p]
                                     for p in prefill_paths})
    routes = routes[-(1 + GEN) * Lm:]                 # the timed serve's, after its warm-up
    layouts = dict(counters["tile_matmul"].layouts)
    seconds["serves"], t0 = time.perf_counter() - t0, time.perf_counter()
    by_mixer = {"flash_attention": mixers["attn"], "ssd_scan": mixers["mamba"]}
    want = dict.fromkeys(counters, 0) | {"tile_matmul": per_prefill + GEN * per_decode} | by_mixer
    assert out["launches"] == want, (out["launches"], want)
    assert layouts == dict.fromkeys(layouts, 0) | {
        "x@w": x_w * (1 + GEN) + w["latent_up"], "batched": w["experts"] * (1 + GEN)}, layouts
    prof = out["profile"] = profile_steps(M, cfg, params, rehome, counters, **spec["run"])
    _print_profile(cfg.name, prof)
    for phase, once, n, paths in (("prefill", 1, per_prefill, prefill_paths),
                                  ("decode", 0, per_decode, decode_paths)):
        assert prof[phase]["launches"] == want | {"tile_matmul": n} | {
            k: v * once for k, v in by_mixer.items()}, prof[phase]
        assert prof[phase]["tile_matmul_paths"] == paths, (phase, prof[phase])
    seconds["profile"] = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    embed_bytes = params["embed"]["tok"].numel() * 2
    out.update(layers=L, moe_layers=Lm, mixers=mixers, weights_by_kind=w, seconds=seconds,
               tile_matmul_layouts=layouts, param_bytes=param_bytes,
               expert_launches_per_layer=w["experts"] // Lm,
               params_active=M.active_param_count(cfg), init_peak_mem_bytes=init_peak,
               **_routed_bounds(routes, cfg, param_bytes, embed_bytes))
    if cfg is not full:
        out["reduced"] = {"layers": f"{full.n_layers} -> {cfg.n_layers}",
                          "period": f"{len(full.period)} -> {len(cfg.period)} (its first)",
                          "n_periods": f"{full.n_periods} -> {cfg.n_periods}"}
        out["reduced_why"] = spec["reduced_why"]
    print(f"serve {cfg.name}: {param_bytes / 1e9:.2f} GB of weights, drawn in "
          f"{seconds['init']:.1f} s at a peak of {init_peak / 2**30:.2f} GiB; "
          f"a decode step routes to "
          f"{out['decode_experts_per_layer']:.2f} experts a layer of {E}: its bytes bound "
          f"{out['decode_bound_ms']:.4f} ms, {out['decode_padded_bound_ms']:.4f} ms for the "
          f"padded launches, which read every expert; the step took "
          f"{prof['decode']['wall_ms']:.2f} ms (device {prof['decode']['device_ms']:.2f} ms). "
          f"Prefill keeps {out['prefill_rows_kept_per_layer']:.1f} of "
          f"{out['prefill_rows_padded_per_layer']} expert rows a layer: expert products bound "
          f"{out['prefill_experts_bound_ms']:.4f} ms a layer, "
          f"{out['prefill_experts_padded_bound_ms']:.4f} ms padded")
    del params, routes
    torch.cuda.empty_cache()
    pcfg = _parity_config(full, spec["parity_periods"])
    run = spec["parity"]
    f32_bytes = M.param_count(pcfg) * 4
    host = _host_available_bytes()
    assert host > 1.25 * f32_bytes, ("the host cannot hold the float32 parity weights",
                                     host, f32_bytes)
    t0 = time.perf_counter()
    par = out["parity_f32"] = dict(layers=pcfg.n_layers, f32_param_bytes=f32_bytes,
                                   host_available_bytes=host, **run) | parity_moe_f32(
        M, pcfg, rehome, **run)
    seconds["parity"] = time.perf_counter() - t0
    print(f"parity f32 {cfg.name} full width, {pcfg.n_layers} layers "
          f"({f32_bytes / 1e9:.1f} GB a device; host had {host / 1e9:.1f} GB free), "
          f"{run['batch']}x{run['prompt_len']} (group {par['group']}, "
          f"capacity {par['capacity']}, dropped {par['dropped_in_prefill']}): "
          f"{par['tokens_checked']} routings checked, {par['near_tie_flips']} near-tie flips, "
          f"max |logit err| {par['max_logit_err']}")
    torch.cuda.empty_cache()
    return out


# The reduced jamba_1_5_large_398b on the card (float32): served as the
# twin of examples/serve_batched.py serves its configs, then one train step
# of 2 x 64 tokens (eight dropless groups of 16) against the CPU's.
JAMBA_REDUCED_RUN = dict(batch=4, prompt_len=32, gen=8, cache_len=40, seed=0)
JAMBA_REDUCED_TRAIN = dict(batch=2, seq=64)


def _tokens_against_cpu(card: np.ndarray, cpu: np.ndarray, margins: np.ndarray) -> dict:
    """The card's greedy tokens against the CPU's: equal, or first differing
    at a pick where the CPU's top-2 margin is below NEAR_TIE."""
    rec = dict(tokens_equal=bool((card == cpu).all()), min_top2_margin=float(margins.min()))
    if not rec["tokens_equal"]:
        diff = np.argwhere(card != cpu)
        first = diff[:, 1].min()
        at = [tuple(int(i) for i in d) for d in diff if d[1] == first]
        rec.update(first_diff_step=int(first), first_diff=at,
                   margin_at_first_diff=max(float(margins[d]) for d in at))
        assert rec["margin_at_first_diff"] < NEAR_TIE, rec
    return rec


def reduced_jamba(serve, M, rehome, steps_mod, get_config, counters: dict) -> dict:
    """The reduced jamba_1_5_large_398b on the card in float32 (tile_matmul
    on ffma and skinny, the batched expert launch on ffma, the attention and
    the scan on ffma): ``serve`` from the seeded init, every launch count set
    to 0 just before it and read just after, tile_matmul's by path as the
    same serve's products on the CPU predict them (``_predicted_paths``),
    flash_attention once an attention layer and ssd_scan once a Mamba layer;
    its tokens against the CPU's (``_tokens_against_cpu``). Then one float32
    train step against the CPU's, routing first (``parity_train_moe_f32``,
    dropless at group 16 = 4E), whose launches on the card are
    ``_train_want``'s a step, every one on ffma: ssd_scan_bwd at G 2 beside
    the attention's and the experts' gradients in one model; and
    ``remat_determinism`` in float32 on the same batch size, every layer
    kind's gradients under "dots" (the scan's outputs and the router's
    product kept, the top-k recomputed from it) those of "nothing"."""
    cfg = get_config(JAMBA, reduced=True)
    run, mixers = JAMBA_REDUCED_RUN, _mixers(cfg)
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    cpu_params = _to(params, "cpu")
    quiet = dict(reduced=True, log=lambda _: None, **run)
    torch.cuda.synchronize()
    _zero(counters)
    res = serve(JAMBA, device="cuda", params=params, **quiet)
    torch.cuda.synchronize()
    launches = _read(counters)
    by_path = {k: dict(fn.paths) for k, fn in counters.items() if hasattr(fn, "paths")}
    del params
    ref, paths = _predicted_paths(lambda: serve(JAMBA, device="cpu", params=cpu_params, **quiet))
    assert set(p for p, n in paths.items() if n) <= {"ffma", "skinny"}, paths
    want = dict.fromkeys(counters, 0) | {"tile_matmul": sum(paths.values()),
                                         "flash_attention": mixers["attn"],
                                         "ssd_scan": mixers["mamba"]}
    assert launches == want, (launches, want)
    assert by_path["tile_matmul"] == paths, (by_path["tile_matmul"], paths)
    for k, n in (("flash_attention", mixers["attn"]), ("ssd_scan", mixers["mamba"])):
        assert by_path[k] == {"mma": 0, "ffma": n}, (k, by_path[k])
    card, cpu = res["tokens"], ref["tokens"]
    assert card.shape == cpu.shape == (run["batch"], run["gen"]), card.shape
    margins = _cpu_margins(M, rehome, cfg, cpu_params, cpu, run).numpy()
    out = dict(settings=run, layers=cfg.n_layers, mixers=mixers, launches=launches,
               launches_by_path=by_path, **_tokens_against_cpu(card, cpu, margins))
    out["seconds"] = {"serve": time.perf_counter() - t0}
    t0 = time.perf_counter()
    print(f"reduced {JAMBA} on the card: tokens {card.shape} equal to the CPU's "
          f"{out['tokens_equal']}, launches {launches}, tile_matmul by path {paths}")
    _zero(counters)
    par = out["train_step_f32"] = parity_train_moe_f32(M, steps_mod, cfg, dropless=True,
                                                        **JAMBA_REDUCED_TRAIN)
    step = _read(counters)
    step_paths = {k: dict(fn.paths) for k, fn in counters.items() if hasattr(fn, "paths")}
    step_layouts = dict(counters["tile_matmul"].layouts)
    want, want_layouts = _step_want(cfg)
    assert step == want, (step, want)
    assert step_paths == {k: dict.fromkeys(v, 0) | {"ffma": step[k]}
                          for k, v in step_paths.items()}, step_paths
    assert step_layouts == want_layouts, step_layouts
    par.update(launches=step, tile_matmul_layouts=step_layouts)
    rm = out["remat_f32"] = remat_determinism(M, cfg, **JAMBA_REDUCED_TRAIN, counters=counters)
    print(f"remat reduced {JAMBA}, float32: {rm}")
    out["seconds"]["train_step"] = time.perf_counter() - t0
    print(f"parity f32 train step reduced {JAMBA}: {par}")
    torch.cuda.empty_cache()
    return out


def serve_jamba(serve, M, rehome, steps_mod, get_config, counters: dict) -> dict:
    """jamba_1_5_large_398b: full width at its ``SERVED_CUT`` through
    ``serve_moe`` (the hybrid cache of one attention layer's KV and three
    Mamba layers' states and conv tails; 16 experts top-2), then the reduced
    config on the card (``reduced_jamba``)."""
    out = serve_moe(serve, M, rehome, get_config, counters, JAMBA)
    out["reduced_on_card"] = reduced_jamba(serve, M, rehome, steps_mod, get_config, counters)
    return out


# The twin of examples/serve_batched.py on the card: its four reduced
# configs (float32) served as the example serves them.
EXAMPLES = ROOT / "examples"


def _predicted_paths(run) -> tuple:
    """``run()`` (a serve on the CPU) with ``tile_matmul``'s plain products
    counted by the path the card's wrapper would take for each: the shapes,
    layout and dtype of the call and the 16-byte alignment of its operands
    (the card's wrapper makes a non-contiguous operand contiguous, which
    aligns it), through ``kernel.choose_path``. Returns (``run()``'s
    result, launches by path)."""
    from repro_torch.kernels.tile_matmul import kernel as tmk
    from repro_torch.kernels.tile_matmul import ops

    paths = dict.fromkeys(tmk.PATH_CODES, 0)

    def counted(fn):
        def call(x, w, *args, trans_x=False, trans_w=False, **kw):
            m, k = x.shape[-2:][::-1] if trans_x else x.shape[-2:]
            n = w.shape[-2] if trans_w else w.shape[-1]
            aligned = all(not t.is_contiguous() or t.data_ptr() % 16 == 0 for t in (x, w))
            paths[tmk.choose_path(m, n, k, x.dtype, aligned, tmk.layout_of(trans_x, trans_w),
                                  x.dim() == 3)] += 1
            return fn(x, w, *args, trans_x=trans_x, trans_w=trans_w, **kw)
        return call

    saved = ops.product, ops._batched
    ops.product, ops._batched = counted(ops.product), counted(ops._batched)
    try:
        return run(), paths
    finally:
        ops.product, ops._batched = saved


def _top2_margins(cfg, logits: torch.Tensor) -> torch.Tensor:
    """The gap between the two largest logits of each pick: (B,), or (B, K)
    a codebook."""
    lg = (logits.reshape(len(logits), cfg.n_codebooks, cfg.vocab)
          if cfg.frontend == "codebooks" else logits[:, :cfg.vocab])
    top = lg.topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def _cpu_margins(M, rehome, cfg, params, tokens: np.ndarray, run: dict) -> torch.Tensor:
    """The CPU's top-2 margin at every pick of its greedy serve that picked
    ``tokens``, (B, gen) or (B, gen, K): the serve replayed from its seeded
    inputs (``serve``'s ``prompt_inputs`` and ``step_inputs``) with those
    tokens, each replayed pick checked against them."""
    from repro_torch.launch.serve import pick, prompt_inputs, step_inputs

    rng = np.random.default_rng(0)
    prompt = prompt_inputs(cfg, rng, run["batch"], run["prompt_len"], "cpu")
    small, logits = M.prefill(params, cfg, prompt)
    cache = rehome(M.init_cache(cfg, run["batch"], run["cache_len"], "cpu"), small)
    margins = []
    for s in range(run["gen"]):
        tok = torch.as_tensor(tokens[:, s])
        assert torch.equal(pick(cfg, logits, True, None), tok), (cfg.name, s)
        margins.append(_top2_margins(cfg, logits))
        if s + 1 < run["gen"]:
            logits, cache = M.decode_step(params, cfg, cache, step_inputs(cfg, tok, rng, "cpu")
                                          | {"cur_len": run["prompt_len"] + s})
    return torch.stack(margins, dim=1)


def _mixers(cfg) -> dict:
    """Layers of ``cfg`` by mixer ("attn", "mamba")."""
    layers = list(cfg.prefix) + list(cfg.period) * cfg.n_periods
    return {m: sum(l.mixer == m for l in layers) for m in ("attn", "mamba")}


def serve_batched(M, rehome, get_config, counters: dict) -> dict:
    """The twin of examples/serve_batched.py on the card
    (``examples/torch_serve_batched.py``'s ``run("cuda")``, every launch
    count set to 0 just before it and read just after): smollm_360m,
    mamba2_2_7b, deepseek_v2_lite_16b and musicgen_medium, reduced
    (float32), batch 4, 32-token prompts, 8 tokens. Launches by path held
    exactly: tile_matmul's as the same serves' products on the CPU predict
    them (``_predicted_paths``: ffma, skinny at the decode steps' 4 rows;
    a batched expert product ffma), one flash_attention a layer of the
    three attention configs in prefill (ffma; deepseek's at its reduced
    (24, 16)), one ssd_scan a mamba2 layer (ffma). Each config's tokens
    equal those of the same weights (the serve's seeded init on the card)
    served on the CPU, unless the CPU's top-2 margin at the first pick
    that differs is below ``NEAR_TIE``."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    import torch_serve_batched as twin

    from repro_torch.launch.serve import serve

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _zero(counters)
    res = twin.run("cuda")
    torch.cuda.synchronize()
    launches = _read(counters)
    by_path = {k: dict(fn.paths) for k, fn in counters.items() if hasattr(fn, "paths")}
    wall = time.perf_counter() - t0
    run = twin.serve_config()
    want_paths = dict.fromkeys(by_path["tile_matmul"], 0)
    mixers = {"attn": 0, "mamba": 0}
    out: dict = {"archs": list(twin.ARCHS), "settings": run, "wall_s": wall, "by_arch": {}}
    for arch in twin.ARCHS:
        cfg = get_config(arch, reduced=True)
        params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        cpu_params = _to(params, "cpu")
        del params
        ref, paths = _predicted_paths(lambda: serve(
            arch, device="cpu", params=cpu_params, log=lambda _: None, **run))
        want_paths = {p: want_paths[p] + paths[p] for p in want_paths}
        mixers = {m: mixers[m] + n for m, n in _mixers(cfg).items()}
        card, cpu = res[arch]["tokens"], ref["tokens"]
        assert card.shape == cpu.shape == (run["batch"], run["gen"]) + _books(cfg), \
            (arch, card.shape)
        margins = _cpu_margins(M, rehome, cfg, cpu_params, cpu, run).numpy()
        rec = _tokens_against_cpu(card, cpu, margins) | dict(
            prefill_s=res[arch]["t_prefill"], decode_s=res[arch]["t_decode"],
            predicted_paths=paths)
        out["by_arch"][arch] = rec
        print(f"serve_batched {arch}: tokens {card.shape} equal to the CPU's "
              f"{rec['tokens_equal']}, CPU's least top-2 margin {rec['min_top2_margin']:.3e}")
    assert set(p for p, n in want_paths.items() if n) <= {"ffma", "skinny"}, want_paths
    want = dict.fromkeys(counters, 0) | {"tile_matmul": sum(want_paths.values()),
                                         "flash_attention": mixers["attn"],
                                         "ssd_scan": mixers["mamba"]}
    assert launches == want, (launches, want)
    assert by_path["tile_matmul"] == want_paths, (by_path["tile_matmul"], want_paths)
    for k, n in (("flash_attention", mixers["attn"]), ("ssd_scan", mixers["mamba"])):
        assert by_path[k] == {"mma": 0, "ffma": n}, (k, by_path[k])
    out.update(launches=launches, launches_by_path=by_path)
    torch.cuda.empty_cache()
    return out


TRAIN_STEPS = 5


def _train_want(cfg, remat: str = "nothing") -> tuple[dict, dict, dict, int]:
    """The launches ``TRAIN_STEPS`` steps of ``cfg`` make under ``remat``:
    by kernel, by kernel and path (every bf16 product on wgmma, the float32
    router on ffma, every attention and scan and their backward on mma),
    tile_matmul's by layout, and its float32 z launches. Layer by layer
    (the ``prefix`` layers, then the periods): the 2-D products of the
    mixer (q, k, v, o; MLA's five: wq, w_dkv, w_uk and w_uv read as (R, H
    D) matrices, wo; Mamba-2's six) and of the FFN (a dense SwiGLU's gate, up, down; a dense GELU's up
    with bias and GELU and down with bias; a MoE layer's shared experts'
    three and its float32 router on ffma), and a MoE layer's three batched
    expert products (gate, up, down: one launch each over the experts).
    Each step: every product forward, again where remat "nothing"
    recomputes it ("dots" hands the recompute the forward's outputs, "none"
    keeps every activation), and its two gradient products (``x@w^T`` and
    ``x^T@w``, the batched ones in their batched layouts); one float32 z
    for each fused activation that has a gradient (SwiGLU's SiLU, GELU);
    every attention forward as often as a product and its backward once,
    every scan the same."""
    fwd = 2 if remat == "nothing" else 1
    layouts = dict.fromkeys(("x@w", "x@w^T", "x^T@w", "batched", "batched x@w^T",
                             "batched x^T@w"), 0)
    ffma = attn = scan = z = 0
    for lcfg in [*cfg.prefix, *cfg.period * cfg.n_periods]:
        prods = gates = experts = 0
        if lcfg.mixer == "attn":
            prods, attn = 5 if lcfg.attn.is_mla else 4, attn + 1
        else:
            prods, scan = 6, scan + 1
        if lcfg.ffn_kind == "dense":
            prods += 3 if lcfg.dense.kind == "swiglu" else 2
            gates += 1
        elif lcfg.ffn_kind == "moe":
            if lcfg.moe.n_shared:
                prods, gates = prods + 3, gates + 1
            prods, ffma, experts = prods + 1, ffma + fwd + 2, 3
        z += gates + (experts > 0)
        layouts["x@w"] += fwd * prods + gates
        layouts["x@w^T"] += prods
        layouts["x^T@w"] += prods
        if experts:
            layouts["batched"] += fwd * experts + 1
            layouts["batched x@w^T"] += experts
            layouts["batched x^T@w"] += experts
    layouts = {k: v * TRAIN_STEPS for k, v in layouts.items()}
    launches = {"tile_matmul": sum(layouts.values()),
                "flash_attention": fwd * attn * TRAIN_STEPS,
                "flash_attention_bwd": attn * TRAIN_STEPS, "ssd_scan": fwd * scan * TRAIN_STEPS,
                "ssd_scan_bwd": scan * TRAIN_STEPS}
    ffma *= TRAIN_STEPS
    by_path = {k: ({"wgmma": v - ffma, "mma": 0, "skinny": 0, "ffma": ffma}
                   if k == "tile_matmul" else {"mma": v, "ffma": 0})
               for k, v in launches.items()}
    return launches, by_path, layouts, z * TRAIN_STEPS


def _batch_at(cfg, batch: int, seq: int, step: int, device) -> dict:
    """The batch ``train`` reads at ``step`` for ``cfg`` (cyclic tokens;
    codebook tokens and labels (B, T, K), or seeded embeddings (B, T, d), as
    its frontend takes them), on ``device``."""
    from repro_torch.data.frontend import pipeline_for

    return {k: torch.as_tensor(v, device=device)
            for k, v in pipeline_for(cfg, batch, seq).batch_at(step).items()}


def _step_want(cfg, remat: str = "nothing") -> tuple[dict, dict]:
    """``_train_want`` for one step: launches by kernel and tile_matmul's
    by layout."""
    launches, _, layouts, _ = _train_want(cfg, remat)
    return ({k: v // TRAIN_STEPS for k, v in launches.items()},
            {k: v // TRAIN_STEPS for k, v in layouts.items()})


def train_path(train, M, cfg, counters: dict, batch: int = BATCH,
               seq: int = PROMPT) -> tuple[dict, dict]:
    """Train full-width ``cfg`` for ``TRAIN_STEPS`` steps of ``batch`` x
    ``seq`` cyclic tokens through ``train`` (seed 0, bf16, float32 AdamW
    moments, remat "nothing"), every launch count set to 0 just before and
    read just after. The weights are seeded as ``train`` seeds its own and
    passed in, so that it runs at ``cfg``'s depth (gemma3_12b is cut). A
    step's time is the host clock between two of its log lines (each step
    ends by reading its loss to the host); the median of steps 2-5 gives
    tokens/s. ``alloc_retries``: the times the caching allocator ran out of
    memory it could map, freed its cache and tried again."""
    stamps = []
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero(counters)
    t0 = time.perf_counter()
    # The weights are made in the call, so that ``train`` holds the only
    # reference and drops them after the first step (7.4 GB for gemma3).
    res = train(cfg.name, reduced=False, steps=TRAIN_STEPS, batch=batch, seq=seq,
                data_mode="cyclic", ckpt_every=0, resume=False, seed=0, device="cuda",
                ckpt_dir=str(ROOT / "build" / "chip_smoke_train"),
                params=M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"),
                log=lambda line: (stamps.append(time.perf_counter()), print(line)))
    launches = _read(counters)
    by_path = {k: dict(fn.paths) for k, fn in counters.items() if hasattr(fn, "paths")}
    layouts = dict(counters["tile_matmul"].layouts)
    outputs = dict(counters["tile_matmul"].outputs)
    peak = torch.cuda.max_memory_allocated()
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0) - retries
    losses = res["losses"]
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    steps_s = np.diff([t0] + stamps)
    median = float(np.median(steps_s[1:]))
    out = dict(arch=cfg.name, layers=cfg.n_layers, batch=batch, seq=seq, steps=TRAIN_STEPS,
               losses=losses, step_s=steps_s.tolist(), median_step_s=median,
               tokens_per_s=batch * seq / median, peak_mem_bytes=peak, alloc_retries=retries,
               launches=launches, launches_by_path=by_path, tile_matmul_layouts=layouts,
               tile_matmul_outputs=outputs, watchdog=res["watchdog"])
    print(f"train {cfg.name}: losses {losses}, median step {median:.4f} s "
          f"({out['tokens_per_s']:.0f} tokens/s), peak memory {peak / 2**30:.3f} GiB, "
          f"launches {launches}, by path {by_path}, tile_matmul layouts {layouts}")
    want, want_paths, want_layouts, want_z = _train_want(cfg)
    assert launches == want, (launches, want)
    assert layouts == want_layouts, (layouts, want_layouts)
    assert by_path == want_paths, (by_path, want_paths)
    # A bf16 model's only float32 outputs: the z of each fused activation.
    assert outputs["bfloat16->float32"] == want_z, (outputs, want_z)
    return out, res


def profile_train_step(steps_mod, cfg, res, counters: dict, batch: int = BATCH,
                       seq: int = PROMPT, names: tuple[str, ...] = ()) -> dict:
    """One more train step from ``train``'s final state under ``cfg``'s
    remat: host wall time without tracing (median of 3), the peak of
    allocated memory over those three, device kernel time from a
    torch.profiler trace of a fourth, their ratio as the busy share, the
    top kernels, the host's top operations by their own time (traced, so
    inflated), and the traced launches of each kernel whose name holds one
    of ``names``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim.optimizer import OptConfig

    opt = OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=TRAIN_STEPS, weight_decay=0.0)
    step = steps_mod.make_train_step(cfg, opt)
    batch = _batch_at(cfg, batch, seq, TRAIN_STEPS, "cuda")
    params, opt_state = res["params"], res["opt_state"]
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt_state, batch)
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    _zero(counters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(params, opt_state, batch)
        torch.cuda.synchronize()
    kern = _device_kernels(prof)
    wall_ms = sorted(walls)[1] * 1e3
    device_ms = sum(r[1] for r in kern)
    return dict(remat=cfg.remat, wall_ms=wall_ms, walls_ms=[w * 1e3 for w in walls],
                device_ms=device_ms, busy_share=device_ms / wall_ms, peak_mem_bytes=peak,
                launches=_read(counters),
                traced_launches={n: sum(c for k, _, c in kern if n in k) for n in names},
                top_kernels=[dict(name=k[:90], ms=t, calls=c) for k, t, c in kern[:12]],
                top_host=_host_ops(prof))


# glibc's mallopt parameters (malloc.h), and the thresholds the process
# keeps after a ``_host_memory_kept`` block: the largest that glibc's own
# adjustment reaches, which a program that sets one switches off.
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD, M_MMAP_MAX = -1, -3, -4
MMAP_THRESHOLD, TRIM_THRESHOLD = 32 << 20, 64 << 20


@contextlib.contextmanager
def _host_memory_kept():
    """Keeps the host memory that tensors free inside the block in this
    process, for the block's next tensors: glibc otherwise maps each one
    over 32 MiB afresh and unmaps it when it is freed, so that each of its
    pages is faulted in and zeroed again on first touch (about 4 GB/s on the
    card's host, most of the CPU's AdamW in a float32 step: 22 of the 35 s
    of internvl2's). After the block, tensors over ``MMAP_THRESHOLD`` are
    mapped again and the freed memory goes back to the system; the
    thresholds stay fixed for the rest of the run."""
    libc = ctypes.CDLL(None)
    libc.mallopt(M_MMAP_MAX, 0)
    libc.mallopt(M_TRIM_THRESHOLD, -1)
    try:
        yield
    finally:
        libc.mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD)
        libc.mallopt(M_TRIM_THRESHOLD, TRIM_THRESHOLD)
        libc.mallopt(M_MMAP_MAX, 65536)
        libc.malloc_trim(0)


def parity_train_f32(M, steps_mod, pcfg, batch: int = 2, seq: int = 128) -> dict:
    """One float32 train step of ``pcfg`` (a full-width config cut in
    depth), ``batch`` x ``seq`` tokens: the kernel path on the card against
    the plain path on the CPU, from the same seeded weights and batch. Loss
    and grad norm at 1e-3 (the logits' bar). The gradients, read back from
    the first moment (after one step from zero, m = 0.1 x the clipped
    gradient), within 1e-3 of each tensor's largest entry (the farthest
    tensor is named). The updated weights within half the learning
    rate: Adam's first step moves a weight by lr g / (|g| + 1e-8), which
    turns the two devices' float32 rounding of a gradient entry near 1e-8
    into a visible part of lr; the gradient check above is the close one."""
    with _host_memory_kept():
        return _compare_train_steps(_train_steps_f32(M, steps_mod, pcfg, batch, seq), pcfg,
                                    batch, seq)


def _train_steps_f32(M, steps_mod, pcfg, batch: int, seq: int, wrap=None) -> dict:
    """One float32 train step of ``pcfg`` on the card and on the CPU from
    the same seeded weights and batch: {device: (params, opt state,
    metrics)}, and ``cpu_s``, the CPU step's seconds on the host's clock.
    ``wrap(device, call)`` (optional) runs each step."""
    from repro_torch.optim.optimizer import OptConfig, init_opt_state

    wrap = wrap or (lambda _dev, call: call())
    pcfg = dataclasses.replace(pcfg, param_dtype="float32")
    opt = OptConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=TRAIN_STEPS, weight_decay=0.0)
    params = M.init_params(pcfg, torch.Generator(device="cuda").manual_seed(3), "cuda")
    tokens = _batch_at(pcfg, batch, seq, 0, "cpu")
    step = steps_mod.make_train_step(pcfg, opt)
    runs = {}

    def run(dev, p):
        runs[dev] = wrap(dev, lambda: step(p, init_opt_state(p, opt), {
            k: v.to(dev) for k, v in tokens.items()}))

    plain, card = _card_beside_host(run, params)
    t0 = time.perf_counter()
    run("cpu", plain)
    runs["cpu_s"] = time.perf_counter() - t0
    card()
    return runs


def _card_beside_host(fn, params):
    """Starts ``fn("cuda", params)`` on a thread of its own and, meanwhile,
    copies ``params`` to the CPU on a stream of its own (behind the work
    queued so far alone), so that the caller's CPU half runs beside the
    card's. Returns the CPU copy and a call that waits for the thread and
    raises what it raised."""
    failed = []

    def body():
        try:
            fn("cuda", params)
        except BaseException as e:  # noqa: BLE001 - handed to the waiting thread
            failed.append(e)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    thread = threading.Thread(target=body, daemon=True)
    thread.start()
    with torch.cuda.stream(side):
        plain = _to(params, "cpu")

    def wait():
        thread.join()
        if failed:
            raise failed[0]
    return plain, wait


def _compare_train_steps(runs: dict, pcfg, batch: int, seq: int) -> dict:
    """``_train_steps_f32``'s two steps held against each other as
    ``parity_train_f32`` says."""
    from repro_torch.checkpoint.checkpoint import _flatten
    from repro_torch.optim.optimizer import tree_leaves

    (pg, sg, mg), (pc, sc, mc) = runs["cuda"], runs["cpu"]
    lr = mc["lr"]
    assert abs(mg["loss"] - mc["loss"]) <= 1e-3, (mg, mc)
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-3 * max(1.0, mc["grad_norm"]), (mg, mc)
    # The differences are formed on the card, the CPU's tensors copied there:
    # a float32 difference, its absolute value and a maximum are exact on
    # either device, and the card forms them in a fraction of the CPU's time.
    got, want = _flatten(sg["m"]), _flatten(_to(sc["m"], "cuda"))
    grad_errs = {k: (got[k] - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
                 for k, b in want.items()}
    del want
    worst = max(grad_errs, key=grad_errs.get)
    param_err = max((a - b.to(a.device)).abs().max().item()
                    for a, b in zip(tree_leaves(pg), tree_leaves(pc)))
    out = dict(layers=pcfg.n_layers, batch=batch, seq=seq, loss_gpu=mg["loss"],
               loss_cpu=mc["loss"], grad_norm_gpu=mg["grad_norm"],
               grad_norm_cpu=mc["grad_norm"], lr=lr, max_grad_err_rel=grad_errs[worst],
               max_grad_err_at=worst, max_param_err=param_err,
               max_param_err_in_lr=param_err / lr, cpu_step_s=runs["cpu_s"])
    grad_err = grad_errs[worst]
    assert grad_err <= 1e-3, out
    assert param_err <= 0.5 * lr, out
    return out


# The dense-attention configs' training runs through ``train``: full width,
# batch x seq of twice the sliding window, so that the backward walks its
# band whole; gemma3_12b cut to two periods (12 layers, 10 local and 2
# global, 3.70 B parameters: 74 GB at the update's 20 bytes a parameter,
# where its 48 layers would take 235 GB). Then a float32 train step of each
# against the CPU's (periods kept, a mixed period cut to its first and last
# layers; tokens past the window). The two frontends the same way, 8 x 512:
# musicgen_medium at full depth ((B, T, 4) codebook tokens and labels
# through multi_head_xent; the GELU FFN's bias and GELU in tile_matmul's
# epilogue), with the remat check on 2 layers and one more profiled step
# under remat "dots"; internvl2_76b (seeded embeddings) cut to 2 layers.
# Each float32 step is sized so that its CPU half takes seconds: musicgen's
# 2 layers on 2 x 512 tokens, internvl2's 1 layer (and its 128256-wide
# head, 1.9 B parameters in all) on 1 x 128.
DENSE_TRAIN = {
    "h2o_danube_1_8b": dict(batch=2, seq=8192, n_periods=None, parity_periods=2,
                            parity=dict(batch=1, seq=4224)),
    "gemma3_12b": dict(batch=2, seq=2048, n_periods=2, parity_periods=1,
                       parity=dict(batch=1, seq=1152)),
    "musicgen_medium": dict(batch=BATCH, seq=PROMPT, n_periods=None, parity_periods=2,
                            parity=dict(batch=2, seq=512), remat_periods=2,
                            remat=dict(batch=2, seq=512), profile_dots=True),
    "internvl2_76b": dict(batch=BATCH, seq=PROMPT, n_periods=2, parity_periods=1,
                          parity=dict(batch=1, seq=128),
                          reduced_why="80 layers are 139 GB in bf16; at the update's 20 "
                                      "bytes a parameter 2 layers (2.762 B parameters, most "
                                      "of them the 128256 x 8192 head) take 55.2 GB and 3 "
                                      "would take 72.4 GB before the activations"),
}


def _print_train_profile(arch: str, prof: dict) -> None:
    print(f"profile {arch} train step, remat {prof['remat']}: wall {prof['wall_ms']:.3f} ms, "
          f"device kernels {prof['device_ms']:.3f} ms, busy share {prof['busy_share']:.3f}, "
          f"peak memory {prof['peak_mem_bytes'] / 2**30:.3f} GiB, launches "
          f"{prof['launches']}, top {prof['top_kernels'][:5]}")


def dense_train(train, M, steps_mod, get_config, arch: str, counters: dict) -> dict:
    """Train ``arch`` as ``DENSE_TRAIN`` sizes it through ``train_path``
    (launches asserted per kernel, path and layout: flash_attention_bwd on
    mma once a layer a step), profile one more step (and, where the spec
    asks, one under remat "dots": its launches ``_train_want``'s for
    "dots", its wall and peak memory beside "nothing"'s), then, where the
    spec asks, ``remat_determinism`` at full width, and hold a float32
    train step against the CPU's."""
    spec = DENSE_TRAIN[arch]
    full = get_config(arch)
    cfg = full if spec["n_periods"] is None else dataclasses.replace(
        full, n_periods=spec["n_periods"])
    out, res = train_path(train, M, cfg, counters, batch=spec["batch"], seq=spec["seq"])
    if cfg is not full:
        out["reduced"] = {"n_periods": f"{full.n_periods} -> {cfg.n_periods}",
                          "layers": f"{full.n_layers} -> {cfg.n_layers}"}
        if "reduced_why" in spec:
            out["reduced"]["why"] = spec["reduced_why"]
    out["params"] = M.param_count(cfg)
    prof = out["profile"] = profile_train_step(steps_mod, cfg, res, counters,
                                               spec["batch"], spec["seq"])
    _print_train_profile(arch, prof)
    assert prof["launches"] == _step_want(cfg)[0], prof["launches"]
    if spec.get("profile_dots"):
        dcfg = dataclasses.replace(cfg, remat="dots")
        dots = out["profile_dots"] = profile_train_step(steps_mod, dcfg, res, counters,
                                                        spec["batch"], spec["seq"])
        _print_train_profile(arch, dots)
        assert dots["launches"] == _step_want(dcfg, "dots")[0], dots["launches"]
    del res
    torch.cuda.empty_cache()
    if "remat" in spec:
        rcfg = _parity_config(full, spec["remat_periods"])
        rm = out["remat"] = remat_determinism(M, rcfg, **spec["remat"], counters=counters)
        print(f"remat {arch} full width, {rcfg.n_layers} layers, {rcfg.param_dtype}: {rm}")
    pcfg = _parity_config(full, spec["parity_periods"])
    par = out["parity_f32"] = parity_train_f32(M, steps_mod, pcfg, **spec["parity"])
    print(f"parity f32 train step {arch} full width, {pcfg.n_layers} layers: {par}")
    torch.cuda.empty_cache()
    return out


# qwen2_moe_a2_7b's training through ``train``: full width, cut to 4 of
# its 24 layers (2.905 B parameters, 58.1 GB at the update's 20 bytes a
# parameter; 5 layers would take 69.5 GB before the float32 logits of 8192
# tokens and their gradient, 9 GiB more), on 8 x 1024 tokens (four groups of
# 2048, capacity 43 a slot, 688 rows an expert: tokens drop). Then the
# remat check on 2 layers, 2 x 1024 (one group of 2048), bf16, and a
# float32 step of 2 layers on 2 x 512 (one group of 1024, capacity 22)
# against the CPU's, routing first.
QWEN2_TRAIN = dict(batch=BATCH, seq=1024, n_periods=4, parity_periods=2,
                   parity=dict(batch=2, seq=512), remat=dict(batch=2, seq=1024))
# deepseek_v2_lite_16b's the same way: full width, cut to 5 of its 27
# layers, the dense first layer and 4 MoE layers (2.840 B parameters, 56.8
# GB at the update's 20 bytes a parameter; 6 layers would take 68.5 GB
# before the activations), 8 x 1024 tokens (four groups of 2048, capacity
# 40 a slot, 960 rows an expert at top-6 of 64); the remat check and the
# float32 step on 2 layers, the dense one and one MoE layer (the step on 2
# x 512: one group of 1024, capacity 20 a slot, tokens drop).
DEEPSEEK_TRAIN = dict(batch=BATCH, seq=1024, n_periods=4, parity_periods=1,
                      parity=dict(batch=2, seq=512), remat=dict(batch=2, seq=1024))
MOE_TRAIN = {QWEN2: QWEN2_TRAIN, DEEPSEEK: DEEPSEEK_TRAIN}


REMATS = ("nothing", "none", "dots", "nothing")


def remat_determinism(M, cfg, batch: int, seq: int, counters: dict) -> dict:
    """Gradients of ``train_loss`` of ``cfg`` (in its own dtype) from
    seeded weights on one cyclic batch under each remat of ``REMATS``:
    "nothing" (each layer's forward recomputed in the backward, a MoE
    layer's routing included), "none" (every activation kept), "dots" (the
    recompute handed each kernel forward's output) and "nothing" again:
    every gradient the same bits in all four, and each run's launches by
    kernel and tile_matmul's by layout ``_step_want``'s for its remat (a
    forward launched once a step under "dots" and "none", twice under
    "nothing"); ``peak_above_weights_bytes``: each run's peak of allocated
    memory above what was allocated before it (its activations, kept
    outputs and gradients; the gradients of the runs before it are held).
    A MoE layer's buffers have one shape whatever the routing,
    so a recompute that routed a token otherwise would pass autograd's
    checks and give the gradient of another routing; and the backward adds
    nothing by index, so two passes agree."""
    from repro_torch.optim.optimizer import tree_leaves, tree_map

    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(4), "cuda")
    tokens = _batch_at(cfg, batch, seq, 1, "cuda")
    runs, launches, layouts, peaks = [], [], [], []
    for remat in REMATS:
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        _zero(counters)
        loss, _ = M.train_loss(leaves, dataclasses.replace(cfg, remat=remat), tokens)
        grads = torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated() - base)
        launches.append(_read(counters))
        layouts.append(dict(counters["tile_matmul"].layouts))
        runs.append((loss.item(), grads))
        del leaves, loss, grads
    (loss0, g0), *rest = runs
    out = dict(layers=cfg.n_layers, dtype=cfg.param_dtype, batch=batch, seq=seq,
               losses=[r[0] for r in runs], tensors=len(g0), remats=REMATS,
               launches=launches, tile_matmul_layouts=layouts, peak_above_weights_bytes=peaks,
               tensors_differing=[sum(not torch.equal(a, b) for a, b in zip(g0, g))
                                  for _, g in rest])
    assert all(r[0] == loss0 for r in rest) and out["tensors_differing"] == [0, 0, 0], out
    for remat, got, got_layouts in zip(REMATS, launches, layouts):
        assert (got, got_layouts) == _step_want(cfg, remat), (remat, got, got_layouts)
    del params, runs, g0, rest
    torch.cuda.empty_cache()
    return out


def parity_train_moe_f32(M, steps_mod, pcfg, batch: int, seq: int,
                         dropless: bool = False) -> dict:
    """``parity_train_f32`` of a MoE config, routing first: each layer's
    routing in the forward of the card's step and of the CPU's
    (``_routing_flips``: a differing top-k set is a fault unless the CPU's
    margin is under NEAR_TIE), then, where no near-tie flipped, loss,
    gradients and weights as ``parity_train_f32`` holds them. Some (token,
    slot) pairs must drop, or, where ``dropless`` (groups of at most 4E),
    none. The backward's recompute is not compared: on the card it runs on
    autograd's device thread, which the thread-local recording does not
    see."""
    from repro_torch.models.moe import recording_routes

    routes: dict = {"cuda": [], "cpu": []}

    def wrap(dev, call):
        with recording_routes() as seen:
            out = call()
        routes[dev] += seen[:_moe_layers(pcfg)]       # the forward's, layer by layer
        return out

    with _host_memory_kept():
        runs = _train_steps_f32(M, steps_mod, pcfg, batch, seq, wrap=wrap)
        moe = _moe_cfg(pcfg)
        out = _routing_flips(routes, moe.top_k)
        out["dropped"] = _dropped_pairs(routes["cpu"], moe, batch * seq)
        assert (sum(out["dropped"]) == 0) if dropless else (sum(out["dropped"]) > 0), out
        if out["near_tie_flips"] == 0:
            out |= _compare_train_steps(runs, pcfg, batch, seq)
        del runs
    torch.cuda.empty_cache()
    return out


def _attn_dims(cfg):
    """The attention's head dim (a key of ``FLASH_BWD_KERNELS``): one int,
    or MLA's (q/k, v) pair."""
    a = cfg.period[0].attn
    return (a.qk_nope_dim + a.qk_rope_dim, a.v_head_dim) if a.is_mla else a.head_dim


def train_moe(train, M, steps_mod, get_config, counters: dict, arch: str) -> dict:
    """Train an MoE config (qwen2_moe_a2_7b, deepseek_v2_lite_16b) as
    ``MOE_TRAIN`` sizes it through ``train_path`` (launches asserted per
    kernel, path and layout: each expert product's dx and dw one batched
    launch in ``x@w^T`` and ``x^T@w``, the router on ffma, MLA's five 2-D
    products and the dense first layer's three, flash_attention_bwd once a
    layer a step), profile one more step (its attention backward traced on
    the wgmma kernels of its head dims: D 128, or (192, 128)), then
    ``remat_determinism`` and the float32 step against the CPU's
    (``parity_train_moe_f32``)."""
    spec, full = MOE_TRAIN[arch], get_config(arch)
    cfg = dataclasses.replace(full, n_periods=spec["n_periods"])
    out, res = train_path(train, M, cfg, counters, batch=spec["batch"], seq=spec["seq"])
    out["reduced"] = {"n_periods": f"{full.n_periods} -> {cfg.n_periods}",
                      "layers": f"{full.n_layers} -> {cfg.n_layers}"}
    out["params"] = M.param_count(cfg)
    names = FLASH_BWD_KERNELS[_attn_dims(cfg)]
    prof = out["profile"] = profile_train_step(steps_mod, cfg, res, counters, spec["batch"],
                                               spec["seq"], names=names)
    _print_train_profile(cfg.name, prof)
    print(f"traced {prof['traced_launches']}")
    assert prof["launches"] == _step_want(cfg)[0], prof["launches"]
    # a trace can lose a launch (``_traced_ms``): one a kernel at most
    assert all(cfg.n_layers - 1 <= c <= cfg.n_layers
               for c in prof["traced_launches"].values()), prof["traced_launches"]
    del res
    torch.cuda.empty_cache()
    rcfg = dataclasses.replace(full, n_periods=spec["parity_periods"])
    rm = out["remat"] = remat_determinism(M, rcfg, **spec["remat"], counters=counters)
    print(f"remat {cfg.name} full width, {rcfg.n_layers} layers, bf16: {rm}")
    par = out["parity_f32"] = parity_train_moe_f32(M, steps_mod, rcfg, **spec["parity"])
    print(f"parity f32 train step {cfg.name} full width, {rcfg.n_layers} layers: {par}")
    torch.cuda.empty_cache()
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
    just after; also each step's host seconds (``step_seconds``), the
    seconds of the pouch rounds that ended at their deadline with a task
    unfinished, each round's seconds over the deadline it ran under (a
    round re-issues its unfinished tasks at 1), and the garbage collector's
    passes during the run: for each generation their count and seconds,
    and when each full pass began (seconds after the start) and its length,
    beside the objects it tracked before the run."""
    from repro_torch.core.space import ANY
    from repro_torch.ts_exec.step_runner import step_seconds

    passes: list = []

    def on_gc(phase, info):
        passes.append((phase, info["generation"], time.time()))

    torch.cuda.synchronize()
    tracked = len(gc.get_objects())
    _zero(counters)
    gc.callbacks.append(on_gc)
    t0 = time.time()
    try:
        res = runner.run()
    finally:
        gc.callbacks.remove(on_gc)
    launches = _read(counters)
    gcs = {"tracked": tracked, "count": [0, 0, 0], "s": [0.0, 0.0, 0.0], "full": []}
    for (ph, gen, t), (_, _, t_end) in zip(passes[::2], passes[1::2]):
        assert ph == "start", passes
        gcs["count"][gen] += 1
        gcs["s"][gen] += t_end - t
        if gen == 2:
            gcs["full"].append((t - t0, t_end - t))
    by_path = {k: dict(fn.paths) for k, fn in counters.items() if hasattr(fn, "paths")}
    steps_s = step_seconds(runner, t0)
    rounds = [runner.ts.try_read(k)[1]
              for k in sorted(runner.ts.keys(("thist", ANY, ANY)), key=lambda k: k[2])]
    waited = sum(r["elapsed"] for r in rounds if r["done_frac"] < 1.0)
    deadlines = [runner.tcfg.timeout] + [r["timeout"] for r in rounds[:-1]]
    over = [r["elapsed"] / d for r, d in zip(rounds, deadlines)]
    return res, launches, by_path, steps_s, waited, over, gcs


def acan_path(step_runner, M, cfg, counters: dict) -> dict:
    """Train full-width, full-depth ``cfg`` (bf16) through the ACAN runner
    twice from the same seeded weights: without crashes, then with a
    handler crash probability of 0.25. Both commit every version once, give
    the same losses and final weights bit for bit, break no tuple-space
    protocol rule and leak nothing; the crash-free run re-issues nothing
    (the collector frozen over the objects earlier phases left, as in
    ``acan_deepseek``). Each kernel's launches are a whole multiple (the same for all three) of
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
    want = _step_want(cfg)[0]
    assert per_grad == want, (per_grad, want)
    torch.cuda.reset_peak_memory_stats()
    # As in acan_deepseek: a full collection over the objects the earlier
    # phases left (0.59 s over 474,891 of them in one run of the parent
    # tree) can pass a crash-free round's deadline and re-issue its tasks.
    gc.collect()
    gc.freeze()
    try:
        res, launches, by_path, steps_s, waited_clean, over, gcs = _acan_run(clean, counters)
        peak = torch.cuda.max_memory_allocated()
        crashed = _acan_runner(step_runner, cfg, params, handler_crash_prob=0.25)
        res_c, launches_c, by_path_c, steps_c, waited, _, _ = _acan_run(crashed, counters)
    finally:
        gc.unfreeze()
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
               round_over_deadline=over, gc=gcs,
               peak_mem_bytes=peak, launches_per_grad=per_grad, launches=launches,
               launches_by_path=by_path, launches_crash=launches_c,
               launches_by_path_crash=by_path_c)
    print(f"acan {cfg.name}: losses {res.losses}, crash run losses {res_c.losses}; "
          f"crash-free run {res.crashes} crashes, {res.reissues} re-issues; crash run "
          f"{res_c.crashes} crashes, {res_c.reissues} re-issues, {waited:.3f} s of "
          f"rounds ended at their deadline; crash-free rounds over their deadline "
          f"{max(over):.3f} at most ({over}), garbage collector {gcs}; "
          f"median step (2-{steps}) {median:.4f} s "
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


# The twin of examples/acan_jax_train.py on the card: the reference
# example's run (reduced deepseek_v2_lite_16b, float32; 4 handlers, 4 x 2 x
# 32 tokens a step, 8 steps, lr 0.05, a task's crash probability 0.25,
# seed 0) with a first deadline of 2 s where the example waits 30: each
# crashed task waits out its round's deadline, which falls toward 1.3
# times a crash-free round's time as the run goes on.
ACAN_DEEPSEEK_TIMEOUT = 2.0


def acan_deepseek(step_runner, get_config, counters: dict) -> dict:
    """``examples/torch_acan_jax_train.py``'s run through the ACAN runner on
    the card under ``checked+local``, twice from the same seeded weights:
    without crashes (no crash, no re-issue) and with the example's (at
    least one crash or re-issue). Both commit every version once, break no
    protocol rule and leak nothing, and give the same losses, which fall,
    and the same final weights bit for bit. Every launch takes the float32
    paths: tile_matmul ffma or skinny, the attention at q/k head dim 24 and
    v head dim 16 and its backward on ffma."""
    from repro_torch.optim.optimizer import tree_leaves

    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    import torch_acan_jax_train as twin

    cfg = get_config(DEEPSEEK, reduced=True)
    runs = {}
    for crash in (0.0, twin.train_config().handler_crash_prob):
        tcfg = twin.train_config("checked+local", timeout=ACAN_DEEPSEEK_TIMEOUT,
                                 handler_crash_prob=crash)
        runner = step_runner.ACANStepRunner(cfg, tcfg)
        runner.warm_up()
        torch.cuda.synchronize()
        # A round takes a few tenths of a second, its deadline about 1.3
        # times that: a full collection over the objects the earlier phases
        # left (0.2-0.5 s in acan_path's record) would pass it, and the
        # crash-free run would re-issue. The runs' own objects are
        # collected as usual (``gc`` in the record).
        gc.collect()
        gc.freeze()
        try:
            res, launches, by_path, steps_s, waited, over, gcs = _acan_run(runner, counters)
        finally:
            gc.unfreeze()
        final = tree_leaves(runner.ts.try_read(("params", tcfg.steps))[1])
        runs[crash] = (tcfg, res, launches, by_path, steps_s, waited, over, final, gcs)
    (tcfg, res, launches, by_path, steps_s, _, over, final, gcs), \
        (_, res_c, launches_c, by_path_c, steps_c, waited, _, final_c, gcs_c) = runs.values()
    out = dict(arch=f"{cfg.name} (reduced)", run={k: v for k, v in dataclasses.asdict(tcfg).items()
                                               if k != "handler_crash_prob"},
               crash_prob=list(runs)[1],
               losses=res.losses, losses_crash=res_c.losses, reissues=res.reissues,
               crashes=res.crashes, reissues_crash=res_c.reissues, crashes_crash=res_c.crashes,
               param_versions=[res.param_versions, res_c.param_versions],
               ts_violations=[res.ts_violations, res_c.ts_violations],
               ts_leaks=[res.ts_leaks, res_c.ts_leaks], step_s=steps_s,
               median_step_s=float(np.median(steps_s[1:])), step_s_crash=steps_c,
               wall_s=sum(steps_s), wall_s_crash=sum(steps_c), timeout_wait_s=waited,
               round_over_deadline=over, launches=launches, launches_by_path=by_path,
               launches_crash=launches_c, launches_by_path_crash=by_path_c, gc=[gcs, gcs_c])
    print(f"acan {out['arch']}: losses {res.losses}, crash run losses {res_c.losses}; "
          f"crash-free run {res.crashes} crashes, {res.reissues} re-issues; crash run "
          f"{res_c.crashes} crashes, {res_c.reissues} re-issues; walls {out['wall_s']:.2f} s "
          f"and {out['wall_s_crash']:.2f} s; crash-free rounds over their deadline "
          f"{max(over):.3f} at most; launches {launches}, by path {by_path}")
    for r in (res, res_c):
        assert r.param_versions == tcfg.steps, out
        assert r.ts_violations == 0 and r.ts_leaks == {}, out
        assert len(r.losses) == tcfg.steps and all(np.isfinite(r.losses)), out
    assert res.reissues == 0 and res.crashes == 0, out
    assert res_c.crashes + res_c.reissues >= 1, out
    assert res_c.losses == res.losses and res.losses[-1] < res.losses[0], out
    assert all(torch.equal(a, b) for a, b in zip(final, final_c)), "crash run's weights differ"
    for run, paths in ((launches, by_path), (launches_c, by_path_c)):
        assert run["tile_matmul"] > 0 and run["flash_attention"] > 0, run
        assert run["flash_attention_bwd"] > 0 and run["ssd_scan"] == run["ssd_scan_bwd"] == 0, run
        assert paths["tile_matmul"]["wgmma"] == paths["tile_matmul"]["mma"] == 0, paths
        assert paths["tile_matmul"]["ffma"] > 0, paths
        for k in ("flash_attention", "flash_attention_bwd"):
            assert paths[k] == {"mma": 0, "ffma": run[k]}, paths
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


# ------------------------------------------------------------ process fleet
FLEET_RUN = dict(epochs=2, n_samples=8)


def _round_s(cloud) -> float:
    """Seconds a round in steady state: the ledger's span from the first
    loss record to the last over the rounds between them, so a process
    fleet's worker boot, before the first round, is left out."""
    t = sorted(e.wallclock for e in cloud.ts.ledger.entries
               if e.op == "put" and e.key[0] == "losshist")
    return (t[-1] - t[0]) / (len(t) - 1)


def _waiting_takes() -> int:
    return sum(t.name == "ts-wait-take_batch" for t in threading.enumerate())


def _worker_boot_s(workers) -> float:
    """One worker's boot on the card: from its spawn to its first
    ``take_batch`` at a tuple-space server in this process, which parks
    each blocking op on a thread named for it. Covers the interpreter,
    ``import torch``, the CUDA context and the tile_matmul library's
    load."""
    from repro_torch.core.space import TSServer

    deadline = time.perf_counter() + 10.0
    while _waiting_takes() and time.perf_counter() < deadline:
        time.sleep(0.01)        # an earlier server's waiters unpark in 0.5 s
    assert not _waiting_takes(), "a take_batch waiter of an earlier run is still parked"
    srv = TSServer("sharded", device="cuda").start()
    t0 = time.perf_counter()
    hp = workers.spawn_worker(srv.addr, "boot", device="cuda")
    try:
        while not _waiting_takes():
            assert hp.is_alive(), "the worker exited before its first take_batch"
            assert time.perf_counter() - t0 < 120, "the worker did not boot in 120 s"
            time.sleep(0.002)
        return time.perf_counter() - t0
    finally:
        hp.terminate()
        hp.join(10.0)
        hp.kill_hard()
        hp.join()
        srv.close()


def _worker_launches(counts: dict, counters: dict) -> tuple[dict, dict]:
    """A fleet's worker counts (``CloudResult.worker_launches``) as
    (launches, by path)."""
    return ({k: counts.get(k, {}).get("launches", 0) for k in counters},
            {k: dict(counts.get(k, {}).get("paths", dict.fromkeys(fn.paths, 0)))
             for k, fn in counters.items()})


def process_fleet(counters: dict) -> dict:
    """The paper's exp 1 at its width (N = 256, task cap 256, pouch 100,
    4 handlers; 8 samples x 2 epochs) on a ``checked+sharded:4`` space,
    on the thread fleet and on the process fleet (4 worker processes on
    the card, over the cloud's embedded tuple-space server): the same
    losses and final weights bit for bit, no violation, leak or broken
    ledger. The workers' own tile_matmul launches, by path, come from the
    counts they write as they run and when they stop
    (``CloudResult.worker_launches``; a SIGKILLed worker's last quarter
    second of launches is lost with it);
    the cloud process launches nothing. A worker's boot on the card is measured first; then the same
    run with every worker SIGKILLed at an interval of 3 boots (emulated
    compute stretches it to 1.4 intervals, so a firing lands in it: sleep,
    not math) must revive and keep the bits. Last, a float32 and a bf16 CUDA tensor
    round-trip through a ``remote+checked+sharded:4`` space (a private
    server on the CPU) and come back on the card with equal bits."""
    from repro_torch.configs import paper_mlp
    from repro_torch.core import ACANCloud, FaultPlan, workers
    from repro_torch.core.program import GLOBAL_OPS
    from repro_torch.core.space import TupleSpace, make_backend
    from repro_torch.programs import mlp

    base = paper_mlp.feasibility_config(device="cuda", **FLEET_RUN)
    base.ts_backend = "checked+sharded:4"
    base.wall_limit = 120.0
    rounds = base.epochs * base.n_samples
    boot_s = _worker_boot_s(workers)
    interval = 3 * boot_s
    units = sum(GLOBAL_OPS.cost(p) for tasks in mlp.prototype_tasks(base.layers, 0, 0).values()
                for t in tasks for p in GLOBAL_OPS.partition(t, base.task_cap))
    out: dict = dict(boot_s=boot_s, kill_interval_s=interval, units_a_round=units)
    weights = {}
    for name in ("thread", "process", "process_sigkill"):
        kw = {}
        if name != "thread":
            kw = dict(fleet="process")
        if name == "process_sigkill":
            # Emulated compute (sleep) that stretches the fault-free
            # process run to 1.4 intervals, so the first firing lands in it.
            extra = max(1.4 * interval - out["process"]["wall_s"], 0.0)
            kw |= dict(time_scale=base.time_scale + extra * base.n_handlers / (units * rounds),
                       fault_plan=FaultPlan(interval=interval, p_handler_crash=1.0, seed=1))
            out["kill_time_scale"] = kw["time_scale"]
        cloud = ACANCloud(dataclasses.replace(base, **kw))
        res, wall, launches, by_path = _cloud_run(cloud, counters)
        rec = out[name] = _mlp_summary(res, wall, launches, by_path, base.epochs)
        rec["round_s"] = _round_s(cloud)
        weights[name] = _final_weights(cloud)
        assert rec["rounds"] == rounds, rec
        assert rec["ledger_ok"] and rec["ts_violations"] == 0 and rec["ts_leaks"] == {}, rec
        assert all(w.is_cuda and w.dtype == torch.float32 for w in weights[name]), name
        if name != "thread":
            assert all(n == 0 for n in launches.values()), ("the cloud process launched", launches)
            rec["cloud_launches"] = launches
            rec["worker_counts"] = res.worker_launches
            rec["launches"], rec["launches_by_path"] = _worker_launches(rec["worker_counts"],
                                                                        counters)
        tm = rec["launches_by_path"]["tile_matmul"]
        assert all(rec["launches"][k] == 0 for k in counters if k != "tile_matmul"), rec
        assert tm["skinny"] > 0 and tm["ffma"] > 0 and tm["wgmma"] == tm["mma"] == 0, (name, tm)
        assert rec["launches"]["tile_matmul"] == sum(tm.values()), rec
    t, p, k = out["thread"], out["process"], out["process_sigkill"]
    assert p["losses"] == t["losses"], "the process fleet's losses differ from the thread fleet's"
    assert all(torch.equal(a, b) for a, b in zip(weights["process"], weights["thread"]))
    assert k["handler_revivals"] >= 1, k
    assert k["losses"] == t["losses"], "the SIGKILL run's losses differ"
    assert all(torch.equal(a, b) for a, b in zip(weights["process_sigkill"], weights["thread"]))

    ts = TupleSpace(backend=make_backend("remote+checked+sharded:4", device="cuda"))
    try:
        sent = {("w", 0): _randn((256, 256), torch.float32, 40),
                ("w", 1): _randn((16, 960), torch.bfloat16, 41)}
        t0 = time.perf_counter()
        for key, v in sent.items():
            ts.put(key, v)
        back = {key: ts.read(key)[1] for key in sent}
        rt_s = time.perf_counter() - t0
    finally:
        ts.backend.close()
    out["remote_round_trip"] = dict(
        s=rt_s, exact={str(key[1]): bool(b.is_cuda and b.dtype == sent[key].dtype
                                         and torch.equal(b, sent[key]))
                       for key, b in back.items()})
    assert all(out["remote_round_trip"]["exact"].values()), out["remote_round_trip"]
    out["launches"] = {c: sum(out[r]["launches"][c] for r in ("thread", "process",
                                                              "process_sigkill"))
                       for c in counters}
    out["launches_by_path"] = {c: {q: sum(out[r]["launches_by_path"][c][q]
                                          for r in ("thread", "process", "process_sigkill"))
                                   for q in counters[c].paths} for c in counters}
    return out


# ------------------------------------------------------------------ the MoE
# examples/acan_moe_routing.py's program and cloud: T 128, minibatch 32,
# d_in 16, d_hidden 16, d_out 8, 4 experts, top-2, 16 steps, 4 handlers,
# task cap 256, pouch 64, time_scale 1e-6.
MOE = dict(steps=16, seed=0)
MOE_CLOUD = dict(n_handlers=4, task_cap=256.0, pouch_size=64, time_scale=1e-6,
                 initial_timeout=0.1, wall_limit=60.0, max_inflight_stages=8,
                 ts_backend="checked+local")
# The example's crash plan (every 0.15 s, p = 1.0), run under five seeds;
# each run revives the Manager 3-5 times (probe_moe_recovery.py).
MOE_CRASHES = dict(interval=0.15, speed_levels=(1.0, 5.0, 10.0), p_speed_change=1.0,
                   p_handler_crash=1.0, p_manager_crash=1.0)
MOE_CRASH_SEEDS = (1, 2, 3, 4, 5)
MOE_MIN_MANAGER_REVIVALS = 10
MOE_TOL = 2e-4


def _moe_groups(prog, ts, cap: float) -> dict:
    """Round 0's task groups of each MoE op, as a handler batch holds
    them: the route tasks, and each expert's forward and gradient tasks
    partitioned at the task cap."""
    from repro_torch.core.program import GLOBAL_OPS

    def parts(stage):
        return [p for t in prog.stage_tasks(ts, 0, stage) for p in GLOBAL_OPS.partition(t, cap)]
    return {"moe_route": [parts("route")],
            "moe_fwd": [g for e in range(prog.E) if (g := parts(f"expert_{e}"))],
            "moe_grad": [g for e in range(prog.E) if (g := parts(f"grad_{e}"))]}


def check_moe_ops(tm_kernel, tile_matmul_ref) -> dict:
    """The MoE's three op bodies on the card against the plain bodies on
    the CPU, on the same round-0 tuples (float32, 2e-4; the routed expert
    ids exactly): the CPU runs round 0 up to its gradient stage and the
    card gets a copy of every tuple. Every task run alone gives the bits
    it gave inside its handler batch. Then one expert forward task's two
    products timed beside torch.matmul."""
    from repro_torch.core.executor import ExecContext, TaskExecutor
    from repro_torch.core.program import GLOBAL_OPS
    from repro_torch.core.space import TupleSpace
    from repro_torch.kernels.tile_matmul.ops import product
    from repro_torch.programs.moe import MoERoutingProgram

    cap = MOE_CLOUD["task_cap"]
    prog = MoERoutingProgram(**MOE, device="cpu")
    cpu = TupleSpace()
    prog.setup(cpu)
    run = TaskExecutor(cpu).execute_batch
    run(prog.stage_tasks(cpu, 0, "route"))
    prog._combine_route(cpu, 0)
    for g in _moe_groups(prog, cpu, cap)["moe_fwd"]:
        run(g)
    prog._combine_expert(cpu, 0, 0)
    card = TupleSpace()
    for key, v in cpu.snapshot().items():
        card.put(key, _to(v, "cuda"))
    ctx = {"cuda": ExecContext(card), "cpu": ExecContext(cpu)}
    fn = tm_kernel.tile_matmul
    paths, layouts = dict(fn.paths), dict(fn.layouts)
    err, rows = {}, {}
    for op, groups in _moe_groups(prog, cpu, cap).items():
        body = GLOBAL_OPS.resolve(op).batch_fn
        e = 0.0
        rows[op] = [t.n for g in groups for t in g]
        for group in groups:
            got, want = dict(body(ctx["cuda"], group)), dict(body(ctx["cpu"], group))
            assert got.keys() == want.keys()
            for key, v in got.items():
                pairs = v.items() if isinstance(v, dict) else [("", v)]
                for field, x in pairs:
                    w = want[key][field] if field else want[key]
                    assert x.is_cuda and x.dtype == w.dtype, (key, field)
                    if x.dtype == torch.int64:
                        assert torch.equal(x.cpu(), w), ("routed experts differ", key)
                    else:
                        e = max(e, (x.cpu() - w).abs().max().item())
            for t in group:
                for key, v in body(ctx["cuda"], [t]):
                    same = (all(torch.equal(x, got[key][f]) for f, x in v.items())
                            if isinstance(v, dict) else torch.equal(v, got[key]))
                    assert same, ("alone != in its batch", key)
        err[op] = e
    launched = {q: fn.paths[q] - paths[q] for q in fn.paths}
    by_layout = {q: fn.layouts[q] - layouts[q] for q in fn.layouts}
    assert max(err.values()) <= MOE_TOL, err
    assert launched["ffma"] > 0 and launched["skinny"] > 0, launched
    assert launched["wgmma"] == launched["mma"] == 0, launched
    assert all(v > 0 for q, v in by_layout.items() if not q.startswith("batched")), by_layout
    assert all(v == 0 for q, v in by_layout.items() if q.startswith("batched")), by_layout

    # One expert forward task: relu(x @ W1^T) then h @ W2^T, n routed rows.
    n = max(rows["moe_fwd"])
    x = _randn((n, prog.d_in), torch.float32, 50)
    w1 = _randn((prog.d_h, prog.d_in), torch.float32, 51, prog.d_in ** -0.5)
    w2 = _randn((prog.d_out, prog.d_h), torch.float32, 52, prog.d_h ** -0.5)
    kern = lambda: product(product(x, w1, activation="relu", trans_w=True),  # noqa: E731
                           w2, trans_w=True)
    plain = lambda: tile_matmul_ref(tile_matmul_ref(x, w1, activation="relu",  # noqa: E731
                                                    trans_w=True), w2, trans_w=True)
    lib = lambda: torch.matmul(torch.relu(torch.matmul(x, w1.T)), w2.T)  # noqa: E731
    flops = 2 * n * prog.d_in * prog.d_h + 2 * n * prog.d_h * prog.d_out
    nbytes = 4 * (n * prog.d_in + prog.d_h * prog.d_in + 2 * n * prog.d_h
                  + prog.d_out * prog.d_h + n * prog.d_out)
    bound_ms, bound_by = _bound(flops, nbytes, torch.float32)
    times = dict(shape=dict(n=n, d_in=prog.d_in, d_h=prog.d_h, d_out=prog.d_out),
                 paths=[tm_kernel.choose_path(n, prog.d_h, prog.d_in, torch.float32, True,
                                              "x@w^T"),
                        tm_kernel.choose_path(n, prog.d_out, prog.d_h, torch.float32, True,
                                              "x@w^T")],
                 ms=_time_ms(kern, iters=200), device_ms=_graph_ms(kern, iters=200),
                 plain_ms=_time_ms(plain, iters=200),
                 library_ms=_time_ms(lib, iters=200), library_device_ms=_graph_ms(lib, iters=200),
                 flops=flops, bytes=nbytes, bound_ms=bound_ms, bound_by=bound_by,
                 max_abs_err=(kern() - lib()).abs().max().item())
    return dict(max_abs_err=err, task_rows=rows, launches_by_path=launched,
                launches_by_layout=by_layout, times=times)


def moe_path(counters: dict) -> dict:
    """The MoE routing program at ``examples/acan_moe_routing.py``'s size
    on the thread fleet on the card (``checked+local``, frontier 8):
    fault-free, then under the example's Manager and Handler crashes
    (p = 1.0 every 0.15 s, speeds re-drawn) with five seeds, each run's
    losses and expert weights the fault-free run's bit for bit, at least
    ten Manager revivals in all; the loss falls.
    Every product is a tile_matmul launch (ffma, and skinny for dy @ W2)
    and nothing else runs: each gradient task makes one plain product and
    two transposed-x ones. The float32 run on the card is held against
    the same run on the CPU over its 16 steps (1e-5 relative)."""
    from repro_torch.core import ACANCloud, CloudConfig, FaultPlan, MoERoutingProgram

    out, weights = {}, {}
    crash_runs = [f"crashes_seed{seed}" for seed in MOE_CRASH_SEEDS]
    plans = {f"crashes_seed{seed}": FaultPlan(**MOE_CRASHES, seed=seed)
             for seed in MOE_CRASH_SEEDS}
    for name, dev in (("fault_free", "cuda"), *((r, "cuda") for r in crash_runs), ("cpu", "cpu")):
        plan = plans.get(name, FaultPlan(interval=1e9))
        prog = MoERoutingProgram(**MOE, device=dev)
        cloud = ACANCloud(CloudConfig(**MOE_CLOUD, fault_plan=plan, device=dev), program=prog)
        res, wall, launches, by_path = _cloud_run(cloud, counters)
        losses = [loss for _, loss in res.loss_history]
        out[name] = dict(rounds=len(losses), losses=losses, wall_s=wall,
                         step_s=_round_s(cloud), manager_revivals=res.manager_revivals,
                         handler_revivals=res.handler_revivals, speed_changes=res.speed_changes,
                         ledger_ok=res.ledger_ok, ts_violations=res.ts_violations,
                         ts_violation_samples=res.ts_violation_samples[:5],
                         ts_leaks=res.ts_leaks, launches=launches, launches_by_path=by_path,
                         launches_by_layout=dict(counters["tile_matmul"].layouts))
        weights[name] = [cloud.ts.try_read((w, e))[1]
                         for e in range(prog.E) for w in ("we1", "we2")]
        rec = out[name]
        assert rec["rounds"] == MOE["steps"], rec
        assert rec["ledger_ok"] and rec["ts_violations"] == 0 and rec["ts_leaks"] == {}, rec
        if dev == "cuda":
            assert all(w.is_cuda and w.dtype == torch.float32 for w in weights[name]), name
            assert launches["tile_matmul"] > 0 and all(
                launches[k] == 0 for k in launches if k != "tile_matmul"), launches
            tm, lay = by_path["tile_matmul"], rec["launches_by_layout"]
            assert tm["ffma"] > 0 and tm["skinny"] > 0 and tm["wgmma"] == tm["mma"] == 0, tm
            assert all(v > 0 for q, v in lay.items() if not q.startswith("batched")), lay
            assert all(v == 0 for q, v in lay.items() if q.startswith("batched")), lay
        else:
            assert all(n == 0 for n in launches.values()), launches
    clean, cpu = out["fault_free"], out["cpu"]
    lay, tm = clean["launches_by_layout"], clean["launches_by_path"]["tile_matmul"]
    assert lay["x^T@w"] == 2 * lay["x@w"] == 2 * tm["skinny"], (lay, tm)
    assert tm["ffma"] == lay["x@w^T"] + lay["x^T@w"], (lay, tm)
    for name in crash_runs:
        crashed = out[name]
        assert crashed["manager_revivals"] >= 1 and crashed["handler_revivals"] >= 1, crashed
        assert crashed["losses"] == clean["losses"], f"{name}: the losses differ"
        assert all(torch.equal(a, b) for a, b in zip(weights[name], weights["fault_free"])), name
    out["crash_manager_revivals"] = sum(out[r]["manager_revivals"] for r in crash_runs)
    out["crash_handler_revivals"] = sum(out[r]["handler_revivals"] for r in crash_runs)
    assert out["crash_manager_revivals"] >= MOE_MIN_MANAGER_REVIVALS, out["crash_manager_revivals"]
    n = len(clean["losses"]) // 4
    assert np.mean(clean["losses"][-n:]) < np.mean(clean["losses"][:n]), clean["losses"]
    out["max_loss_rel_err_cpu"] = max(abs(a - b) / abs(b)
                                      for a, b in zip(clean["losses"], cpu["losses"]))
    out["max_weight_err_rel_cpu"] = max((a.cpu() - b).abs().max().item() / b.abs().max().item()
                                        for a, b in zip(weights["fault_free"], weights["cpu"]))
    assert out["max_loss_rel_err_cpu"] <= 1e-5 and out["max_weight_err_rel_cpu"] <= 1e-5, out
    card_runs = ["fault_free", *crash_runs]
    out["launches"] = {k: sum(out[r]["launches"][k] for r in card_runs) for k in counters}
    out["launches_by_path"] = {k: {q: sum(out[r]["launches_by_path"][k][q] for r in card_runs)
                                   for q in counters[k].paths} for k in counters}
    out["launches_by_layout"] = {q: sum(out[r]["launches_by_layout"][q] for r in card_runs)
                                 for q in clean["launches_by_layout"]}
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
    from repro_torch.kernels.tile_matmul.ref import tile_matmul_batched_ref, tile_matmul_ref
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

    # Wall seconds of each part of the script, from the end of the one before.
    phase_s = detail["phase_s"] = {}
    clock = [time.perf_counter()]

    def mark(part: str) -> None:
        now = time.perf_counter()
        phase_s[part] = now - clock[0]
        clock[0] = now

    # 2. Build every kernel, one nvcc each, all at once.
    _build.build_all()
    mark("build")
    print(f"build: {phase_s['build']:.1f} s")
    sass = start_sass(_build)  # read by kernel_build_report after the checks

    # 3. Each kernel against its plain version at the paths' shapes.
    detail["tile_matmul_err"] = check_tile_matmul(tm_kernel, tile_matmul_ref)
    detail["flash_attention_err"] = check_flash(fa_kernel, flash_attention_ref)
    detail["ssd_scan_err"] = check_ssd(ssd_kernel, ssd_plain)
    detail["tile_matmul_grad_err"] = check_tile_matmul_grad(tm_kernel, tile_matmul_ref)
    detail["flash_attention_bwd_err"] = check_flash_bwd(fa_kernel, flash_attention_ref,
                                                        flash_attention_bwd_ref)
    detail["dense_projections_err"] = check_dense_projections(tm_kernel, tile_matmul_ref, M,
                                                              get_config)
    detail["ssd_scan_bwd_err"] = check_ssd_bwd(ssd_kernel, ssd_plain_bwd)
    detail["moe_batched_err"] = check_moe_batched(tm_kernel, tile_matmul_ref, get_config)
    detail["mlp_ops"] = check_mlp_ops(tm_kernel, tile_matmul_ref)
    _record("check_mlp_ops", detail["mlp_ops"])
    detail["moe_ops"] = check_moe_ops(tm_kernel, tile_matmul_ref)
    _record("check_moe_ops", detail["moe_ops"])
    print(f"checks: tile_matmul max |err| {detail['tile_matmul_err']}, "
          f"flash_attention max |err| "
          f"{ {k: v for k, v in detail['flash_attention_err'].items() if k != 'by_case'} }, "
          f"ssd_scan max |err| "
          f"{ {k: v for k, v in detail['ssd_scan_err'].items() if k != 'by_case'} }, "
          f"tile_matmul dx/dw max |err| {detail['tile_matmul_grad_err']}, "
          f"flash_attention_bwd max |err| {detail['flash_attention_bwd_err']}, "
          f"dense configs' projections max |err| "
          f"{max(detail['dense_projections_err'].values())}, "
          f"ssd_scan_bwd max |err| / max |grad| {detail['ssd_scan_bwd_err']}, "
          f"batched expert products max |err| {detail['moe_batched_err']}")
    detail["ptxas"] = {k: _build.build_log(k) for k in _build.KERNELS}
    detail["kernel_build"] = kernel_build_report(_build, detail["ptxas"], sass)
    for k, rep in detail["kernel_build"].items():
        print(f"{k} build: {rep}")

    mark("checks")

    # 4. Times: kernel, plain version, one PyTorch call as yardstick.
    detail["tile_matmul_time"] = time_tile_matmul(tm_kernel, tile_matmul_ref)
    detail["flash_attention_time"] = time_flash(fa_kernel, flash_attention_ref)
    detail["ssd_scan_time"] = time_ssd(ssd_kernel, ssd_plain)
    detail["ssd_scan_jamba_time"] = time_ssd(ssd_kernel, ssd_plain, SSD_JAMBA)
    detail["tile_matmul_grad_time"] = time_tile_matmul_grad(tm_kernel, tile_matmul_ref)
    detail["flash_attention_bwd_time"] = time_flash_bwd(fa_kernel, flash_attention_bwd_ref)
    detail["tile_matmul_grad_mamba2_time"] = time_tile_matmul_grad(tm_kernel, tile_matmul_ref,
                                                                   "mamba2_2_7b")
    for arch in ("musicgen_medium", "internvl2_76b"):
        detail[f"tile_matmul_grad_{arch.split('_')[0]}_time"] = time_tile_matmul_grad(
            tm_kernel, tile_matmul_ref, arch)
    detail["ssd_scan_bwd_time"] = time_ssd_bwd(ssd_kernel, ssd_plain_bwd)
    detail["moe_batched_time"] = time_moe_batched(tm_kernel, tile_matmul_batched_ref, get_config)
    detail["moe_batched_deepseek_time"] = time_moe_batched(tm_kernel, tile_matmul_batched_ref,
                                                           get_config, DEEPSEEK)
    detail["moe_batched_jamba_time"] = time_moe_batched(tm_kernel, tile_matmul_batched_ref,
                                                        get_config, JAMBA)
    detail["moe_batched_grad_time"] = time_moe_batched_grad(tm_kernel, tile_matmul_batched_ref,
                                                            get_config)
    for k in ("tile_matmul", "flash_attention", "ssd_scan", "ssd_scan_jamba", "tile_matmul_grad",
              "flash_attention_bwd", "tile_matmul_grad_mamba2", "tile_matmul_grad_musicgen",
              "tile_matmul_grad_internvl2", "ssd_scan_bwd", "moe_batched",
              "moe_batched_deepseek", "moe_batched_jamba", "moe_batched_grad"):
        print(f"times (ms): {k} {detail[k + '_time']}")

    mark("times")

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

    mark("serve_smollm_360m")

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

    # 7. Paths 3-5: serve the dense-attention configs at full width (gemma3
    # and danube at full depth, command_r at 8 of 64 layers): every
    # projection through tile_matmul, every prefill attention through
    # flash_attention at D 256, 80 and 128; float32 logits against the CPU.
    mark("serve_mamba2_2_7b")
    g3 = detail["serve_gemma3"] = serve_gemma3(serve, M, rehome, get_config, counters)
    _record("serve_gemma3_12b", g3)
    mark("serve_gemma3_12b")
    dn = detail["serve_danube"] = serve_danube(serve, M, rehome, get_config, counters)
    _record("serve_h2o_danube_1_8b", dn)
    mark("serve_h2o_danube_1_8b")
    cr = detail["serve_command_r"] = serve_command_r(serve, M, rehome, get_config, counters)
    _record("serve_command_r_plus_104b", cr)
    mark("serve_command_r_plus_104b")

    # 7b. Path 6: serve full-width, full-depth qwen2_moe_a2_7b: the expert
    # products as three batched tile_matmul launches a layer, the float32
    # router, D 128 attention at G 1; float32 routing and logits against
    # the CPU.
    q2 = detail["serve_qwen2"] = serve_moe(serve, M, rehome, get_config, counters, QWEN2)
    _record("serve_qwen2_moe_a2_7b", q2)
    mark("serve_qwen2_moe_a2_7b")

    # 7c. Path 7: serve full-width, full-depth deepseek_v2_lite_16b: MLA
    # (prefill attention at q/k head dim 192 and v head dim 128, the latent's
    # up-projections through tile_matmul, decode in the latent space), the
    # dense first layer, then 26 MoE layers of 64 experts at top-6; float32
    # routing and logits against the CPU on the dense layer and one MoE layer.
    ds = detail["serve_deepseek"] = serve_moe(serve, M, rehome, get_config, counters, DEEPSEEK)
    _record("serve_deepseek_v2_lite_16b", ds)
    mark("serve_deepseek_v2_lite_16b")

    # 7d. Paths 8-9: the two frontends at full width, as the dense configs
    # are served: musicgen_medium (codebooks: (B, T, 4) prompts, a token a
    # codebook a step; the GELU FFN's bias and GELU in tile_matmul's
    # epilogue; MHA at D 64) at full depth, and internvl2_76b (embeds: seeded
    # prompt embeddings, one a decode step; G 8, D 128) at 16 of its 80
    # layers; float32 logits against the CPU.
    mg = detail["serve_musicgen"] = dense_serve(serve, M, rehome, get_config,
                                                "musicgen_medium", counters)
    assert mg["projections"] == 6 * mg["layers"] == 288, mg["projections"]
    _record("serve_musicgen_medium", mg)
    mark("serve_musicgen_medium")
    iv = detail["serve_internvl2"] = dense_serve(serve, M, rehome, get_config, "internvl2_76b",
                                                 counters)
    assert iv["projections"] == 7 * iv["layers"] == 112, iv["projections"]
    _record("serve_internvl2_76b", iv)
    mark("serve_internvl2_76b")

    # 7e. Path 10: serve full-width jamba_1_5_large_398b at the first 4
    # layers of its period (attention + dense FFN, then Mamba layers with
    # MoE, dense and MoE FFNs): the hybrid cache, ssd_scan at 256 heads in 8
    # groups, 16 experts top-2 whose weight tensors pass 2^31 elements;
    # float32 routing and logits against the CPU on its layers 0 and 7; the
    # reduced config served and one float32 train step on the card.
    jb = detail["serve_jamba"] = serve_jamba(serve, M, rehome, steps_mod, get_config, counters)
    _record("serve_jamba_1_5_large_398b", jb)
    mark("serve_jamba_1_5_large_398b")

    # 7f. The twin of examples/serve_batched.py: reduced smollm, mamba2,
    # deepseek and musicgen (float32: tile_matmul on ffma and skinny,
    # attention and scan on ffma), tokens against the CPU's.
    sb = detail["serve_batched"] = serve_batched(M, rehome, get_config, counters)
    _record("serve_batched", sb)
    mark("serve_batched")

    # 8. Path 6: train full-width, full-depth smollm_360m through ``train``.
    # 9. Path 7: the same for full-width, full-depth mamba2_2_7b.
    trains = {}
    for key, tcfg in (("", cfg), ("_mamba2", mcfg)):
        tr, res = train_path(train, M, tcfg, counters)
        detail["train" + key] = tr
        prof = detail["profile_train" + key] = profile_train_step(steps_mod, tcfg, res,
                                                                  counters)
        _print_train_profile(tcfg.name, prof)
        assert prof["launches"] == _step_want(tcfg)[0], prof["launches"]
        trains[tcfg.name] = tr
        del res
        torch.cuda.empty_cache()
        detail["parity_train_f32" + key] = parity_train_f32(
            M, steps_mod, dataclasses.replace(tcfg, n_periods=4))
        print(f"parity f32 train step {tcfg.name} full width, 4 layers: "
              f"{detail['parity_train_f32' + key]}")
        torch.cuda.empty_cache()
    tr, mt = trains[cfg.name], trains[mcfg.name]

    # 9b. The dense-attention train paths: full-width, full-depth h2o_danube_1_8b (2 x 8192)
    # and full-width gemma3_12b at 12 layers (2 x 2048): every attention's
    # gradient through flash_attention_bwd at D 80 and 256.
    mark("train_smollm_mamba2")
    tdn = detail["train_danube"] = dense_train(train, M, steps_mod, get_config,
                                               "h2o_danube_1_8b", counters)
    _record("train_h2o_danube_1_8b", tdn)
    mark("train_h2o_danube_1_8b")
    tg3 = detail["train_gemma3"] = dense_train(train, M, steps_mod, get_config, "gemma3_12b",
                                               counters)
    _record("train_gemma3_12b", tg3)
    mark("train_gemma3_12b")

    # 9c. Train full-width qwen2_moe_a2_7b at 4 of its 24 layers (8 x 1024):
    # each expert product's gradients as batched tile_matmul launches in
    # x@w^T and x^T@w, the attention's through flash_attention_bwd at D 128
    # on wgmma; remat and determinism; a float32 step against the CPU.
    tq2 = detail["train_qwen2"] = train_moe(train, M, steps_mod, get_config, counters, QWEN2)
    _record("train_qwen2_moe_a2_7b", tq2)
    mark("train_qwen2_moe_a2_7b")

    # 9d. Train full-width deepseek_v2_lite_16b at 5 of its 27 layers (the
    # dense first layer and 4 MoE layers, 8 x 1024): every MLA backward
    # through flash_attention_bwd at q/k head dim 192 and v head dim 128 on
    # wgmma, MLA's products and their gradients through tile_matmul; remat
    # and determinism; a float32 step of 2 layers against the CPU.
    tds = detail["train_deepseek"] = train_moe(train, M, steps_mod, get_config, counters,
                                               DEEPSEEK)
    _record("train_deepseek_v2_lite_16b", tds)
    mark("train_deepseek_v2_lite_16b")

    # 9e. Train the two frontends: full-width, full-depth musicgen_medium
    # (codebooks, 8 x 512; 6 products a layer, the FFN's up with bias and
    # GELU, the attention backward at D 64, G 1) with the remat check on 2
    # layers and a profiled step under remat "dots"; full-width internvl2_76b
    # at 2 of its 80 layers (embeds, 8 x 512; the attention backward at D
    # 128, G 8); a float32 step of each against the CPU.
    tmg = detail["train_musicgen"] = dense_train(train, M, steps_mod, get_config,
                                                 "musicgen_medium", counters)
    _record("train_musicgen_medium", tmg)
    mark("train_musicgen_medium")
    tiv = detail["train_internvl2"] = dense_train(train, M, steps_mod, get_config,
                                                  "internvl2_76b", counters)
    _record("train_internvl2_76b", tiv)
    mark("train_internvl2_76b")

    # 10. Path 8: train full-width, full-depth smollm_360m through the ACAN
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

    mark("acan")

    # 10b. The twin of examples/acan_jax_train.py: reduced
    # deepseek_v2_lite_16b (MLA, MoE; float32 on the ffma paths) trained by
    # the ACAN runner without and with the example's handler crashes.
    ad = detail["acan_deepseek"] = acan_deepseek(step_runner, get_config, counters)
    _record("acan_deepseek", ad)
    mark("acan_deepseek")

    # 11. Path 9: the paper's three experiments at its width, the MLP's tile
    # products through tile_matmul (float32 skinny / ffma); the float32 MLP
    # against the CPU's; the MLP and full-width smollm_360m as two tenants of
    # one cloud under Manager and Handler crashes.
    pp = detail["paper"] = paper_path(counters)
    _record("paper_path", pp)
    detail["parity_mlp_f32"] = parity_mlp_f32()
    _record("parity_mlp_f32", detail["parity_mlp_f32"])
    ct = detail["cloud_tenants"] = cloud_tenants(counters)
    _record("cloud_tenants", ct)
    torch.cuda.empty_cache()

    mark("paper")

    # 12. Path 10: the paper's exp 1 on the thread fleet and on the process
    # fleet (worker processes on the card, their launches read from the
    # counts they write), with and without SIGKILLed workers; CUDA tensors
    # through a remote space.
    pf = detail["process_fleet"] = process_fleet(counters)
    _record("process_fleet", pf)

    mark("process_fleet")

    # 13. Path 11: the MoE routing program on the card, fault-free and under
    # crashes, against the CPU.
    mp = detail["moe"] = moe_path(counters)
    _record("moe_path", mp)

    mark("moe")
    print(f"phase seconds: { {k: round(v, 1) for k, v in phase_s.items()} }, "
          f"in all {sum(phase_s.values()):.1f}")

    # 14. Results. A kernel that runs on several paths: its launches are the sum.
    tt = detail["tile_matmul_time"]
    tmt, fat = tt["prefill"], detail["flash_attention_time"]
    fat = fat["smollm_360m"]
    sst, gt = detail["ssd_scan_time"], detail["tile_matmul_grad_time"]
    fbts, sbt = detail["flash_attention_bwd_time"], detail["ssd_scan_bwd_time"]
    fbt = fbts["smollm_360m"]
    trained = (tr, mt, tdn, tg3, tq2, tds, tmg, tiv)
    runs = (sm, ms, g3, dn, cr, q2, ds, mg, iv, jb, sb, *trained, ac, ad, pp, ct, pf, mp)
    mlp_t = detail["mlp_ops"]["times"]["256x256"]
    moe_t = detail["moe_ops"]["times"]
    qb, qbg = detail["moe_batched_time"], detail["moe_batched_grad_time"]
    dsb, jbb = detail["moe_batched_deepseek_time"], detail["moe_batched_jamba_time"]
    ssj = detail["ssd_scan_jamba_time"]

    def batched_record(times: dict, serve_run: dict, E: int) -> dict:
        """The batched expert launch's numbers at one MoE config's rows:
        its times, its launches in that config's serve by phase, and its
        worst bf16 error at those rows."""
        return {phase: {k: times[phase][k] for k in (
            "shape", "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "bound_by", "tflop_s", "gb_s")}
            | {"launches": serve_run["tile_matmul_layouts"]["batched"]
               * (1 if phase == "prefill" else GEN) // (1 + GEN),
               "max_abs_err": max(v for c, v in detail["moe_batched_err"].items()
                                  if c.startswith(f"{phase} {E}x") and "bfloat16" in c)}
            for phase in times}

    def summed(name: str) -> dict:
        """Launches of ``name`` over the twenty-five paths (the ten serves,
        the twin of serve_batched.py, the eight train runs, the ACAN path's
        crash-free run and its deepseek twin's, the paper's four MLP runs,
        the two-tenant cloud's crash run, exp 1's three fleet runs with the
        workers' own launches, the MoE's six runs on the card), in all and
        by path."""
        by = {p: sum(r["launches_by_path"][name][p] for r in runs)
              for p in sm["launches_by_path"][name]}
        return dict(launches=sum(r["launches"][name] for r in runs), launches_by_path=by)

    kernels = [
        dict(name="tile_matmul", route="cuda", source="src/repro_torch/csrc/tile_matmul.cu",
             replaces="src/repro/kernels/tile_matmul/kernel.py:58",
             **summed("tile_matmul"),
             launches_by_layout_in_training={
                 k: sum(r["tile_matmul_layouts"][k] for r in trained)
                 for k in tr["tile_matmul_layouts"]},
             max_abs_err=detail["tile_matmul_err"][str(torch.bfloat16)],
             ms=tmt["ms"], plain_ms=tmt["plain_ms"], bound_ms=tmt["bound_ms"],
             bound_by=tmt["bound_by"], library_ms=tmt["library_ms"],
             timed="one smollm layer's 7 prefill projections, M=4096, bf16; mamba2's "
                   "6 in chip_smoke.json; musicgen's and internvl2's under served_layers",
             served_layers={arch: {phase: {k: tt[f"{key}_{phase}"][k] for k in (
                 "M", "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                 "bound_ms", "bound_by", "tflop_s", "gb_s")}
                 | {"launches": run["projections"] * (1 if phase == "prefill" else GEN),
                    "max_abs_err": max(v for c, v in detail["dense_projections_err"].items()
                                       if c.startswith(arch) and "bfloat16" in c
                                       and c.split()[1].startswith(str(tt[f"{key}_{phase}"]["M"])
                                                                   + "x"))}
                 for phase in ("prefill", "decode")}
                 | {"timed": f"one {arch} layer's bf16 projections; library: torch.matmul "
                             "(torch.addmm with a bias) and the activation"}
                 for arch, key, run in (("musicgen_medium", "musicgen", mg),
                                        ("internvl2_76b", "internvl2", iv))},
             grad={k: gt["both"][k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms")}
             | {"max_abs_err": detail["tile_matmul_grad_err"][str(torch.bfloat16)],
                "timed": "dx = dz @ w^T (w read in place, K-major wgmma B) and "
                         "dw = x^T @ dz (x read in place, MN-major wgmma A) of one "
                         "smollm layer's 7 projections, M=4096, bf16"},
             grad_by_config={arch: {part: {k: t[part][k] for k in (
                 "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "flop",
                 "tflop_s")} for part in ("dx", "dw", "z")}
                 | {"launches": {"dx": run["tile_matmul_layouts"]["x@w^T"],
                                 "dw": run["tile_matmul_layouts"]["x^T@w"],
                                 "z": run["tile_matmul_outputs"]["bfloat16->float32"]},
                    "max_abs_err": detail["tile_matmul_grad_err"][str(torch.bfloat16)],
                    "timed": f"one {arch} layer's bf16 gradient products at M=4096 (dx, dw: "
                             "library torch.matmul on the transposed views) and the float32 z "
                             "of its fused product (" + ("up with bias and GELU: library "
                             "torch.addmm" if arch == "musicgen_medium" else "gate with "
                             "SiLU: library torch.matmul") + ", which writes bf16); launches: "
                             "the config's train run"}
                 for arch, t, run in (("musicgen_medium",
                                       detail["tile_matmul_grad_musicgen_time"], tmg),
                                      ("internvl2_76b",
                                       detail["tile_matmul_grad_internvl2_time"], tiv))},
             mlp_f32={k: mlp_t[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                            "library_device_ms", "bound_ms", "bound_by",
                                            "path")}
             | {"max_abs_err": max(detail["mlp_ops"]["max_abs_err"].values()),
                "launches": pp["launches_by_path"]["tile_matmul"]["skinny"]
                + pp["launches_by_path"]["tile_matmul"]["ffma"],
                "timed": "one launch of the paper MLP's layer-0 product: 16 masked rows "
                         "(16, 256) @ (256, 256), float32; launches: the paper's four "
                         "runs, skinny + ffma"},
             moe_f32={k: moe_t[k] for k in ("ms", "device_ms", "plain_ms", "library_ms",
                                            "library_device_ms", "bound_ms", "bound_by",
                                            "paths", "shape")}
             | {"max_abs_err": max(detail["moe_ops"]["max_abs_err"].values()),
                "launches": mp["launches"]["tile_matmul"],
                "launches_by_layout": mp["launches_by_layout"],
                "timed": "one MoE expert forward task's two products, relu(x @ W1^T) "
                         "and h @ W2^T (x@w^T layout), float32; library: torch.matmul "
                         "and relu; launches: the MoE's six runs on the card"},
             moe_batched=batched_record(qb, q2, 60)
             | {"timed": "one qwen2_moe_a2_7b layer's three expert products (gate with SiLU, "
                         "up, down), 60 experts, bf16, batched wgmma launches; library: "
                         "torch.bmm (and silu); launches: the qwen2 serve's, prefill and its "
                         "32 decode steps",
                "bound_of": "the padded product timed here: every capacity row of all 60 "
                            "experts; routed_bound_ms: the work the serve's routing needs, "
                            "kept rows (prefill) and routed experts (decode), a layer",
                "routed_bound_ms": {"prefill": q2["prefill_experts_bound_ms"],
                                    "decode": q2["decode_experts_bound_ms"]}},
             moe_batched_deepseek=batched_record(dsb, ds, 64)
             | {"timed": "one deepseek_v2_lite_16b MoE layer's three expert products, 64 "
                         "experts at 960 (prefill) and 48 (decode) rows an expert, bf16, "
                         "batched wgmma launches; library: torch.bmm (and silu); launches: "
                         "the deepseek serve's, prefill and its 32 decode steps",
                "routed_bound_ms": {"prefill": ds["prefill_experts_bound_ms"],
                                    "decode": ds["decode_experts_bound_ms"]}},
             moe_batched_jamba=batched_record(jbb, jb, 16)
             | {"timed": "one jamba_1_5_large_398b MoE layer's three expert products, 16 "
                         "experts of d_ff 24576 (each weight tensor 3.22 B elements) at 640 "
                         "(prefill) and 16 (decode) rows an expert, bf16, batched wgmma "
                         "launches; library: torch.bmm (and silu); launches: the jamba "
                         "serve's, prefill and its 32 decode steps",
                "routed_bound_ms": {"prefill": jb["prefill_experts_bound_ms"],
                                    "decode": jb["decode_experts_bound_ms"]}},
             moe_batched_grad={layout: {k: qbg[layout][k] for k in (
                 "shape", "product", "ms", "device_ms", "plain_ms", "library_ms",
                 "library_device_ms", "bound_ms", "bound_by", "tflop_s")}
                 | {"launches": tq2["tile_matmul_layouts"]["batched " + layout],
                    "max_abs_err": max(v for c, v in detail["moe_batched_err"].items()
                                       if c.startswith(f"train {qbg[layout]['product']}")
                                       and "bfloat16" in c)}
                 for layout in qbg}
             | {"timed": "one qwen2_moe_a2_7b layer's three expert products' dx = dz @ w^T "
                         "and dw = x^T @ dz at 688 rows an expert, bf16, batched wgmma "
                         "launches reading the transposed operand where it lies; library: "
                         "torch.bmm on the transposed views; launches: the qwen2 train run"}),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:88",
             **summed("flash_attention"),
             max_abs_err=detail["flash_attention_err"][str(torch.bfloat16)],
             ms=fat["ms"], plain_ms=fat["plain_ms"], bound_ms=fat["bound_ms"],
             bound_by=fat["bound_by"], library_ms=fat["library_ms"], ffma_ms=fat["ffma_ms"],
             device_ms=fat["device_ms"], library_device_ms=fat["library_device_ms"],
             timed="one layer's prefill attention, q (40, 3, 512, 64), causal, bf16, "
                   "mma path; the dense configs', qwen2's and deepseek's (q/k head dim 192, "
                   "v head dim 128) layers under by_config",
             by_config={k: {key: t[key] for key in (
                 "q_shape", "v_shape", "window", "kernel", "ms", "device_ms", "tflop_s", "plain_ms",
                 "library_ms", "library_device_ms", "library_backend", "bound_ms", "bound_by",
                 "ffma_ms")}
                 for k, t in detail["flash_attention_time"].items() if k != "smollm_360m"},
             err_by_case=detail["flash_attention_err"]["by_case"],
             jamba_launches={"shape": "q (64, 8, 512, 128) causal, internvl2_76b's of "
                                      "by_config", "launches": jb["launches"]["flash_attention"]}),
        dict(name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:70",
             **summed("ssd_scan"),
             max_abs_err=detail["ssd_scan_err"][str(torch.bfloat16)]["y"],
             ms=sst["ms"], plain_ms=sst["plain_ms"], bound_ms=sst["bound_ms"],
             bound_by=sst["bound_by"], library_ms=None, ffma_ms=sst["ffma_ms"],
             device_ms=sst["device_ms"],
             timed="one mamba2 layer's prefill scan, x (8, 512, 80, 64), N 128, bf16, "
                   "mma path; jamba's under by_config",
             by_config={JAMBA: {k: ssj[k] for k in (
                 "shape", "ms", "device_ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                 "ffma_ms", "flop", "bytes")}
                 | {"launches": jb["launches"]["ssd_scan"],
                    "max_abs_err": detail["ssd_scan_err"]["by_case"][f"jamba {torch.bfloat16}"],
                    "timed": "one jamba_1_5_large_398b Mamba layer's prefill scan, x (8, 512, "
                             "256, 64), 8 groups, N 128, bf16, mma path; launches: the jamba "
                             "serve's"}}),
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
                   "repeated; the dense configs', qwen2's and deepseek's training layers "
                   "(wgmma at D 80, 128, 256 and q/k 192 with v 128; library: the "
                   "backward of an SDPA call, a window as a mask; without a window also "
                   "cuDNN's backward op by graph replay) and the reduced deepseek pair "
                   "(24, 16) in float32 on ffma under by_config",
             by_config={k: {key: t.get(key) for key in (
                 "q_shape", "v_shape", "dtype", "window", "kernels", "ms", "device_ms",
                 "device_tflop_s", "plain_ms", "library_ms", "library_device_ms",
                 "library_device_error", "library_backend", "bound_ms", "bound_by", "ffma_ms",
                 "dq_ms", "dkv_ms", "flop")}
                 for k, t in fbts.items() if k != "smollm_360m"},
             launches_by_train_run={r["arch"]: r["launches"]["flash_attention_bwd"]
                                    for r in (tr, tdn, tg3, tq2, tds, tmg, tiv, ad)},
             err_by_case=detail["flash_attention_bwd_err"]["by_case"]),
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
