#!/usr/bin/env python3
"""Design probe for the CUDA tile_matmul kernel on one NVIDIA GPU.

Builds ``src/repro_torch/csrc/tile_matmul.cu`` and variants of it, each a
text patch of the source named in ``VARIANTS``. Each library is held
against the plain PyTorch version at ragged and serving shapes and checked
for determinism and batch invariance. Then it is timed:

- device time of each serving projection of smollm_360m and mamba2_2_7b,
  at prefill (M 4096) and cold decode (M 8, cycling 8 weight copies past
  the L2), by CUDA-graph replay, beside ``torch.matmul`` timed the same
  way;
- host time of one wrapper call and of its parts, against one
  ``torch.matmul`` call, over 2000 calls.

Every variant runs in its own process with a time limit, and every variant
adds a watchdog that traps a ``wgmma`` pipeline barrier that never
completes. Results go to ``chiprun_out/probe_tile_matmul.json``.

Usage (from the repository root, on a host with a CUDA device)::

    python3 probe_tile_matmul.py                 # every variant
    python3 probe_tile_matmul.py shipped bn128   # some of them
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "probe_tile_matmul"
RESULT = ROOT / "chiprun_out" / "probe_tile_matmul.json"

# name -> (old, new) text patches applied to the shipped source.
VARIANTS = {
    "shipped": [],
    "swap_b_offsets": [("sw128_desc(sb + 2048 * kk, WG_BK * 128, 1024)",
                        "sw128_desc(sb + 2048 * kk, 1024, WG_BK * 128)")],
    "bn128": [("N >= 512 ? launch_wgmma<256", "false ? launch_wgmma<256")],
    "bn256": [("N >= 512 ? launch_wgmma<256", "true ? launch_wgmma<256")],
    "lanes8": [("SK_MAX_LG = 5,", "SK_MAX_LG = 3,")],
    "lanes16": [("SK_MAX_LG = 5,", "SK_MAX_LG = 4,")],
    "two_per_sm": [("const int target = sm_count()", "const int target = 2 * sm_count()")],
    "u2": [("SK_U = 4;", "SK_U = 2;")],
    "u8": [("SK_U = 4;", "SK_U = 8;")],
    "one_block_bound": [("__launch_bounds__(SK_THREADS, SK_MAXM / MT)",
                         "__launch_bounds__(SK_THREADS, 1)")],
    "u6_one_block_bound": [("SK_U = 4;", "SK_U = 6;"),
                           ("__launch_bounds__(SK_THREADS, SK_MAXM / MT)",
                            "__launch_bounds__(SK_THREADS, 1)")],
    "u8_one_block_bound": [("SK_U = 4;", "SK_U = 8;"),
                           ("__launch_bounds__(SK_THREADS, SK_MAXM / MT)",
                            "__launch_bounds__(SK_THREADS, 1)")],
}
WATCHDOG = [("  uint32_t done;\n  do {", "  uint32_t done, spins = 0;\n  do {"),
            ("  } while (!done);\n}",
             "    if (++spins > (1u << 22)) __trap();\n  } while (!done);\n}")]

CHECKS = [(300, 960, 320), (4096, 2560, 80), (17, 72, 136), (4097, 96, 128),
          (400, 2560, 5120), (4096, 960, 2560), (8, 960, 320), (3, 40, 20), (8, 5120, 2560),
          (16, 2560, 80), (257, 40, 20), (64, 96, 48), (8, 2560, 128), (1, 16, 8),
          (8, 256, 40960), (16, 5120, 2560), (5, 1000, 80), (12, 2560, 136)]
SHAPES = {"smollm": ((960, 960), (960, 320), (960, 2560), (2560, 960)),
          "mamba2": ((2560, 5120), (2560, 128), (2560, 80), (5120, 2560))}


def source(name: str) -> str:
    from repro_torch.kernels import _build
    text = (_build.CSRC / "tile_matmul.cu").read_text()
    # the shared header inline, so that the watchdog reaches its mbar_wait
    text = text.replace('#include "hopper.cuh"', (_build.CSRC / "hopper.cuh").read_text())
    for old, new in WATCHDOG + VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: patch target not found once: {old!r}")
        text = text.replace(old, new)
    return text


def build(names: list[str]) -> dict:
    """One nvcc per variant, all at once; returns name -> (rc, nvcc output)."""
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = OUT / f"{name}.cu"
        src.write_text(source(name))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *_build.INCLUDE, "-o",
             str(OUT / f"lib{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        built[name] = (proc.returncode, log)
    return built


def measure(so: str) -> dict:
    """Checks and times of one built library (run in its own process)."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.tile_matmul import kernel as K
    from repro_torch.kernels.tile_matmul.ref import tile_matmul_ref
    _build._libs["tile_matmul"] = ctypes.CDLL(so)

    def rnd(shape, dt, seed, scale=1.0):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(dt)

    res: dict = {"fails": [], "checks": 0}
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-4)):
        for m, k, n in CHECKS:
            x, w, b = rnd((m, k), dt, m + k), rnd((k, n), dt, n, k ** -0.5), rnd((n,), dt, 7)
            for act, bias in (("none", None), ("silu", b), ("gelu", b)):
                out = K.tile_matmul(x, w, bias, activation=act).float()
                ref = tile_matmul_ref(x, w, bias, activation=act).float()
                bad = int(((out - ref).abs() > tol + tol * ref.abs()).sum())
                res["checks"] += 1
                if bad:
                    res["fails"].append(dict(m=m, k=k, n=n, dtype=str(dt), act=act, bad=bad))
    x, w = rnd((4096, 2560), torch.bfloat16, 3), rnd((2560, 5120), torch.bfloat16, 4, 0.02)
    full = K.tile_matmul(x, w)
    res["deterministic"] = bool(torch.equal(full, K.tile_matmul(x, w)))
    res["batch_invariant"] = bool(torch.equal(full[:300], K.tile_matmul(x[:300].contiguous(), w)))

    def device_ms(fn, reps=10):
        fn()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def host_us(fn, n=2000):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    x8, w8, x64 = (rnd((8, 64), torch.bfloat16, 1), rnd((64, 64), torch.bfloat16, 2),
                   rnd((64, 64), torch.bfloat16, 3))
    dev = x8.device
    launch = K._lib()
    out8 = torch.empty((8, 64), dtype=torch.bfloat16, device=dev)
    res["host_us"] = {
        "empty": host_us(lambda: torch.empty((8, 64), dtype=torch.bfloat16, device=dev)),
        "current_stream": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
        "ctypes_refused": host_us(lambda: launch(x8.data_ptr(), w8.data_ptr(), None,
                                                 out8.data_ptr(), 8, 64, 64, 1, 1, 0, 9, 0, 1,
                                                 None)),
        "choose_path": host_us(lambda: K.choose_path(8, 64, 64, torch.bfloat16, True)),
        "skinny_call": host_us(lambda: K.tile_matmul(x8, w8)),
        "wgmma_call": host_us(lambda: K.tile_matmul(x64, w8)),
        "torch_matmul": host_us(lambda: torch.matmul(x8, w8)),
    }
    res["device_us"] = {}
    for m, copies in ((4096, 1), (8, 8)):
        for model, shapes in SHAPES.items():
            for k, n in shapes:
                x = rnd((m, k), torch.bfloat16, k)
                ws = [rnd((k, n), torch.bfloat16, c, k ** -0.5) for c in range(copies)]
                kern = device_ms(lambda: [K.tile_matmul(x, w) for w in ws]) / copies
                lib = device_ms(lambda: [torch.matmul(x, w) for w in ws]) / copies
                res["device_us"][f"{model} M{m} {k}x{n}"] = [kern * 1e3, lib * 1e3]
    return res


def main(names: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_tile_matmul: no CUDA device; this script runs on a GPU host",
              file=sys.stderr)
        return 1
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"unknown variants {sorted(unknown)}; known: {sorted(VARIANTS)}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    built = build(names)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    results = {"device": torch.cuda.get_device_name(0)}
    for name, (rc, log) in built.items():
        ptxas = [ln.strip() for ln in log.splitlines() if "Used" in ln or "spill" in ln]
        if rc != 0:
            results[name] = {"build_failed": log[-4000:]}
            print(f"{name}: build failed\n{log[-4000:]}", flush=True)
            continue
        try:
            so = str(OUT / f"lib{name}.so")
            run = subprocess.run([sys.executable, __file__, "--measure", so],
                                 capture_output=True, text=True, timeout=300)
            lines = [ln for ln in run.stdout.splitlines() if ln.startswith("{")]
            results[name] = json.loads(lines[-1]) if lines else {"error": run.stderr[-4000:]}
        except subprocess.TimeoutExpired:
            results[name] = {"error": "timed out"}
        r = results[name]
        r["ptxas"] = ptxas
        print(f"{name}: checks {r.get('checks')} fails {len(r.get('fails', []))} "
              f"deterministic {r.get('deterministic')} batch-invariant "
              f"{r.get('batch_invariant')} {r.get('error', '')}", flush=True)
        print(f"  host us: {r.get('host_us')}", flush=True)
        for shape, (kern, lib) in r.get("device_us", {}).items():
            print(f"  {shape}: kernel {kern:.2f} us, torch.matmul {lib:.2f} us", flush=True)
    RESULT.parent.mkdir(exist_ok=True)
    RESULT.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--measure":
        print(json.dumps(measure(sys.argv[2])))
    else:
        sys.exit(main(sys.argv[1:] or list(VARIANTS)))
