#!/usr/bin/env python3
"""Design probe for the mma paths of the CUDA flash_attention and ssd_scan
kernels on one NVIDIA GPU.

Builds ``src/repro_torch/csrc/{flash_attention,ssd_scan}.cu`` and variants
of them, each a text patch of the ``mma`` section of the source named in
``VARIANTS``. A variant whose name holds ``cut_`` leaves out part of
the work, so its output is wrong by design: it is timed to see what that
part costs, and not checked. Every other variant is held against the plain
PyTorch version (bf16: 2e-2; the SSD state: 1e-3). Each is timed at the
serving shapes of ``chip_smoke.py`` (q (40, 3, 512, 64) causal; x (8, 512,
80, 64), N 128), in its own process, two ways: CUDA events around 20 calls
made back to back from Python (``ms``, as ``chip_smoke.py`` times), and
the same 20 calls replayed from a CUDA graph (``device_ms``: device time
without the host's cost a call). Attention is timed beside
``scaled_dot_product_attention`` both ways. Results go to
``chiprun_out/probe_attention_scan.json``.

Usage (from the repository root, on a host with a CUDA device)::

    python3 probe_attention_scan.py                  # every variant
    python3 probe_attention_scan.py ssd.shipped ...  # some of them
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
OUT = ROOT / "build" / "probe_attention_scan"
RESULT = ROOT / "chiprun_out" / "probe_attention_scan.json"
MARK = {"flash": "// mma: bf16 tensor cores", "ssd": "// mma: bf16 tensor cores"}
SRC = {"flash": "flash_attention", "ssd": "ssd_scan"}

# "<kernel>.<name>" -> (old, new) text patches of the source's mma section.
VARIANTS = {
    "flash.shipped": [],
    "flash.warps8": [("constexpr int MMA_WARPS = 4;", "constexpr int MMA_WARPS = 8;")],
    "flash.bk128": [("constexpr int MMA_BK = 64;", "constexpr int MMA_BK = 128;")],
    "flash.cut_softmax": [("    const bool masked =", "    const bool masked = false &&"),
                          ("exp2f(", "(")],
    "flash.cut_kv_reload": [("      cp_async16(smem_u32(ks + r * LD + c), kb + off, in);",
                             "      if (kv0 < kv_begin + 2 * MMA_BK)\n"
                             "      cp_async16(smem_u32(ks + r * LD + c), kb + off, in);"),
                            ("      cp_async16(smem_u32(vs + r * LD + c), vb + off, in);",
                             "      if (kv0 < kv_begin + 2 * MMA_BK)\n"
                             "      cp_async16(smem_u32(vs + r * LD + c), vb + off, in);")],
    "flash.cut_to_one_tile": [("  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += MMA_BK, stage ^= 1) {",
                               "  for (int kv0 = kv_begin; kv0 < min(kv_end, kv_begin + MMA_BK); "
                               "kv0 += MMA_BK, stage ^= 1) {")],
    "flash.cut_qk": [("        mma_bf16(s[2 * np], qf[kc], b[0], b[1]);\n"
                      "        mma_bf16(s[2 * np + 1], qf[kc], b[2], b[3]);", "")],
    "flash.cut_pv": [("        mma_bf16(acc[2 * dp], pa[kc], b[0], b[1]);\n"
                      "        mma_bf16(acc[2 * dp + 1], pa[kc], b[2], b[3]);", "")],
    "ssd.shipped": [],
    "ssd.pb64": [("constexpr int PB = 32;", "constexpr int PB = 64;")],
    "ssd.fast_exp": [("expf(", "__expf(")],
    "ssd.cut_bc_reload": [("      cp_async16(smem_u32(Bs + (st * Q + r) * BLD + c), Bb + off, in);\n"
                           "      cp_async16(smem_u32(Cs + (st * Q + r) * BLD + c), Cb + off, in);",
                           "      if (t0 < 2 * Q) {\n"
                           "      cp_async16(smem_u32(Bs + (st * Q + r) * BLD + c), Bb + off, in);\n"
                           "      cp_async16(smem_u32(Cs + (st * Q + r) * BLD + c), Cb + off, in);\n"
                           "      }")],
    "ssd.cut_state": [("    for (int kc = 0; kc < 4; ++kc) {\n      const int tk",
                       "    for (int kc = 0; kc < 0; ++kc) {\n      const int tk")],
    "ssd.cut_scores": [("        if (jp <= rt) {\n          uint32_t bq[4];",
                        "        if (jp > 8) {\n          uint32_t bq[4];")],
}


def source(name: str) -> str:
    kern = name.split(".")[0]
    text = (ROOT / "src" / "repro_torch" / "csrc" / f"{SRC[kern]}.cu").read_text()
    head, mark, body = text.partition(MARK[kern])
    for old, new in VARIANTS[name]:
        assert old in body, (name, old)
        body = body.replace(old, new)
    return head + mark + body


def build(names: list[str]) -> dict:
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT / f"{name}.cu"
        cu.write_text(source(name))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *_build.INCLUDE, "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        logs[name] = {"rc": p.returncode,
                      "ptxas": [l.strip() for l in out.splitlines()
                                if "spill" in l or "Used" in l or "error" in l]}
    return logs


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def _time_ms(fn, iters=20) -> float:
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
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    the graph replayed and timed by CUDA events, so the host's cost a call
    is not in it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _time_ms(graph.replay, iters=5) / iters


def measure(name: str) -> dict:
    """Check (unless a cut_ variant) and time one variant's library."""
    lib = ctypes.CDLL(str(OUT / f"{name}.so"))
    checked = "cut_" not in name
    if name.startswith("flash."):
        from repro_torch.kernels.flash_attention import kernel as K
        from repro_torch.kernels.flash_attention.ref import flash_attention_ref
        fn = lib.flash_attention_launch
        # as kernel.py's _lib binds it
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + list(K._MASK)
                       + [ctypes.c_int, ctypes.c_void_p])

        def call(q, k, v, window=0, softcap=0.0, q_offset=0):
            o = torch.empty_like(q)
            BH, G, Tq, D = q.shape
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), None, BH, G, Tq,
                     k.shape[1], D, D, 1, 1, window, softcap, q_offset, D ** -0.5,
                     K.PATH_CODES["mma"],
                     torch._C._cuda_getCurrentRawStream(0))
            assert err == 0, err
            return o
        err = 0.0
        if checked:
            for bh, g, tq, tk, d, window, softcap in ((40, 3, 512, 512, 64, 0, 0.0),
                                                      (4, 3, 77, 133, 64, 0, 0.0),
                                                      (4, 8, 300, 300, 128, 100, 30.0)):
                q = _randn((bh, g, tq, d), torch.bfloat16, 1)
                k = _randn((bh, tk, d), torch.bfloat16, 2)
                v = _randn((bh, tk, d), torch.bfloat16, 3)
                kw = dict(window=window, softcap=softcap, q_offset=tk - tq)
                out, ref = call(q, k, v, **kw).float(), flash_attention_ref(q, k, v, **kw).float()
                torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
                err = max(err, (out - ref).abs().max().item())
        q = _randn((40, 3, 512, 64), torch.bfloat16, 1)
        k = _randn((40, 512, 64), torch.bfloat16, 2)
        v = _randn((40, 512, 64), torch.bfloat16, 3)
        qs = q.reshape(8, 15, 512, 64)
        ks, vs = (t.reshape(8, 5, 512, 64).repeat_interleave(3, dim=1) for t in (k, v))
        fns = (lambda: call(q, k, v),
               lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
        turns = [_time_ms(f) for f in fns * 2]
        graphs = [_graph_ms(f) for f in fns * 2]
        return dict(checked=checked, max_abs_err=err, ms=(turns[0] + turns[2]) / 2,
                    sdpa_ms=(turns[1] + turns[3]) / 2, device_ms=(graphs[0] + graphs[2]) / 2,
                    sdpa_device_ms=(graphs[1] + graphs[3]) / 2, turns_ms=turns,
                    graph_turns_ms=graphs)
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ops import ssd_plain
    fn = lib.ssd_scan_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]

    def inputs(bt, t, h, p, g, n, seed):
        return (_randn((bt, t, h, p), torch.bfloat16, seed, 0.5),
                F.softplus(_randn((bt, t, h), torch.float32, seed + 1)),
                -torch.exp(_randn((h,), torch.float32, seed + 2, 0.3)),
                _randn((bt, t, g, n), torch.bfloat16, seed + 3, 0.5),
                _randn((bt, t, g, n), torch.bfloat16, seed + 4, 0.5),
                1.0 + _randn((h,), torch.float32, seed + 5, 0.1))

    def call(x, dt, a, b, c, d):
        Bt, T, H, P = x.shape
        y = torch.empty_like(x)
        s = torch.empty((Bt, H, b.shape[3], P), dtype=torch.float32, device="cuda")
        err = fn(*(t.data_ptr() for t in (x, dt, a, b, c, d, y, s)), None, Bt, T, H, b.shape[2],
                 b.shape[3], P, 1, K.PATH_CODES["mma"],
                     torch._C._cuda_getCurrentRawStream(0))
        assert err == 0, err
        return y, s
    err = {"y": 0.0, "state": 0.0}
    if checked:
        for shape in ((8, 512, 80, 64, 1, 128), (2, 200, 80, 64, 8, 128)):
            args = inputs(*shape, seed=sum(shape))
            (y, s), (yr, sr) = call(*args), ssd_plain(*args)
            torch.testing.assert_close(y.float(), yr.float(), rtol=2e-2, atol=2e-2)
            torch.testing.assert_close(s, sr, rtol=1e-3, atol=1e-3)
            err = {"y": max(err["y"], (y.float() - yr.float()).abs().max().item()),
                   "state": max(err["state"], (s - sr).abs().max().item())}
    args = inputs(8, 512, 80, 64, 1, 128, seed=5)
    return dict(checked=checked, max_abs_err=err, ms=_time_ms(lambda: call(*args)),
                device_ms=_graph_ms(lambda: call(*args)))


def main(names: list[str]) -> int:
    if not torch.cuda.is_available():
        print("probe_attention_scan: no CUDA device", file=sys.stderr)
        return 1
    if names[:1] == ["--one"]:
        print(json.dumps(measure(names[1])))
        return 0
    names = names or list(VARIANTS)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    result = {"device": smi, "variants": {}}
    logs = build(names)
    for name in names:
        rec = result["variants"][name] = {"build": logs[name]}
        if logs[name]["rc"] != 0:
            print(f"{name}: build failed {logs[name]['ptxas']}")
            continue
        p = subprocess.run([sys.executable, __file__, "--one", name], capture_output=True,
                           text=True, timeout=300)
        if p.returncode != 0:
            rec["error"] = p.stderr[-2000:]
            print(f"{name}: FAILED {p.stderr[-600:]}")
            continue
        rec.update(json.loads(p.stdout.strip().splitlines()[-1]))
        print(f"{name}: {json.dumps({k: v for k, v in rec.items() if k != 'build'})} "
              f"{[l for l in logs[name]['ptxas'] if 'Used' in l][-1:]}")
    RESULT.parent.mkdir(exist_ok=True)
    RESULT.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
