#!/usr/bin/env python3
"""Design probe for the two gradient kernels on one NVIDIA GPU:
``csrc/flash_attention_bwd.cu`` and ``csrc/ssd_scan_bwd.cu``.

Builds each source and named variants of it, each a text patch listed in
``VARIANTS`` (one ``nvcc`` each, all started together). A variant whose
name holds ``cut_`` leaves out a kernel launch, so its result is wrong by
design: it is timed to see what the rest costs, and not checked. Every other
variant is held against the plain version (bf16: 2e-2, of each gradient's
largest entry for the scan) and for repeat launches giving the same bits.
Each is timed at the training shapes of ``chip_smoke.py`` (attention: q
(40, 3, 512, 64) causal; scan: x (8, 512, 80, 64), N 128, with a final-state
gradient) by CUDA-graph replay of 20 calls (device time without the host's
cost a call), twice, in turns: variants in order, then in reverse. The
attention variants are timed beside SDPA's flash backward op on the same
inputs (K and V repeated to the 15 query heads). Results go to
``chiprun_out/probe_gradients.json``.

Usage (from the repository root, on a host with a CUDA device)::

    python3 probe_gradients.py                    # every variant
    python3 probe_gradients.py attn.shipped ...   # some of them
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
OUT = ROOT / "build" / "probe_gradients"
RESULT = ROOT / "chiprun_out" / "probe_gradients.json"
SRC = {"attn": "flash_attention_bwd", "ssd": "ssd_scan_bwd"}
DKV = "SWB = 128, DQ_BLOCKS = 4, DQ_STAGES = 2, DKV_WGS = 3;"  # D 64's BwdWg
CUT_DQ = ("      flash_bwd_dq_wgmma<D><<<", "      if (BH < 0) flash_bwd_dq_wgmma<D><<<")

# "<kernel>.<name>" -> (old, new) text patches of the kernel's source.
VARIANTS = {
    "attn.shipped": [],
    "attn.dkv_warpgroups2": [(DKV, DKV.replace("DKV_WGS = 3", "DKV_WGS = 2"))],
    "attn.dkv_warpgroups4": [(DKV, DKV.replace("DKV_WGS = 3", "DKV_WGS = 4"))],
    "attn.stages3": [("constexpr int DKV_STAGES = 2;", "constexpr int DKV_STAGES = 3;"),
                     (DKV, DKV.replace("DQ_STAGES = 2", "DQ_STAGES = 3"))],
    "attn.cut_dkv": [("      flash_bwd_dkv_wgmma<D><<<", "      if (BH < 0) flash_bwd_dkv_wgmma<D><<<")],
    "attn.cut_dq": [CUT_DQ],
    # the dK/dV kernel alone, and with parts of its tile-pair loop left out
    "attn.cut_dq_scores": [CUT_DQ,
                           ("for (int e = 0; e < 2; ++e) {\n        const int col",
                            "for (int e = 0; e < 0; ++e) {\n        const int col")],
    "attn.cut_dq_score_products": [
        CUT_DQ,
        ("wgmma_ss(s, desc_kb<SWB, 64>(sK, kk), desc_kb<SWB, 64>(qs, kk), kk);", "{}"),
        ("wgmma_ss(dp, desc_kb<SWB, 64>(sV, kk), desc_kb<SWB, 64>(dos, kk), kk);", "{}")],
    "attn.cut_dq_gradient_products": [
        CUT_DQ,
        ("for (int kc = 0; kc < 4; ++kc) wgmma_rs_n<D>(acc_v, fp[kc], desc_mnb<SWB, 64>(dos, kc));",
         ""),
        ("for (int kc = 0; kc < 4; ++kc) wgmma_rs_n<D>(acc_k, fs[kc], desc_mnb<SWB, 64>(qs, kc));",
         "")],
    "ssd.shipped": [],
    "ssd.cut_head_sum": [("  ssd_bwd_reduce<T><<<", "  if (Bt < 0) ssd_bwd_reduce<T><<<")],
    # the walk alone, without its per-head partials' stores, or without G's update
    "ssd.cut_head_sum_partials": [
        ("  ssd_bwd_reduce<T><<<", "  if (Bt < 0) ssd_bwd_reduce<T><<<"),
        ("<float2*>(dbp + poff", "<float2*>(T_len < 0 ? dbp : dbp + poff"),
        ("<float2*>(dcp + poff", "<float2*>(T_len < 0 ? dcp : dcp + poff")],
    "ssd.cut_head_sum_state_gradient": [
        ("  ssd_bwd_reduce<T><<<", "  if (Bt < 0) ssd_bwd_reduce<T><<<"),
        ("warp_mma<Q, PT, true, true, true>(Gr[mt], cs + n0 + 16 * mt, LB, Eh, El, LX);", "")],
}


def source(name: str) -> str:
    text = (ROOT / "src" / "repro_torch" / "csrc" / f"{SRC[name.split('.')[0]]}.cu").read_text()
    for old, new in VARIANTS[name]:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    return text


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
    the graph replayed and timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _time_ms(graph.replay, iters=5) / iters


def _stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def attention_calls(libs: dict) -> tuple[dict, dict]:
    """Checks of each attention variant and a closure a variant (and SDPA)
    at the training shape."""
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

    def run(fn, q, k, v, o, do, lse, causal=True, window=0, softcap=0.0, q_offset=0):
        BH, G, Tq, D = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dvec = torch.empty((BH, G, Tq), dtype=torch.float32, device="cuda")
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(),
                 BH, G, Tq, k.shape[1], D, v.shape[-1], 1, int(causal), window, softcap,
                 q_offset, 1.0 / D ** 0.5, fa.PATH_CODES["mma"], _stream())
        assert err == 0, err
        return dq, dk, dv

    def inputs(bh, g, tq, tk, kw):
        bf = torch.bfloat16
        q, do = _randn((bh, g, tq, 64), bf, 1), _randn((bh, g, tq, 64), bf, 4)
        k, v = _randn((bh, tk, 64), bf, 2), _randn((bh, tk, 64), bf, 3)
        o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
        return q, k, v, o, do, lse

    checks = {}
    for name, fn in libs.items():
        if "cut_" in name:
            continue
        for case, bh, g, tq, tk, window, softcap in (
                ("causal", 40, 3, 512, 512, 0, 0.0), ("window", 40, 3, 512, 512, 128, 0.0),
                ("softcap", 40, 3, 512, 512, 0, 30.0), ("q_offset", 40, 3, 256, 512, 0, 0.0),
                ("ragged", 4, 3, 77, 133, 0, 0.0)):
            kw = dict(causal=True, window=window, softcap=softcap, q_offset=tk - tq)
            args = inputs(bh, g, tq, tk, kw)
            want = flash_attention_bwd_ref(*args, **kw)
            got, again = run(fn, *args, **kw), run(fn, *args, **kw)
            over = max(((a.float() - b.float()).abs() - 2e-2 * (1 + b.float().abs()))
                       .max().item() for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            checks[f"{name}.{case}"] = dict(ok=over <= 0 and same, over_bar=over,
                                            same_bits=same)
    args = inputs(40, 3, 512, 512, {})
    calls = {name: (lambda fn=fn: run(fn, *args)) for name, fn in libs.items()}
    q, k, v, o, do, lse = args
    t = 512
    qs = q.reshape(8, 15, t, 64)
    ks = k.reshape(8, 5, t, 64).repeat_interleave(3, dim=1)
    vs = v.reshape(8, 5, t, 64).repeat_interleave(3, dim=1)
    dos = do.reshape(8, 15, t, 64)
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_flash_attention(qs, ks, vs, 0.0, True, False)
    out_f, lse_f, cq, ck, mq, mk, seed, offset = fwd[:8]
    calls["attn.sdpa_backward"] = lambda: aten._scaled_dot_product_flash_attention_backward(
        dos, qs, ks, vs, out_f, lse_f, cq, ck, mq, mk, 0.0, True, seed, offset)
    return checks, calls


def scan_calls(libs: dict) -> tuple[dict, dict]:
    """Checks of each scan variant and a closure a variant at the training
    shape."""
    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan.ops import ssd_plain_bwd

    def inputs(bt, t, h, p, g, n, seed):
        args = (_randn((bt, t, h, p), torch.bfloat16, seed, 0.5),
                F.softplus(_randn((bt, t, h), torch.float32, seed + 1)),
                -torch.exp(_randn((h,), torch.float32, seed + 2, 0.3)),
                _randn((bt, t, g, n), torch.bfloat16, seed + 3, 0.5),
                _randn((bt, t, g, n), torch.bfloat16, seed + 4, 0.5),
                1.0 + _randn((h,), torch.float32, seed + 5, 0.1))
        states = torch.empty(sk.chunk_states_shape(args[0], args[3]), device="cuda")
        sk.ssd_scan(*args, chunk_states=states)
        return (args, _randn((bt, t, h, p), torch.bfloat16, seed + 6, 0.5),
                _randn((bt, h, n, p), torch.float32, seed + 7, 0.5), states)

    def run(fn, args, dy, ds, states):
        x, dt, a, b, c, d = args
        Bt, T, H, P = x.shape
        G, N = b.shape[2], b.shape[3]
        f32 = dict(dtype=torch.float32, device="cuda")
        dx, db, dc, ddt = (torch.empty_like(t) for t in (x, b, c, dt))
        dap, ddp = torch.empty((Bt, H), **f32), torch.empty((Bt, H), **f32)
        dbp, dcp = torch.empty((Bt, T, H, N), **f32), torch.empty((Bt, T, H, N), **f32)
        ptrs = (x, dt, a, b, c, d, dy, ds, dx, ddt, dap, ddp, dbp, dcp, states, db, dc)
        err = fn(*(t.data_ptr() for t in ptrs), Bt, T, H, G, N, P, 1, sk.PATH_CODES["mma"],
                 _stream())
        assert err == 0, err
        return dx, ddt, dap.sum(0), db, dc, ddp.sum(0)

    checks = {}
    for name, fn in libs.items():
        if "cut_" in name:
            continue
        for case, *shape in (("train", 8, 512, 80, 64, 1, 128), ("groups", 2, 200, 80, 64, 8, 128),
                             ("n64", 1, 77, 6, 32, 3, 64)):
            args, dy, ds, states = inputs(*shape, seed=sum(shape))
            got, again = run(fn, args, dy, ds, states), run(fn, args, dy, ds, states)
            want = ssd_plain_bwd(*args, dy, ds)
            rel = max(((a.float() - b.float()).abs().max()
                       / b.float().abs().max().clamp_min(1e-4)).item() for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            checks[f"{name}.{case}"] = dict(ok=rel <= 2e-2 and same, rel_err=rel,
                                            same_bits=same)
            del states
    args, dy, ds, states = inputs(8, 512, 80, 64, 1, 128, seed=5)
    calls = {name: (lambda fn=fn: run(fn, args, dy, ds, states)) for name, fn in libs.items()}
    return checks, calls


def main(names: list[str]) -> int:
    if not torch.cuda.is_available():
        print("probe_gradients: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssd_scan import kernel as sk
    _build.build_all(("flash_attention", "ssd_scan", "ssd_scan_bwd"))
    names = names or list(VARIANTS)
    logs = build(names)
    libs = {}
    for name in names:
        if logs[name]["rc"]:
            print(name, "build failed:", logs[name]["ptxas"])
            continue
        fn = ctypes.CDLL(str(OUT / f"{name}.so"))
        fn = fn.flash_attention_bwd_launch if name.startswith("attn") else fn.ssd_scan_bwd_launch
        ref = fa._lib_bwd() if name.startswith("attn") else sk._lib_bwd()
        fn.argtypes, fn.restype = ref.argtypes, ref.restype
        libs[name] = fn
    checks, calls = {}, {}
    for kern, make in (("attn", attention_calls), ("ssd", scan_calls)):
        part = {n: f for n, f in libs.items() if n.startswith(kern)}
        if part:
            c, k = make(part)
            checks.update(c)
            calls.update(k)
    times = {n: [] for n in calls}
    for order in (list(calls), list(reversed(list(calls)))):
        for n in order:
            times[n].append(_graph_ms(calls[n]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    result = dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi, build=logs,
                  checks=checks, device_ms=times)
    RESULT.parent.mkdir(exist_ok=True)
    RESULT.write_text(json.dumps(result, indent=1))
    print(smi)
    for n, t in times.items():
        print(f"{n}: device ms {t}")
    bad = [n for n, c in checks.items() if not c["ok"]]
    print("checks failed:", bad or "none")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
