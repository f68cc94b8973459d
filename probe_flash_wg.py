#!/usr/bin/env python3
"""Design probe for the wgmma attention kernels at head dims 80 and 128 on
one NVIDIA GPU: ``flash_fwd_wg<D, D>`` in ``csrc/flash_attention.cu``, and in
``csrc/flash_attention_bwd.cu`` the D 80 and 128 instances of
``flash_bwd_{dq,dkv}_wgmma`` (and at D 128 the role-split
``flash_bwd_dkv_wgsplit<128>`` as a variant).

Builds each source and named variants of it, each a text patch listed in
``VARIANTS`` (one ``nvcc`` each, all started together), and, where
``--parent DIR`` names a directory holding an older tree's
``flash_attention.cu``, ``flash_attention_bwd.cu`` and ``hopper.cuh``,
those sources too (variants ``fwd.parent`` and ``bwd.parent``). Reports
each kernel's registers, spills and whether ptxas serialized its wgmmas
(its C7514 note). Holds every variant against the plain PyTorch version
(bf16, ``chip_smoke.py``'s per-element limits) at edge cases and for
repeat launches giving the same bits, then times each by CUDA-graph replay
at ``chip_smoke.py``'s shapes: h2o_danube_1_8b's and command_r_plus_104b's
prefill attention, danube's attention backward, smollm_360m's (D 64,
whose kernels share the D 80 source), qwen2_moe_a2_7b's (D 128, G 1) and
deepseek_v2_lite_16b's (q/k 192, v 128: the ``<192>`` kernels) and
gemma3_12b's global and local layers (D 256: its dQ kernel and the role
split ``flash_bwd_dkv_wgsplit<256>``), twice, in
turns: variants in order, then in reverse. Results go to
``chiprun_out/probe_flash_wg.json``.

Usage (from the repository root, on a host with a CUDA device)::

    python3 probe_flash_wg.py [--parent DIR] [variant ...]   # default: every variant
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
OUT = ROOT / "build" / "probe_flash_wg"
RESULT = ROOT / "chiprun_out" / "probe_flash_wg.json"
SRC = {"fwd": "flash_attention", "bwd": "flash_attention_bwd"}
FWD80 = "struct FwdWg<80, 80> { static constexpr int NC = 3, SWB = 32; };"
FWD128 = "struct FwdWg<128, 128> { static constexpr int NC = 2, SWB = 128; };"
BWD80 = "static constexpr int SWB = 32, DQ_BLOCKS = 3, DQ_STAGES = 2, DKV_WGS = 2;"
BWD128 = "static constexpr int SWB = 128, DQ_BLOCKS = 3, DQ_STAGES = 1, DKV_WGS = 1;"
BWD192 = "static constexpr int SWB = 128, DQ_BLOCKS = 2, DQ_STAGES = 1, DKV_WGS = 1;"
SPLIT192 = "template <> struct BwdSplit<192> { static constexpr int STAGES = 3; };"
SPLIT256 = "template <> struct BwdSplit<256> { static constexpr int STAGES = 2; };"


def split_dkv(stages: int) -> list:
    """D 128's dK/dV as D 256's role split (one warpgroup forms P^T and owns
    dV, the other dS^T and dK) with a Q/dO ring of ``stages``, instead of
    one warpgroup owning both."""
    return [("constexpr int DKV_SPLIT_D = 192;", "constexpr int DKV_SPLIT_D = 128;"),
            (SPLIT256, SPLIT256.replace("256> { static constexpr int STAGES = 2",
                                        f"128> {{ static constexpr int STAGES = {stages}")
             + "\n" + SPLIT256)]


# "<fwd|bwd>.<name>" -> (old, new) text patches of the source.
VARIANTS = {
    "fwd.shipped": [],
    "fwd.d80_nc2": [(FWD80, FWD80.replace("NC = 3", "NC = 2"))],
    # three consumers at D 128: they spill at their 160 registers
    "fwd.d128_nc3": [(FWD128, FWD128.replace("NC = 2", "NC = 3"))],
    # D 128 on 32-byte boxes, as D 80: what the narrow swizzle costs
    "fwd.d128_sw32": [(FWD128, FWD128.replace("SWB = 128", "SWB = 32"))],
    "bwd.shipped": [],
    # three dK/dV warpgroups, as at D 64: they spill at their 168 registers
    "bwd.dkv3": [(BWD80, BWD80.replace("DKV_WGS = 2", "DKV_WGS = 3"))],
    # a third Q/dO buffer a dK/dV warpgroup (D 64 and 80)
    "bwd.dkv_stages3": [("constexpr int DKV_STAGES = 2;", "constexpr int DKV_STAGES = 3;")],
    # D 128's dK/dV as the role split, with a three-stage Q/dO ring (147 KB)
    # and with two, as at D 256: 158 registers, but one block an SM
    "bwd.d128_split": split_dkv(3),
    "bwd.d128_split_stages2": split_dkv(2),
    # two dK/dV warpgroups a block walking alternate row tiles, one block an SM
    "bwd.d128_two_wgs": [(BWD128, BWD128.replace("DKV_WGS = 1", "DKV_WGS = 2"))],
    # two dQ blocks an SM on two K/V stages (97 KB), as at D 64 and 80
    "bwd.d128_dq2": [(BWD128, BWD128.replace("DQ_BLOCKS = 3, DQ_STAGES = 1",
                                             "DQ_BLOCKS = 2, DQ_STAGES = 2"))],
    # MLA's (192, 128): two Q/dO stages of the role-split dK/dV kernel (139
    # KB) where it ships three (180 KB), and one dQ block an SM on two K/V
    # stages (121 KB)
    "bwd.mla_split_stages2": [(SPLIT192, SPLIT192.replace("STAGES = 3", "STAGES = 2"))],
    "bwd.mla_dq1_stages2": [(BWD192, BWD192.replace("DQ_BLOCKS = 2, DQ_STAGES = 1",
                                                    "DQ_BLOCKS = 1, DQ_STAGES = 2"))],
}

FWD_CASES = (  # (bh, g, tq, tk, d, causal, window, softcap)
    (4, 4, 600, 600, 80, True, 256, 0.0), (8, 2, 1000, 1000, 80, True, 0, 0.0),
    (4, 12, 777, 1200, 80, True, 256, 0.0), (3, 2, 70, 70, 80, True, 0, 20.0),
    (3, 2, 1, 1, 80, True, 0, 0.0), (1, 4, 20, 50, 80, True, 8, 30.0),
    (2, 2, 10, 33, 80, False, 0, 0.0), (2, 1, 129, 129, 80, True, 0, 0.0),
    (8, 12, 512, 512, 128, True, 0, 0.0), (4, 1, 300, 300, 128, True, 100, 30.0),
    (2, 12, 50, 90, 128, True, 30, 0.0), (3, 2, 1, 1, 128, True, 0, 0.0),
    (2, 4, 70, 150, 128, False, 0, 0.0), (1, 4, 20, 50, 128, True, 8, 30.0))
BWD_CASES = (
    (2, 4, 600, 600, 80, True, 256, 0.0), (3, 2, 70, 70, 80, True, 0, 20.0),
    (2, 12, 90, 190, 80, True, 70, 0.0), (2, 1, 65, 65, 80, False, 0, 0.0),
    (2, 3, 64, 640, 80, True, 0, 0.0), (1, 5, 100, 100, 80, True, 0, 15.0),
    (40, 3, 512, 512, 64, True, 0, 0.0), (4, 3, 77, 133, 64, True, 0, 0.0),
    (8, 1, 300, 300, 128, True, 0, 0.0), (2, 4, 200, 333, 128, True, 150, 30.0),
    (2, 1, 65, 65, 128, False, 0, 0.0), (3, 12, 90, 190, 128, True, 70, 0.0),
    (8, 1, 300, 300, (192, 128), True, 0, 0.0), (2, 4, 200, 333, (192, 128), True, 150, 30.0),
    (2, 1, 65, 65, (192, 128), False, 0, 0.0), (4, 2, 300, 300, 256, True, 0, 0.0),
    (2, 2, 200, 333, 256, True, 150, 30.0), (2, 1, 65, 65, 256, False, 0, 0.0))
# (name, b, hkv, g, t, d, window): chip_smoke.py's FLASH_TIMED / FLASH_BWD_TIMED
FWD_TIMED = (("h2o_danube_1_8b", 2, 8, 4, 8192, 80, 4096),
             ("command_r_plus_104b", 8, 8, 12, 512, 128, 0))
BWD_TIMED = (("h2o_danube_1_8b", 2, 8, 4, 8192, 80, 4096), ("smollm_360m", 8, 5, 3, 512, 64, 0),
             ("qwen2_moe_a2_7b", 8, 16, 1, 1024, 128, 0),
             ("gemma3_12b global", 2, 8, 2, 2048, 256, 0),
             ("gemma3_12b local", 2, 8, 2, 2048, 256, 1024),
             ("deepseek_v2_lite_16b", 8, 16, 1, 1024, (192, 128), 0))


def source(name: str, parent: Path | None) -> tuple[str, Path | None]:
    """A variant's source text, and the header it must be built beside."""
    src = SRC[name.split(".")[0]]
    if name.endswith(".parent"):
        return (parent / f"{src}.cu").read_text(), parent / "hopper.cuh"
    text = (ROOT / "src" / "repro_torch" / "csrc" / f"{src}.cu").read_text()
    for old, new in VARIANTS[name]:
        assert text.count(old) == 1, (name, old)
        text = text.replace(old, new)
    return text, None


def build(names: list[str], parent: Path | None) -> dict:
    import chip_smoke
    from repro_torch.kernels import _build
    procs = {}
    for name in names:
        text, header = source(name, parent)
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "src.cu").write_text(text)
        if header is not None:  # "hopper.cuh" resolves beside the source first
            shutil.copy(header, d / "hopper.cuh")
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, *_build.INCLUDE, "-o", str(d / "lib.so"),
             str(d / "src.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in procs.items():
        out = p.communicate()[0]
        kernels = {k: v for k, v in chip_smoke._ptxas_kernels(out).items()
                   if "_wg" in k or "_mmaI" in k}
        if p.returncode == 0:  # each kernel's wgmma, calls and local-memory traffic
            sass = chip_smoke._sass_ops(chip_smoke.sass_start(OUT / name / "lib.so"),
                                        ("HGMMA", "CALL", "LDL", "STL"))[1]
            for k in kernels:
                kernels[k]["sass_ops"] = sass.get(k)
        logs[name] = {"rc": p.returncode, "kernels": kernels,
                      "errors": [l for l in out.splitlines() if "error" in l][:20]}
    return logs


def _stream() -> int:
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _randn(shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)


def fwd_call(fn):
    def run(q, k, v, causal=True, window=0, softcap=0.0, q_offset=0):
        BH, G, Tq, D = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((BH, G, Tq), dtype=torch.float32, device="cuda")
        # a source with q/k and v head dims apart takes both (one int more)
        dims = (D, D) if len(fn.argtypes) > 18 else (D,)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), BH, G,
                 Tq, k.shape[1], *dims, 1, int(causal), window, softcap, q_offset,
                 1.0 / D ** 0.5, 0, _stream())
        assert err == 0, err
        return o, lse
    return run


def bwd_call(fn):
    def run(q, k, v, o, do, lse, causal=True, window=0, softcap=0.0, q_offset=0):
        BH, G, Tq, D = q.shape
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        dvec = torch.empty((BH, G, Tq), dtype=torch.float32, device="cuda")
        dims = (D, v.shape[-1]) if len(fn.argtypes) > 23 else (D,)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dvec.data_ptr(),
                 BH, G, Tq, k.shape[1], *dims, 1, int(causal), window, softcap, q_offset,
                 1.0 / D ** 0.5, 0, _stream())
        assert err == 0, err
        return dq, dk, dv
    return run


def check(name: str, run) -> dict:
    """Worst |error| / limit of each case (at most 1 passes) and same bits."""
    import chip_smoke
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                         flash_attention_ref)
    out = {}
    fwd = name.startswith("fwd")
    for bh, g, tq, tk, d, causal, window, softcap in (FWD_CASES if fwd else BWD_CASES):
        dk, dv = d if isinstance(d, tuple) else (d, d)  # MLA's pair: q/k and v head dims
        q, k, v, do = (_randn((bh, g, tq, dk), 1), _randn((bh, tk, dk), 2),
                       _randn((bh, tk, dv), 3), _randn((bh, g, tq, dv), 4))
        kw = dict(causal=causal, window=window, softcap=softcap, q_offset=tk - tq)
        case = f"{bh}x{g}x{tq}x{tk} d{d} w{window} c{softcap} {'causal' if causal else 'full'}"
        if fwd:
            (o, lse), (o2, _) = run(q, k, v, **kw), run(q, k, v, **kw)
            ref, ref_lse = flash_attention_ref(q, k, v, return_lse=True, **kw)
            margin = ((o.float() - ref.float()).abs()
                      / chip_smoke._flash_limit(ref.float(), torch.bfloat16)).max().item()
            lse_err = (lse - ref_lse).abs().max().item()
            out[case] = dict(margin=margin, lse_err=lse_err, same_bits=torch.equal(o, o2),
                             ok=margin <= 1 and lse_err <= 2e-4 and torch.equal(o, o2))
        else:
            o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            got, again = run(q, k, v, o, do, lse, **kw), run(q, k, v, o, do, lse, **kw)
            want = flash_attention_bwd_ref(q, k, v, o, do, lse, **kw)
            margin = max(((a.float() - b.float()).abs()
                          / chip_smoke._flash_bwd_limit(b.float(), torch.bfloat16)).max().item()
                         for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            out[case] = dict(margin=margin, same_bits=same, ok=margin <= 1 and same)
    return out


def timed_calls(libs: dict) -> dict:
    """{shape: {variant: closure}} at the timed shapes."""
    from repro_torch.kernels.flash_attention import kernel as fa
    calls = {}
    for shape, b, hkv, g, t, d, window in FWD_TIMED:
        bh = b * hkv
        q, k, v = _randn((bh, g, t, d), 1), _randn((bh, t, d), 2), _randn((bh, t, d), 3)
        calls[f"fwd {shape}"] = {
            n: (lambda r=fwd_call(fn), q=q, k=k, v=v, w=window: r(q, k, v, window=w))
            for n, fn in libs.items() if n.startswith("fwd")}
    for shape, b, hkv, g, t, d, window in BWD_TIMED:
        bh, (dk, dv) = b * hkv, (d if isinstance(d, tuple) else (d, d))
        q, k, v, do = (_randn((bh, g, t, dk), 1), _randn((bh, t, dk), 2),
                       _randn((bh, t, dv), 3), _randn((bh, g, t, dv), 4))
        o, lse = fa.flash_attention(q, k, v, return_lse=True, window=window)
        calls[f"bwd {shape}"] = {
            n: (lambda r=bwd_call(fn), a=(q, k, v, o, do, lse), w=window: r(*a, window=w))
            for n, fn in libs.items() if n.startswith("bwd")}
    return calls


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("probe_flash_wg: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    parent = None
    if argv[:1] == ["--parent"]:
        parent, argv = Path(argv[1]).resolve(), argv[2:]
    names = argv or list(VARIANTS) + (["fwd.parent", "bwd.parent"] if parent else [])
    _build.build_all(("flash_attention",))
    logs = build(names, parent)
    libs = {}
    for name in names:
        if logs[name]["rc"]:
            print(name, "build failed:", logs[name]["errors"], flush=True)
            continue
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        fwd = name.startswith("fwd")
        fn = lib.flash_attention_launch if fwd else lib.flash_attention_bwd_launch
        # as kernel.py's _lib and _lib_bwd bind them; an older tree's forward
        # and backward take one head dim
        src = (OUT / name / "src.cu").read_text()
        pair = ("int DK, int DV" if fwd else "int D, int Dv") in src
        fn.argtypes = ([ctypes.c_void_p] * (5 if fwd else 10) + [ctypes.c_int] * (6 + pair)
                       + list(fa._MASK) + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
        for k, v in logs[name]["kernels"].items():
            print(name, k[-60:], v, flush=True)
    checks = {}
    for name, fn in libs.items():
        checks[name] = check(name, (fwd_call if name.startswith("fwd") else bwd_call)(fn))
        print(name, "checks:", {c: round(r["margin"], 3) for c, r in checks[name].items()},
              "all ok" if all(r["ok"] for r in checks[name].values()) else "FAILED", flush=True)
    times = {}
    for shape, calls in timed_calls(libs).items():
        times[shape] = {n: [] for n in calls}
        for order in (list(calls), list(reversed(list(calls)))):
            for n in order:
                times[shape][n].append(chip_smoke._graph_ms(calls[n], iters=10))
        for n, t in times[shape].items():
            print(f"{shape} {n}: device ms {t}", flush=True)
        if shape.startswith("bwd"):  # each kernel's device time a launch, by trace
            times[shape + " traced"] = {
                n: chip_smoke._traced_ms(f, ("flash_bwd_dq", "flash_bwd_dkv"), iters=3)
                for n, f in calls.items()}
            print(shape, "traced:", times[shape + " traced"], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    RESULT.parent.mkdir(exist_ok=True)
    RESULT.write_text(json.dumps(dict(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                                      build=logs, checks=checks, device_ms=times), indent=1))
    print(smi)
    bad = [n for n, c in checks.items() if not all(r["ok"] for r in c.values())]
    print("checks failed:", bad or "none")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
