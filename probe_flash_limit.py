"""How far flash_attention's forward and backward are from their plain
versions, measured against the limits ``chip_smoke.py`` holds them to, and
how far planted defects would be.

For each case of ``chip_smoke.FLASH_CASES`` (the kernel launched whole, the
plain version in batch x kv-head slices where its scores would not fit), in
bf16 (mma path) and float32 (ffma path), prints:

- ``max_abs_err``;
- ``margin``: the largest |error| / ``chip_smoke._flash_limit`` (TOL (|plain|
  + min(1, rms of the plain row))), at most 1 for a pass;
- ``margin_flat``: the largest |error| / (atol + rtol |plain|) with rtol
  TOL and atol TOL / 20, a limit scaled to each element but not to its row;
- in bf16, the ``margin`` of two defects planted in the plain version on
  the first slice, against the plain version itself: ``edge`` (the key
  range one key short, at the window's edge or the causal one) and ``tile``
  (the values of 32 keys in the middle of the sequence lost).

Then the backward (``flash_attention_bwd`` from the kernel's own o and lse)
against the explicit formula, each gradient's:

- ``max_abs_err``;
- ``margin``: the largest |error| / ``chip_smoke._flash_bwd_limit`` (TOL
  (|plain| + max(rms of the plain row, rms of the whole)));
- ``margin_flat``: the largest |error| / (TOL + TOL |plain|), the
  ``assert_close(atol = rtol = TOL)`` limit it replaced;
- in bf16, on the first slice, ``planted``: (``margin``, ``margin_flat``)
  of defects planted in the formula, against the formula itself: ``tile`` (the scores
  of one 64 x 64 tile pair in the middle of the band masked out: the dQ
  kernel's rows lose one key tile, the dK/dV kernel's keys one row tile)
  and ``edge`` (the key range one key short, at the window's edge or the
  causal one).

Usage::

    python3 probe_flash_limit.py [--out chiprun_out/probe_flash_limit.json]
                                 [--parts fwd,bwd]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent


def _margins(got: torch.Tensor, ref: torch.Tensor, dtype, cs) -> dict:
    diff = (got - ref).abs()
    tol = cs.TOL[dtype]
    return dict(max_abs_err=diff.max().item(),
                margin=(diff / cs._flash_limit(ref, dtype)).max().item(),
                margin_flat=(diff / (tol / 20 + tol * ref.abs())).max().item())


def _grad_margins(got: torch.Tensor, ref: torch.Tensor, dtype, cs) -> dict:
    diff = (got - ref).abs()
    tol = cs.TOL[dtype]
    return dict(max_abs_err=diff.max().item(),
                margin=(diff / cs._flash_bwd_limit(ref, dtype)).max().item(),
                margin_flat=(diff / (tol + tol * ref.abs())).max().item())


def _tile_pair(g: int, tq: int, tkv: int, window: int, q_offset: int) -> tuple[int, int]:
    """Folded row and key of a 64 x 64 tile pair in the middle of the band:
    the middle row tile, and the key tile in the middle of what its first
    query sees (folded row ``rr = t * G + g``)."""
    r0 = (g * tq // 2) // 64 * 64
    t = q_offset + r0 // g
    seen = min(window, t + 1) if window > 0 else t + 1
    return r0, (t - seen // 2) // 64 * 64


def _planted_bwd(ref_mod, drop, *args, **kw):
    """The explicit backward with the scores where ``drop`` is true masked
    out, from the given lse: the gradient of kernels that skip them."""
    scores = ref_mod._scores

    def dropped(*a, **k):
        s, cap, mask = scores(*a, **k)
        return torch.where(drop, ref_mod.NEG_INF, s), cap, mask

    ref_mod._scores = dropped
    try:
        return ref_mod.flash_attention_bwd_ref(*args, **kw)
    finally:
        ref_mod._scores = scores


def probe_bwd(cs, fa, ref_mod) -> dict:
    """Each ``FLASH_CASES`` case's backward margins (module docstring)."""
    cases = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, bh, g, tq, tkv, d, window, softcap in cs.FLASH_CASES:
            q = cs._randn((bh, g, tq, d), dtype, 1)
            k = cs._randn((bh, tkv, d), dtype, 2)
            v = cs._randn((bh, tkv, d), dtype, 3)
            do = cs._randn((bh, g, tq, d), dtype, 4)
            kw = dict(causal=True, window=window, softcap=softcap, q_offset=tkv - tq)
            o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
            grads = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
            step = max(1, cs._plain_step(bh, g, tq, tkv) // cs.PLAIN_BWD_SCORES)
            rec = {gn: dict(max_abs_err=0.0, margin=0.0, margin_flat=0.0)
                   for gn in ("dq", "dk", "dv")}
            for i in range(0, bh, step):
                sl = slice(i, i + step)
                args = (q[sl], k[sl], v[sl], o[sl], do[sl], lse[sl])
                refs = [r.float() for r in ref_mod.flash_attention_bwd_ref(*args, **kw)]
                for gn, got, ref in zip(("dq", "dk", "dv"), grads, refs):
                    m = _grad_margins(got[sl].float(), ref, dtype, cs)
                    rec[gn] = {key: max(rec[gn][key], m[key]) for key in m}
                if i == 0 and dtype == torch.bfloat16:
                    r0, c0 = _tile_pair(g, tq, tkv, window, kw["q_offset"])
                    rr = (torch.arange(tq, device=q.device)[None, :] * g
                          + torch.arange(g, device=q.device)[:, None])
                    kv = torch.arange(tkv, device=q.device)
                    drop = (((rr >= r0) & (rr < r0 + 64))[:, :, None]
                            & ((kv >= c0) & (kv < c0 + 64))[None, None, :])
                    edge = (dict(kw, window=window - 1) if window > 1
                            else dict(kw, q_offset=kw["q_offset"] - 1))
                    rec["planted"] = {"tile_pair": (r0, c0)}
                    for defect, planted in (
                            ("tile", _planted_bwd(ref_mod, drop[None], *args, **kw)),
                            ("edge", ref_mod.flash_attention_bwd_ref(*args, **edge))):
                        for gn, bad, ref in zip(("dq", "dk", "dv"), planted, refs):
                            m = _grad_margins(bad.float(), ref, dtype, cs)
                            rec["planted"][f"{defect} {gn}"] = (m["margin"], m["margin_flat"])
                del refs
            cases[f"{name} {dtype}"] = rec
            print(f"bwd {name} {dtype}: {json.dumps(rec)}", flush=True)
            del q, k, v, do, o, lse, grads
            torch.cuda.empty_cache()
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "probe_flash_limit.json"))
    ap.add_argument("--parts", default="fwd,bwd")
    args = ap.parse_args()
    parts = args.parts.split(",")
    if not torch.cuda.is_available():
        print("probe_flash_limit: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention import ref as ref_mod
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build_all(("flash_attention", "flash_attention_bwd"))
    out = {"nvidia_smi": smi, "cases": {}}
    for dtype in (torch.bfloat16, torch.float32) if "fwd" in parts else ():
        for name, bh, g, tq, tkv, d, window, softcap in cs.FLASH_CASES:
            q = cs._randn((bh, g, tq, d), dtype, 1)
            k = cs._randn((bh, tkv, d), dtype, 2)
            v = cs._randn((bh, tkv, d), dtype, 3)
            kw = dict(causal=True, window=window, softcap=softcap, q_offset=tkv - tq)
            got = fa.flash_attention(q, k, v, **kw)
            step = cs._plain_step(bh, g, tq, tkv)
            rec = dict(max_abs_err=0.0, margin=0.0, margin_flat=0.0)
            for i in range(0, bh, step):
                sl = slice(i, i + step)
                ref = flash_attention_ref(q[sl], k[sl], v[sl], **kw).float()
                m = _margins(got[sl].float(), ref, dtype, cs)
                rec |= {key: max(rec[key], m[key]) for key in m}
                if i == 0 and dtype == torch.bfloat16:
                    edge = (dict(kw, window=window - 1) if window > 1
                            else dict(kw, q_offset=kw["q_offset"] - 1))
                    lost = v[sl].clone()
                    lost[:, tkv // 2 - 16:tkv // 2 + 16] = 0
                    for defect, plain in (
                            ("edge", flash_attention_ref(q[sl], k[sl], v[sl], **edge)),
                            ("tile", flash_attention_ref(q[sl], k[sl], lost, **kw))):
                        rec[f"{defect}_margin"] = _margins(plain.float(), ref, dtype,
                                                           cs)["margin"]
                del ref
            out["cases"][f"{name} {dtype}"] = rec
            print(f"{name} {dtype}: {json.dumps(rec)}", flush=True)
            del q, k, v, got
            torch.cuda.empty_cache()
    if "bwd" in parts:
        out["bwd_cases"] = probe_bwd(cs, fa, ref_mod)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
