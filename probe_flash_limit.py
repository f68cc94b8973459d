"""How far flash_attention's forward is from its plain version, measured
against the limit ``chip_smoke.py`` holds it to, and how far two planted
defects would be.

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

Usage::

    python3 probe_flash_limit.py [--out chiprun_out/probe_flash_limit.json]
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "probe_flash_limit.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_flash_limit: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build_all(("flash_attention",))
    out = {"nvidia_smi": smi, "cases": {}}
    for dtype in (torch.bfloat16, torch.float32):
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
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
