#!/usr/bin/env python3
"""Design probe for the chunk states of the CUDA ssd_scan backward on one
NVIDIA GPU: written by the forward, or rebuilt by the backward.

The shipped design has the forward (``csrc/ssd_scan.cu``) write the state
entering each chunk when asked, and ``csrc/ssd_scan_bwd.cu`` read them. The
other way is built here as a text patch of ``ssd_scan_bwd.cu``: each block
first walks its sequence forward once more, computing only
``S <- exp(cum_Q) S + (B o eout dt)^T X``, and writes the states itself
into a scratch of the same shape. Both backward kernels are held against
the plain adjoint (bf16: 2e-2 of each gradient's largest entry) and timed
at mamba2_2_7b's training shape (x (8, 512, 80, 64), N 128, bf16, ``mma``
path, with a final-state gradient), in turns, by CUDA events around 20
calls (``ms``) and by CUDA-graph replay (``device_ms``); so is the forward
with and without writing the states. Results go to
``chiprun_out/probe_ssd_states.json``.

Usage (from the repository root, on a host with a CUDA device)::

    python3 probe_ssd_states.py
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
OUT = ROOT / "build" / "probe_ssd_states"
RESULT = ROOT / "chiprun_out" / "probe_ssd_states.json"
SHAPES = {"train": (8, 512, 80, 64, 1, 128), "ragged": (2, 200, 80, 64, 8, 128)}
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")

# (old, new) text patches of csrc/ssd_scan_bwd.cu: the backward rebuilds
# the chunk states before its walk instead of reading them.
REBUILD = [
    ("  auto load = [&](int t0) {", "  auto load = [&](int t0, bool grads = true) {"),
    ("      Ys[r * LX + c] = in ?", "      if (grads) Ys[r * LX + c] = in ?"),
    ("      Cs[r * LB + c] = in ?", "      if (grads) Cs[r * LB + c] = in ?"),
    ("  const float* st = states +", "  float* st = const_cast<float*>(states) +"),
    ("""  {
    const float* fin = st + (size_t)nc * N * P;
    for (int i = tid; i < N * P; i += THREADS) Ss[(i / P) * LP + i % P] = fin[i];
  }
""", """  for (int i = tid; i < N * P; i += THREADS) {
    Ss[(i / P) * LP + i % P] = 0.f;
    st[i] = 0.f;
  }
  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // the previous chunk's update has read X and B
    load(c * Q, false);
    __syncthreads();
    scan();
    __syncthreads();
    const float decay = expf(cum[Q - 1]);
    float* out = st + (size_t)(c + 1) * N * P;
    product<MMA, true, false, false, false>(
        N, P, Q, [&](int n, int k) { return to_f(Bs[k * LB + n]) * eout[k] * dts[k]; },
        [&](int k, int p) { return to_f(Xs[k * LX + p]); }, 0, none, none,
        [&](int n, int p, float v, float) {
          const float s = decay * Ss[n * LP + p] + v;
          Ss[n * LP + p] = s;
          out[(size_t)n * P + p] = s;
        });
  }
"""),
]


def build_rebuild() -> ctypes._CFuncPtr:
    from repro_torch.kernels import _build
    text = (ROOT / "src" / "repro_torch" / "csrc" / "ssd_scan_bwd.cu").read_text()
    for old, new in REBUILD:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / "rebuild.cu", OUT / "rebuild.so"
    cu.write_text(text)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).ssd_scan_bwd_launch
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _randn(shape, dtype, seed, scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(dtype)


def inputs(bt, t, h, p, g, n, seed):
    """The scan's inputs in bf16, its output gradient and a float32
    final-state gradient."""
    args = (_randn((bt, t, h, p), torch.bfloat16, seed, 0.5),
            F.softplus(_randn((bt, t, h), torch.float32, seed + 1)),
            -torch.exp(_randn((h,), torch.float32, seed + 2, 0.3)),
            _randn((bt, t, g, n), torch.bfloat16, seed + 3, 0.5),
            _randn((bt, t, g, n), torch.bfloat16, seed + 4, 0.5),
            1.0 + _randn((h,), torch.float32, seed + 5, 0.1))
    return (args, _randn((bt, t, h, p), torch.bfloat16, seed + 6, 0.5),
            _randn((bt, h, n, p), torch.float32, seed + 7, 0.5))


def rebuilt_bwd(fn, x, dt, a, b, c, d, dy, ds, scratch):
    """The rebuild variant, launched as ``kernel.ssd_scan_bwd`` launches the
    shipped kernel; ``scratch`` receives the chunk states it rebuilds."""
    from repro_torch.kernels.ssd_scan import kernel as K
    Bt, T, H, P = x.shape
    G, N = b.shape[2], b.shape[3]
    f32 = dict(dtype=torch.float32, device="cuda")
    dx, db, dc, ddt = (torch.empty_like(t) for t in (x, b, c, dt))
    da, dd = torch.empty((Bt, H), **f32), torch.empty((Bt, H), **f32)
    dbp, dcp = torch.empty((Bt, T, H, N), **f32), torch.empty((Bt, T, H, N), **f32)
    ptrs = (x, dt, a, b, c, d, dy, ds, dx, ddt, da, dd, dbp, dcp, scratch, db, dc)
    err = fn(*(t.data_ptr() for t in ptrs), Bt, T, H, G, N, P, K.DTYPE_CODES[x.dtype],
             K.PATH_CODES["mma"], torch._C._cuda_getCurrentRawStream(0))
    assert err == 0, err
    return dx, ddt, da.sum(0), db, dc, dd.sum(0)


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
    """Device time of one call: ``iters`` calls replayed from a CUDA graph."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return _time_ms(graph.replay, iters=5) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_ssd_states: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ops import ssd_plain_bwd
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    rebuild = build_rebuild()
    result = {"device": smi, "err": {}}
    for name, shape in SHAPES.items():
        args, dy, ds = inputs(*shape, seed=sum(shape))
        states = torch.empty(K.chunk_states_shape(args[0], args[3]), device="cuda")
        scratch = torch.empty_like(states)
        K.ssd_scan(*args, chunk_states=states)
        want = ssd_plain_bwd(*args, dy, ds)
        got = {"read": K.ssd_scan_bwd(*args, dy, ds, states),
               "rebuilt": rebuilt_bwd(rebuild, *args, dy, ds, scratch)}
        err = result["err"][name] = {"states_max_abs": (scratch - states).abs().max().item()}
        for way, grads in got.items():
            err[way] = {g: ((a.float() - b.float()).abs().max()
                            / b.float().abs().max()).item()
                        for g, a, b in zip(GRADS, grads, want)}
            assert max(err[way].values()) <= 2e-2, (name, way, err[way])
        del want, got
    args, dy, ds = inputs(*SHAPES["train"], seed=5)
    states = torch.empty(K.chunk_states_shape(args[0], args[3]), device="cuda")
    scratch = torch.empty_like(states)
    fwd = {"without": lambda: K.ssd_scan(*args),
           "writing": lambda: K.ssd_scan(*args, chunk_states=states)}
    bwd = {"read": lambda: K.ssd_scan_bwd(*args, dy, ds, states),
           "rebuilt": lambda: rebuilt_bwd(rebuild, *args, dy, ds, scratch)}
    for part, fns in (("forward", fwd), ("backward", bwd)):
        a, b = fns
        order = (a, b, b, a)
        turns = [_time_ms(fns[k]) for k in order]
        graphs = [_graph_ms(fns[k]) for k in order]
        result[part] = {a: {"ms": (turns[0] + turns[3]) / 2,
                            "device_ms": (graphs[0] + graphs[3]) / 2},
                        b: {"ms": (turns[1] + turns[2]) / 2,
                            "device_ms": (graphs[1] + graphs[2]) / 2},
                        "turns_ms": turns, "graph_turns_ms": graphs}
    print(json.dumps(result))
    RESULT.parent.mkdir(exist_ok=True)
    RESULT.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
