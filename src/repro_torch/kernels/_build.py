"""Build the CUDA sources in ``repro_torch/csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/repro_torch/lib<name>-<hash>.so`` at the repository root,
named by the hash of its source, the shared headers ``csrc/*.cuh`` and the
flags so an edited source or header rebuilds, then loaded with ``ctypes``. Nothing is built when a module is imported: the CPU
tests import every module on hosts with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG.parents[1] / "build" / "repro_torch"
KERNELS = ("tile_matmul", "flash_attention", "flash_attention_bwd", "ssd_scan",
           "ssd_scan_bwd")
# --split-compile=0 (nvcc's optimizer and ptxas): each source's kernels are
# optimized and assembled on all the host's cores at once. It halves the
# build's wall on an 8-core host and gives every kernel the same registers.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
              "--split-compile=0", "-Xptxas", "--split-compile=0"]
INCLUDE = ["-I", str(CSRC)]  # the shared headers, for a source copied elsewhere

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD / f"lib{name}-{digest[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for ``name`` unless its library is already built."""
    so = _target(name)
    if so.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    log = so.with_suffix(".log")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, log


def _finish(name: str, started) -> None:
    proc, tmp, log = started
    out, _ = proc.communicate()
    log.write_text(out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, _target(name))


def build_all(names=KERNELS) -> None:
    """Compile every kernel source at once, one nvcc process each."""
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, s in started.items():
            if s is not None:
                try:
                    _finish(n, s)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """What nvcc printed for ``name`` (ptxas registers, spills, shared
    memory), or '' when the library predates this process's build."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
