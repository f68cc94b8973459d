"""Boundaries of the PyTorch port: it imports neither JAX nor the reference
package, it never falls back to the CPU, and its configs are the
reference's field for field."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro_torch.configs.base import get_config

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import pkgutil, sys, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "print(len(list(pkgutil.walk_packages(repro_torch.__path__))), bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_source_file_of_the_port_imports_jax_or_the_reference():
    offenders = []
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [(path.name, n) for n in names
                          if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not offenders


def test_entry_points_raise_without_cuda_instead_of_falling_back(monkeypatch):
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve("smollm_360m", log=lambda _: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("reduced", [False, True])
def test_smollm_config_matches_reference_field_for_field(reduced):
    assert dataclasses.asdict(get_config("smollm_360m", reduced)) == \
        dataclasses.asdict(jax_get_config("smollm_360m", reduced))


@pytest.mark.parametrize("reduced", [False, True])
def test_mamba2_config_matches_reference_field_for_field(reduced):
    assert dataclasses.asdict(get_config("mamba2_2_7b", reduced)) == \
        dataclasses.asdict(jax_get_config("mamba2_2_7b", reduced))


def test_unported_architectures_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("qwen2_moe_a2_7b")


def test_tf32_is_off_after_import():
    import repro_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_train_raises_without_cuda_instead_of_falling_back(monkeypatch, tmp_path):
    from repro_torch.launch.train import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train("smollm_360m", ckpt_dir=str(tmp_path), log=lambda _: None)
    assert not any(tmp_path.iterdir())   # raised before it wrote a journal


def test_acan_runner_raises_without_cuda_unless_given_the_cpu(monkeypatch):
    from repro_torch.configs.base import get_config
    from repro_torch.ts_exec.step_runner import ACANStepRunner, ACANTrainConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("smollm_360m", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ACANStepRunner(cfg, ACANTrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        ACANStepRunner(cfg, ACANTrainConfig(steps=1), device="cuda")
    runner = ACANStepRunner(cfg, ACANTrainConfig(steps=1), device="cpu")
    assert runner.device == torch.device("cpu")


def test_the_import_scans_cover_the_training_modules():
    """The two scans above walk every module of the port, the training
    slice's, the ACAN runtime's and the paper experiments' among them."""
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    assert {"optim/optimizer.py", "data/pipeline.py", "core/gss.py",
            "distributed/watchdog.py", "checkpoint/checkpoint.py",
            "checkpoint/journal.py", "checkpoint/convert.py", "launch/train.py",
            "models/losses.py"} <= names
    assert {"core/tasks.py", "core/ledger.py", "core/conflict.py", "core/costmodel.py",
            "core/executor.py", "core/manager.py", "core/handler.py", "core/program.py",
            "core/space/__init__.py", "core/space/api.py", "core/space/local.py",
            "core/space/schema.py", "core/space/scoped.py", "core/space/checked.py",
            "core/space/instrumented.py", "core/space/sharded.py", "core/space/raced.py",
            "core/space/crashpoint.py", "core/space/facade.py", "programs/__init__.py",
            "programs/torch_sgd.py", "ts_exec/step_runner.py",
            "kernels/_count.py"} <= names
    assert {"core/faults.py", "core/cloud.py", "core/__init__.py", "programs/mlp.py",
            "configs/paper_mlp.py"} <= names


def test_the_example_twins_import_only_the_port():
    """The port's examples (``examples/torch_*.py``) import neither JAX nor
    the reference, as the port's modules do not."""
    examples = sorted((SRC.parent / "examples").glob("torch_*.py"))
    assert "torch_acan_mlp_train.py" in [p.name for p in examples]
    for path in examples:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names
                        if n.split(".")[0] in ("jax", "jaxlib", "repro", "_example_args")], \
                (path.name, names)


class _SlowInt(int):
    """An int whose ``+`` runs Python code, so that a thread switch can land
    between the read and the write of ``x += 1`` (with plain ints CPython
    rarely switches there, which hides a lost update)."""

    def __add__(self, other):
        return _SlowInt(int(self) + other)


def test_launch_counts_lose_nothing_under_thread_contention():
    """The wrappers' counters are raised from several handler threads at
    once: 16 threads (more than this host's cores) counting through
    ``_count.launch`` with a short switch interval lose no update. Unlocked,
    the same counting keeps about a quarter of them."""
    import threading
    import types

    from repro_torch.kernels import _count
    zero = _SlowInt(0)
    fn = types.SimpleNamespace(launches=zero, paths={"a": zero, "b": zero}, layouts={"x": zero})
    n_threads, n = 16, 2000

    def work(i):
        for _ in range(n):
            _count.launch(fn, paths="ab"[i % 2], layouts="x")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == n_threads * n == fn.layouts["x"]
    assert fn.paths == {"a": n_threads * n // 2, "b": n_threads * n // 2}
