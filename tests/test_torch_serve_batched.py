"""The twin of ``examples/serve_batched.py`` (``examples/torch_serve_batched.py``)
against the reference example, on the CPU: the twin serves the reference
example's architectures with its settings, imports only ``repro_torch``,
and for each architecture the port's ``serve`` given the reference's
PRNGKey(0) weights picks the reference's greedy tokens."""

import ast
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest

from _torch_dense import both_params
from repro.configs.base import get_config as jax_get_config
from repro.launch.serve import serve as jax_serve
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import serve

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _twin():
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module("torch_serve_batched")


def _reference_example() -> tuple[list, dict]:
    """The architectures the reference example loops over and the keyword
    arguments of its ``serve(...)`` call, read from its source."""
    tree = ast.parse((EXAMPLES / "serve_batched.py").read_text())
    (loop,) = [n for n in ast.walk(tree) if isinstance(n, ast.For)]
    (call,) = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
               and getattr(n.func, "id", None) == "serve"]
    return ast.literal_eval(loop.iter), {kw.arg: ast.literal_eval(kw.value)
                                         for kw in call.keywords}


def test_the_twin_serves_the_reference_examples_architectures_and_settings():
    archs, kwargs = _reference_example()
    twin = _twin()
    assert list(twin.ARCHS) == archs
    assert twin.serve_config() == kwargs
    assert kwargs == dict(reduced=True, batch=4, prompt_len=32, gen=8, cache_len=64)


def test_the_twin_imports_only_the_port():
    tree = ast.parse((EXAMPLES / "torch_serve_batched.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "repro")], names
    assert "repro_torch.launch.serve" in names


@pytest.mark.parametrize("arch", ["smollm_360m", "mamba2_2_7b", "deepseek_v2_lite_16b",
                                  "musicgen_medium"])
def test_the_twins_serve_picks_the_reference_examples_tokens(arch):
    """The reference example's run of ``arch`` against the port's ``serve``
    with the same settings, given the weights the reference's ``serve``
    draws (PRNGKey(0)): the same tokens, (4, 8) or musicgen's (4, 8, 4)."""
    kw = _twin().serve_config(log=lambda _: None)
    ref = jax_serve(arch, **kw)
    _, params = both_params(jax_get_config(arch, True), get_config(arch, True))
    out = serve(arch, device="cpu", params=params, **kw)
    books = (4,) if arch == "musicgen_medium" else ()
    assert out["tokens"].shape == (4, 8) + books
    np.testing.assert_array_equal(out["tokens"], np.asarray(ref["tokens"]))


def test_the_twin_runs_every_architecture_on_the_cpu():
    lines = []
    out = _twin().run("cpu", log=lines.append)
    assert list(out) == list(_twin().ARCHS)
    assert out["musicgen_medium"]["tokens"].shape == (4, 8, 4)
    assert all(out[a]["tokens"].shape == (4, 8) for a in _twin().ARCHS[:3])
    assert sum("generated token matrix shape" in line for line in lines) == 4
