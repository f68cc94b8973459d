"""Carry weights and optimizer state across from the reference package
without JAX.

The reference writes ``params.npz`` + ``manifest.json``
(``repro/checkpoint/checkpoint.py``): one array per leaf, keyed by its tree
path (``embed/tok``, ``final_ln``, ``period/0/attn/wq``, …), period leaves
stacked on a leading ``n_periods`` axis, and bfloat16 leaves stored as a
``uint16`` view with the dtype named in the manifest.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.common import ParamSpec


def load_params_npz(ckpt_dir: str) -> dict:
    """Flat ``{path: array}`` of the checkpoint's params. bfloat16 leaves
    come back as bfloat16 CPU tensors, the rest as numpy arrays."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        dtypes = json.load(f)["arrays"]
    out = {}
    with np.load(os.path.join(ckpt_dir, "params.npz")) as data:
        for key in data.files:
            a = data[key]
            if dtypes[f"params/{key}"] == "bfloat16":
                a = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
            out[key] = a
    return out


def _paths(tree, prefix: str = ""):
    """(path, spec) for every leaf of a spec tree, reference path naming."""
    if isinstance(tree, ParamSpec):
        yield prefix, tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        yield from _paths(v, f"{prefix}/{k}" if prefix else str(k))


def _insert(tree: dict, path: str, value) -> None:
    *head, last = path.split("/")
    node = tree
    for part in head:
        node = node.setdefault(part, {})
    node[last] = value


def _tuples(tree):
    """Dicts keyed "0".."n-1" (tuple nodes of the reference) → tuples."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _tuples(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return tuple(out[str(i)] for i in range(len(out)))
    return out


def _tree(cfg: M.ModelConfig, leaf) -> dict:
    """The port's tree for ``cfg``'s parameters, ``leaf(path, spec)`` at each
    leaf, the ``n_periods`` axis unstacked into per-layer entries. Nodes
    with no leaf, which paths alone never name, are put back as the spec
    tree has them: an empty ``prefix`` and the ``embeds`` frontend's empty
    ``embed``."""
    tree: dict = {}
    for path, spec in _paths(M.param_specs(cfg)):
        _insert(tree, path, leaf(path, spec))
    tree = {"embed": {}, "prefix": ()} | _tuples(tree)
    return M.unstack_periods(tree, cfg.n_periods)


def _tensor(flat: dict, key: str, device, dtype=None) -> torch.Tensor:
    if key not in flat:
        raise KeyError(f"checkpoint has no leaf {key!r}")
    t = flat[key]
    if not isinstance(t, torch.Tensor):
        t = torch.from_numpy(np.array(t))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(flat: dict, cfg: M.ModelConfig, device, dtype=None) -> dict:
    """Build this package's params from a flat reference-keyed dict.
    Shapes are checked against the config (the ``codebooks`` frontend's
    (K·V, d) table and (d, K·V) head among them); ``dtype`` (optional) casts every
    leaf but a MoE layer's router, which stays float32 whatever the model's
    dtype, as the reference keeps it; the ``n_periods`` axis is unstacked
    into per-layer tensors. A ``prefix`` layer's leaves (``prefix/0/...``)
    come across as they are; a period leaf loses only its leading axis, so
    MLA's up-projections ``w_uk`` / ``w_uv`` keep their (R, H, D) shape, as a
    MoE layer's expert tensors keep (E, d, f)."""

    def leaf(path, spec):
        t = _tensor(flat, path, device, None if path.endswith("/w_router") else dtype)
        if tuple(t.shape) != spec.shape:
            raise ValueError(f"{path}: shape {tuple(t.shape)} != {spec.shape}")
        return t

    return _tree(cfg, leaf)


def opt_state_from_numpy(flat: dict, cfg: M.ModelConfig, device) -> dict:
    """This package's AdamW state (``repro_torch.optim.optimizer``) from the
    reference's flat keys (``m/<path>``, ``v/<path>``, ``step``; an int8
    moment as ``<path>/q`` and ``<path>/s``), as ``opt.npz`` holds them.
    Moment dtypes are kept; shapes are checked against the config."""

    def moment(name):
        def leaf(path, spec):
            key = f"{name}/{path}"
            if f"{key}/q" in flat:
                m = {"q": _tensor(flat, f"{key}/q", device),
                     "s": _tensor(flat, f"{key}/s", device)}
                shape = tuple(m["q"].shape)
            else:
                m = _tensor(flat, key, device)
                shape = tuple(m.shape)
            if shape != spec.shape:
                raise ValueError(f"{key}: shape {shape} != {spec.shape}")
            return m
        return _tree(cfg, leaf)

    step = _tensor(flat, "step", device, torch.int32).reshape(())
    return {"m": moment("m"), "v": moment("v"), "step": step}
