"""npz checkpoints in the reference's layout (port of
``repro/checkpoint/checkpoint.py``), so either package resumes from the
other's checkpoint.

A checkpoint directory holds ``params.npz``, ``opt.npz`` (optional) and
``manifest.json``: one array per leaf keyed by its tree path (``embed/tok``,
``period/0/attn/wq``, ``m/final_ln``, ``step``, ...), the per-layer tensors of
a period stacked on the leading ``n_periods`` axis as the reference keeps
them, bfloat16 stored as a ``uint16`` view with its dtype named in the
manifest, and the manifest written last and renamed into place (the atomic
commit: a directory without it holds no checkpoint).

In the port's trees a list is the unstacked ``n_periods`` axis
(``params["period"][j]`` is a list over repetitions, see
``models/model.py``): saving stacks a list's leaves along a new leading
axis, loading indexes it back.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """{reference path: tensor}; a list's leaves are stacked on axis 0."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)  # noqa: E731
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        parts = [_flatten(t, prefix) for t in tree]
        return {k: torch.stack([p[k] for p in parts]) for k in parts[0]} if parts else {}
    else:
        items = enumerate(tree)
    out: dict[str, torch.Tensor] = {}
    for k, v in items:
        out |= _flatten(v, join(k))
    return out


def save_checkpoint(path: str, step: int, params, opt_state=None) -> str:
    os.makedirs(path, exist_ok=True)
    trees = {"params": params}
    if opt_state is not None:
        trees["opt"] = opt_state
    manifest = {"step": int(step), "arrays": {}}
    for name, tree in trees.items():
        arrays = {}
        for k, v in _flatten(tree).items():
            arrays[k], manifest["arrays"][f"{name}/{k}"] = _to_numpy(v)
        np.savez(os.path.join(path, f"{name}.npz"), **arrays)
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "manifest.json"))  # atomic commit
    return path


class _Arrays(dict):
    """An npz file's arrays, each read from the archive once."""

    def __init__(self, npz):
        super().__init__()
        self.npz = npz

    def __missing__(self, key):
        arr = self[key] = self.npz[key]
        return arr


def _restore(like, data, dtypes: dict, name: str, prefix: str = "", index: tuple = ()):
    """A tree shaped like ``like`` from the npz ``data``; ``index`` picks a
    layer out of the stacked arrays below a list."""
    if isinstance(like, torch.Tensor):
        arr = data[prefix][index] if index else data[prefix]
        if dtypes[f"{name}/{prefix}"] == "bfloat16":
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(like.device)
    join = lambda k: f"{prefix}/{k}" if prefix else str(k)  # noqa: E731
    if isinstance(like, dict):
        return {k: _restore(v, data, dtypes, name, join(k), index) for k, v in like.items()}
    if isinstance(like, list):
        return [_restore(v, data, dtypes, name, prefix, index + (i,))
                for i, v in enumerate(like)]
    return tuple(_restore(v, data, dtypes, name, join(i), index)
                 for i, v in enumerate(like))


def load_checkpoint(path: str, params_like, opt_like=None):
    """Restore into the structure of ``params_like`` (and ``opt_like``): each
    leaf takes its like's device and the checkpoint's dtype. Returns
    (step, params, opt_state | None)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def restore(name, like):
        with np.load(os.path.join(path, f"{name}.npz")) as data:
            return _restore(like, _Arrays(data), manifest["arrays"], name)

    params = restore("params", params_like)
    opt = restore("opt", opt_like) if opt_like is not None else None
    return manifest["step"], params, opt
