"""Step functions (port of ``repro/launch/steps.py``: the train, prefill and
decode steps). PyTorch runs eagerly, so a step is a closure over the config
with no compilation or sharding tree."""

from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.optim.optimizer import (OptConfig, adamw_update, tree_leaves,
                                         tree_map)


def make_train_step(cfg: M.ModelConfig, opt_cfg: OptConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients by ``torch.autograd.grad`` over
    the parameter leaves, then the out-of-place AdamW update, which writes
    the new parameters into the step's own gradients. The inputs are left
    as they were, so the watchdog may re-issue the step. Metrics are Python
    floats: reading them waits for the device, so the step returns when its
    work is done."""

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            leaves = tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss, metrics = M.train_loss(leaves, cfg, batch)
            # A weight the loss does not read (command_r's ffn norm, which
            # its parallel block skips) gets zeros, as jax.grad gives it.
            grads = torch.autograd.grad(loss, tree_leaves(leaves), materialize_grads=True)
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        params, opt_state, om = adamw_update(params, grads, opt_state, opt_cfg,
                                             donate_grads=True)
        out = {"loss": loss, **metrics, **om}
        return params, opt_state, {k: float(v.detach()) for k, v in out.items()}

    return train_step


def make_prefill_step(cfg: M.ModelConfig):
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch)
    return prefill_step


def make_decode_step(cfg: M.ModelConfig):
    def decode_step(params, cache, batch):
        return M.decode_step(params, cfg, cache, batch)
    return decode_step
