"""Batched serving runner (port of ``repro/launch/serve.py``): prefill a
batch of prompts, re-home the cache into a fixed-capacity decode cache, and
decode token by token.

Runs on CUDA unless ``device="cpu"`` is passed; with no card it raises.
Prompts, and the ``embeds`` frontend's per-step embeddings, come from
``np.random.default_rng(seed)`` in the reference's order, so both packages
serve the same inputs and, given the same weights, pick the same tokens:
token prompts (B, T); the ``codebooks`` frontend's (B, T, K), its picks
made per codebook, its tokens returned as (B, gen, K); the ``embeds``
frontend's standard-normal (B, T, d) prompt, then a fresh (B, d) embedding
a decode step, drawn after that step's pick.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm_360m --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2_7b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3_12b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek_v2_lite_16b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch musicgen_medium --full

``--arch`` takes ``smollm_360m``, ``mamba2_2_7b``, ``gemma3_12b``,
``h2o_danube_1_8b``, ``command_r_plus_104b``, ``deepseek_v2_lite_16b``,
``qwen2_moe_a2_7b`` (the two MoE configs' prompt and batch tokens must split
into their MoE groups), ``musicgen_medium`` (codebooks) and
``internvl2_76b`` (embeds; on one card only at a cut depth, through
``serve(..., params=...)``: its 80 layers are 139 GB in bf16); without
``--full`` the reduced config.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import model as M


def _pick(logits: torch.Tensor, greedy: bool, rng) -> torch.Tensor:
    """Next-token choice over the last axis: argmax, or (``greedy=False``)
    softmax sampling on the host."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    lg = logits.double().cpu().numpy()
    lg -= lg.max(axis=-1, keepdims=True)
    p = np.exp(lg)
    p /= p.sum(axis=-1, keepdims=True)
    flat = p.reshape(-1, p.shape[-1])
    toks = np.array([rng.choice(flat.shape[-1], p=row) for row in flat])
    return torch.as_tensor(toks.reshape(lg.shape[:-1]), device=logits.device)


def prompt_inputs(cfg, rng, batch: int, prompt_len: int, device) -> dict:
    """The prefill batch of ``cfg``'s frontend, drawn from ``rng`` as the
    reference draws it: a float32 standard-normal (B, T, d) ``embeds``
    prompt, or ``tokens`` below the vocab, (B, T, K) for codebooks."""
    if cfg.frontend == "embeds":
        x = rng.standard_normal((batch, prompt_len, cfg.d_model)).astype(np.float32)
        return {"embeds": torch.as_tensor(x, device=device)}
    shape = (batch, prompt_len) + ((cfg.n_codebooks,) if cfg.frontend == "codebooks" else ())
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, shape).astype(np.int64),
                                      device=device)}


def pick(cfg, logits: torch.Tensor, greedy: bool, rng) -> torch.Tensor:
    """A step's token from its logits (B, head_width): one a codebook on the
    logits reshaped to (B, K, V), (B, K); else over the first ``vocab``
    columns, (B,)."""
    if cfg.frontend == "codebooks":
        return _pick(logits.reshape(len(logits), cfg.n_codebooks, cfg.vocab), greedy, rng)
    return _pick(logits[:, :cfg.vocab], greedy, rng)


def step_inputs(cfg, tok: torch.Tensor, rng, device) -> dict:
    """The next decode step's input after its pick ``tok``: the token, or
    for the ``embeds`` frontend a fresh float32 standard-normal (B, d)
    embedding drawn from ``rng`` (after the pick's own draws)."""
    if cfg.frontend == "embeds":
        x = rng.standard_normal((len(tok), cfg.d_model)).astype(np.float32)
        return {"embed": torch.as_tensor(x, device=device)}
    return {"token": tok}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, *, reduced: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 16, cache_len: int = 128,
          seed: int = 0, greedy: bool = True, log=print, device=None,
          params: dict | None = None) -> dict:
    """``params`` (optional) replaces the seeded random init, e.g. weights
    carried over with :mod:`repro_torch.checkpoint.convert`; the model runs
    at their depth (a model too deep for one card, cut in depth)."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if params is not None:
        cfg = M.at_depth_of(cfg, params)
    rng = np.random.default_rng(seed)
    if params is None:
        params = M.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    prefill = make_prefill_step(cfg)
    decode = make_decode_step(cfg)

    prompt = prompt_inputs(cfg, rng, batch, prompt_len, dev)

    _sync(dev)
    t0 = time.perf_counter()
    small_cache, logits = prefill(params, prompt)
    cache = rehome(M.init_cache(cfg, batch, cache_len, dev), small_cache)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    tokens_out = []
    t0 = time.perf_counter()
    cur = prompt_len
    for _ in range(gen):
        tok = pick(cfg, logits, greedy, rng)
        tokens_out.append(tok)
        logits, cache = decode(params, cache,
                               step_inputs(cfg, tok, rng, dev) | {"cur_len": cur})
        cur += 1
    _sync(dev)
    t_decode = time.perf_counter() - t0
    out = torch.stack(tokens_out, dim=1).cpu().numpy().astype(np.int32)
    log(f"prefill {batch}x{prompt_len} in {t_prefill:.2f}s; "
        f"decode {gen} tokens in {t_decode:.2f}s "
        f"({batch * gen / max(t_decode, 1e-9):.1f} tok/s)")
    return {"tokens": out, "t_prefill": t_prefill, "t_decode": t_decode}


def rehome(big, small):
    """Copy a prefill cache into the fixed-capacity decode cache ``big``, in
    place, leaf by leaf as the reference's ``rehome``: a leaf whose shape
    agrees (an SSM state, a conv buffer) is copied whole, otherwise it fills
    the start of the single axis that differs (the cache sequence axis).
    Returns ``big``.

    A sliding-window layer's prefill cache holds the last ``min(window, T)``
    of the T prompt positions, position p at slot ``p % min(window, T)``;
    decode writes position p at slot ``p % S`` of a cache of
    ``S = min(cache_len, window)`` slots. The two agree whenever the prefill
    cache fits, in every regime: a prompt shorter than the window fills
    slots 0 .. T - 1 with positions 0 .. T - 1, and a prompt as long as the
    window or longer gives a ring of the decode cache's own shape, copied
    whole (``cache_len >= window``). A ``cache_len`` below the window makes
    decode wrap at ``cache_len``, as the reference's does."""
    if isinstance(big, torch.Tensor):
        dst = big
        if big.shape != small.shape:
            diff = [i for i, (a, b) in enumerate(zip(big.shape, small.shape)) if a != b]
            assert len(diff) == 1 and big.dim() == small.dim(), (big.shape, small.shape)
            dst = big.narrow(diff[0], 0, small.shape[diff[0]])
        dst.copy_(small)
    elif isinstance(big, dict):
        assert big.keys() == small.keys(), (big.keys(), small.keys())
        for k in big:
            rehome(big[k], small[k])
    else:
        assert len(big) == len(small), (len(big), len(small))
        for b, s in zip(big, small):
            rehome(b, s)
    return big


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of the reduced one")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the plain path)")
    ap.add_argument("--sample", action="store_true",
                    help="softmax-sample instead of greedy argmax")
    args = ap.parse_args()
    serve(args.arch, reduced=not args.full, batch=args.batch,
          prompt_len=args.prompt_len, gen=args.gen, cache_len=args.cache_len,
          seed=args.seed, greedy=not args.sample, device=args.device)


if __name__ == "__main__":
    main()
