"""Deterministic synthetic token data (port of ``repro/data/pipeline.py``:
``PipelineConfig`` and ``TokenPipeline``; numpy only, so both packages read
the same batches).

**Determinism is the fault-tolerance contract**: ``batch_at(step)`` is a
pure function of (seed, step), so a re-executed step consumes
byte-identical data and a restart needs only the journal's step cursor, not
a data-loader checkpoint. The reference's ``PouchDispatcher`` (GSS-scheduled
host-side dispatch) comes with the ACAN runtime slice (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    n_codebooks: int = 0     # musicgen-style multi-stream tokens
    embed_dim: int = 0       # >0 → "embeds" frontend stub
    mode: str = "random"     # random | cyclic (learnable; tests/examples)


class TokenPipeline:
    """Pure-function synthetic LM data: batch_at(step)."""

    def __init__(self, cfg: PipelineConfig) -> None:
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.Generator(np.random.PCG64(
            (cfg.seed * 1_000_003 + step) & 0x7FFFFFFF))
        if cfg.embed_dim > 0:
            emb = rng.standard_normal(
                (cfg.batch, cfg.seq, cfg.embed_dim)).astype(np.float32)
            labels = rng.integers(0, cfg.vocab,
                                  (cfg.batch, cfg.seq)).astype(np.int32)
            return {"embeds": emb, "labels": labels}
        shape = ((cfg.batch, cfg.seq, cfg.n_codebooks) if cfg.n_codebooks
                 else (cfg.batch, cfg.seq))
        if cfg.mode == "cyclic":
            # Perfectly learnable next-token structure: t+1 ≡ t + 1 (mod V)
            base = rng.integers(0, cfg.vocab, (cfg.batch,))
            pos = np.arange(cfg.seq)
            toks = ((base[:, None] + pos[None, :]) % cfg.vocab).astype(np.int32)
            if cfg.n_codebooks:
                toks = np.repeat(toks[..., None], cfg.n_codebooks, axis=-1)
        else:
            toks = rng.integers(0, cfg.vocab, shape).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        return {"tokens": toks, "labels": labels}
