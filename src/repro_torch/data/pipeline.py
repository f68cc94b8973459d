"""Deterministic synthetic token data and the GSS pouch dispatcher (port of
``repro/data/pipeline.py``; numpy only, so both packages read the same
batches).

**Determinism is the fault-tolerance contract**: ``batch_at(step)`` is a
pure function of (seed, step), so a re-executed step consumes
byte-identical data and a restart needs only the journal's step cursor, not
a data-loader checkpoint.

The :class:`PouchDispatcher` applies the paper's GSS pouch/timeout
discipline at the host boundary: worker threads of varying speed pull
microbatch descriptors from a queue in GSS-sized chunks.

A verbatim copy of the reference module: the code is the same, with
``repro.`` renamed ``repro_torch.``.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.gss import PouchController, gss_chunk


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


@dataclass
class PouchDispatcher:
    """GSS-scheduled host-side microbatch dispatch.

    ``n_workers`` loader threads with (mutable) speeds pull work in
    GSS-sized chunks; slow/failed workers simply contribute less — no
    central assignment (the paper's handler-agnostic property)."""

    pipeline: TokenPipeline
    n_workers: int = 4
    speeds: list = field(default_factory=lambda: [1.0, 1.0, 1.0, 1.0])
    work_cost: float = 1e-4      # seconds per microbatch at speed 1
    controller: PouchController = field(default_factory=PouchController)

    def run_steps(self, steps: list[int]) -> dict[int, dict]:
        """Load all step batches; returns {step: batch}. Worker utilisation
        statistics land in ``self.stats``."""
        todo: queue.Queue = queue.Queue()
        for s in steps:
            todo.put(s)
        results: dict[int, dict] = {}
        lock = threading.Lock()
        busy = [0.0] * self.n_workers
        t0 = time.monotonic()

        def worker(i: int) -> None:
            while True:
                grabbed = []
                with lock:
                    chunk = gss_chunk(todo.qsize(), self.n_workers)
                for _ in range(chunk):
                    try:
                        grabbed.append(todo.get_nowait())
                    except queue.Empty:
                        break
                if not grabbed:
                    return
                for s in grabbed:
                    b = self.pipeline.batch_at(s)
                    time.sleep(self.work_cost / max(self.speeds[i], 1e-6))
                    with lock:
                        results[s] = b
                        busy[i] += self.work_cost / max(self.speeds[i], 1e-6)

        threads = [threading.Thread(target=worker, args=(i,), daemon=True)
                   for i in range(self.n_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
        self.stats = {"wall": wall, "busy": busy,
                      "utilization": sum(busy) / (wall * self.n_workers + 1e-9)}
        return results
