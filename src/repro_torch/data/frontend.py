"""The pipeline that feeds a model config as its frontend takes its
inputs. The reference's callers (``train()``, the ACAN program) each build
the same :class:`~repro_torch.data.pipeline.PipelineConfig` from the
config; the port builds it here once, and ``data/pipeline.py`` stays a
copy of the reference's module."""

from __future__ import annotations

from repro_torch.data.pipeline import PipelineConfig, TokenPipeline


def pipeline_for(cfg, batch: int, seq: int, seed: int = 0,
                 mode: str = "cyclic") -> TokenPipeline:
    """The pipeline that feeds model config ``cfg``: token ids, codebook
    tokens and labels (B, T, K), or seeded embeddings (B, T, d)."""
    return TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, batch=batch, seq=seq, seed=seed, mode=mode,
        n_codebooks=cfg.n_codebooks if cfg.frontend == "codebooks" else 0,
        embed_dim=cfg.d_model if cfg.frontend == "embeds" else 0))
