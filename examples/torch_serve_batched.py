"""Batched serving across architecture families on the port: GQA (smollm),
SSM (mamba2 — O(1) state), MLA compressed-cache (deepseek), and the audio
codebook decoder (musicgen) — same serve loop, family-specific caches.
Twin of ``examples/serve_batched.py``; imports only ``repro_torch``.

    PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu|cuda]

``--device`` defaults to ``cuda`` (raises without a card; ``cpu`` runs the
plain path). The reduced configs are float32, so on the card every product
takes ``tile_matmul``'s float32 kernels (``ffma``; ``skinny`` at the decode
steps' 4 rows) and the attention and the scan theirs (``ffma``).
"""

from _torch_example_args import device_arg
from repro_torch.launch.serve import serve

ARCHS = ("smollm_360m", "mamba2_2_7b", "deepseek_v2_lite_16b", "musicgen_medium")


def serve_config(**overrides) -> dict:
    """The example's serve settings: the reduced configs, batch 4, 32-token
    prompts, 8 greedy tokens, a 64-slot decode cache."""
    return dict(reduced=True, batch=4, prompt_len=32, gen=8, cache_len=64) | overrides


def run(device: str, log=print) -> dict:
    """Serve each of ``ARCHS`` on ``device`` as ``serve_config`` says;
    returns each architecture's ``serve`` result."""
    out = {}
    for arch in ARCHS:
        log(f"\n=== {arch} (reduced) ===")
        out[arch] = serve(arch, device=device, log=log, **serve_config())
        log(f"generated token matrix shape: {out[arch]['tokens'].shape}")
    return out


def main() -> None:
    run(device_arg())


if __name__ == "__main__":
    main()
