"""Quickstart on the PyTorch port: train a reduced SmolLM on synthetic data
with the full production runner (journal + checkpoint + watchdog), then
serve it. Twin of ``examples/quickstart.py``; imports only ``repro_torch``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu|cuda]

``--device`` defaults to ``cuda`` (raises without a card; ``cpu`` runs the
plain path). The run starts afresh each time; its journal and checkpoints
go to ``runs/torch_quickstart/``.
"""

from _torch_example_args import device_arg
from repro_torch.launch.serve import serve
from repro_torch.launch.train import train


def main() -> None:
    device = device_arg()
    print(f"=== train (reduced smollm_360m, 30 steps, {device}) ===")
    out = train("smollm_360m", reduced=True, steps=30, batch=8, seq=64,
                ckpt_dir="runs/torch_quickstart", ckpt_every=10, resume=False,
                device=device)
    print(f"\nloss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
          f"({out['wall']:.1f}s)")
    assert out["losses"][-1] < out["losses"][0]

    print("\n=== serve (batched prefill + decode) ===")
    serve("smollm_360m", reduced=True, batch=4, prompt_len=32, gen=8,
          cache_len=64, device=device, params=out["params"])


if __name__ == "__main__":
    main()
