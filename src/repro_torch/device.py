"""Device resolution: the port runs on CUDA unless the caller asks for the
CPU, and raises rather than falling back when no card is present."""

from __future__ import annotations

import torch


def disable_tf32() -> None:
    """Float32 products and convolutions in true float32: TF32 keeps about
    three decimal digits, which would break the 2e-4 float32 parity bar."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA. A CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
