"""PyTorch/CUDA port of the ``repro`` model stack for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package mirrors it
module for module (``repro_torch/models/attention.py`` ↔
``repro/models/attention.py``, …) and imports nothing from it. Plain tensor
code is PyTorch; the Pallas TPU kernels become hand-written CUDA kernels
under ``csrc/``, each with a plain PyTorch twin beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
they never fall back to the CPU (:mod:`repro_torch.device`).
"""

from repro_torch.device import disable_tf32

disable_tf32()
