"""Built-in workload programs for the port's ACAN plane (port of
``repro/programs/__init__.py``).

Importing this package registers the stateless built-in ops (the paper's
five MLP prototype ops and the MoE routing ops) into
:data:`repro_torch.core.program.GLOBAL_OPS`. The torch-SGD program is not imported here: it
pulls in the model zoo; import :mod:`repro_torch.programs.torch_sgd`
explicitly.
"""

from repro_torch.programs.mlp import LayerSpec, MLPProgram, make_teacher_data, prototype_tasks, stage_order
from repro_torch.programs.moe import MoERoutingProgram

__all__ = [
    "LayerSpec", "MLPProgram", "make_teacher_data", "prototype_tasks",
    "stage_order", "MoERoutingProgram",
]
