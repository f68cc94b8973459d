"""ACAN / Tuple-Space fault-tolerant reconfigurable runtime — the paper's
core contribution (Li et al., "Fault Tolerant Reconfigurable ML
Multiprocessor", 2025). Port of ``repro/core/__init__.py``: the same
exports."""

from repro_torch.core.cloud import (ACANCloud, CloudConfig, CloudResult,
                                    MultiCloudResult)
from repro_torch.core.faults import FaultPlan, MonitorDaemon
from repro_torch.core.gss import PouchController, TimeoutController, gss_chunk
from repro_torch.core.handler import Handler, HandlerTenant, SpeedBox
from repro_torch.core.ledger import Ledger
from repro_torch.core.manager import Manager, ManagerConfig
from repro_torch.core.program import (GLOBAL_OPS, OpRegistry, OpSpec, UnknownOp,
                                      WorkloadProgram, partition)
from repro_torch.core.space import (ANY, DEFAULT_NAMESPACE, InstrumentedBackend,
                                    LocalBackend, NsSubject, ScopedSpace,
                                    ShardedBackend, SpaceBackend, TSTimeout,
                                    TupleSpace, as_scoped, key_namespace,
                                    make_backend, match, task_take_pattern)
from repro_torch.core.tasks import TaskDesc, content_key

# Program symbols are re-exported lazily (PEP 562): repro_torch.programs.*
# modules import repro_torch.core submodules, so a module-level import here
# would make "import repro_torch.programs.mlp" explode when it is the first
# repro_torch.core import (the package init would re-enter the partially
# initialized mlp module).
_MLP_EXPORTS = {"LayerSpec", "MLPProgram", "prototype_tasks",
                "stage_order", "make_teacher_data"}


def __getattr__(name: str):
    if name in _MLP_EXPORTS:
        from repro_torch.programs import mlp
        return getattr(mlp, name)
    if name == "MoERoutingProgram":
        from repro_torch.programs.moe import MoERoutingProgram
        return MoERoutingProgram
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "ACANCloud", "CloudConfig", "CloudResult", "MultiCloudResult",
    "make_teacher_data",
    "FaultPlan", "MonitorDaemon", "PouchController", "TimeoutController",
    "gss_chunk", "Handler", "HandlerTenant", "SpeedBox", "Ledger",
    "Manager", "ManagerConfig",
    "GLOBAL_OPS", "OpRegistry", "OpSpec", "UnknownOp", "WorkloadProgram",
    "partition", "LayerSpec", "MLPProgram", "MoERoutingProgram",
    "prototype_tasks", "stage_order", "TaskDesc", "content_key",
    "ANY", "TSTimeout", "TupleSpace", "match", "make_backend",
    "SpaceBackend", "LocalBackend", "ShardedBackend", "InstrumentedBackend",
    "DEFAULT_NAMESPACE", "NsSubject", "ScopedSpace", "as_scoped",
    "key_namespace", "task_take_pattern",
]
