"""Built-in workload programs for the port's ACAN plane (port of
``repro/programs/__init__.py``).

Importing this package registers the stateless built-in ops into
:data:`repro_torch.core.program.GLOBAL_OPS`. The reference registers its
MLP prototype ops and MoE routing ops here; neither program is ported
yet (ROADMAP.md), so nothing is registered. The torch-SGD program is
not imported here: it pulls in the model zoo; import
:mod:`repro_torch.programs.torch_sgd` explicitly.
"""

__all__: list[str] = []
