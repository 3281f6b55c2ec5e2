"""IMAC-Sim core on PyTorch: the paper's contribution as torch modules.

Public API:
  devices.DeviceTech / MRAM / RRAM / CBRAM / PCM
  interconnect.Interconnect
  mapping.map_wb / map_network          (Module 2: mapWB)
  partition.auto_partition / plan_partition / plan_topology / tile_matrix
  solver.solve_crossbar / solve_dense_mna (the "SPICE engine")
  solver.Stamps / SolveOptions           (stamps + backend choice)
  backends.register_backend / available_backends / get_backend /
    default_backend_name
  neurons.NeuronModel
  imac.IMACConfig / IMACNetwork / imac_linear (Modules 3-4)
  evaluate.test_imac / evaluate_batch / sweep (Module 1: testIMAC)
"""
from repro_torch.core.backends import (
    SolverBackend,
    available_backends,
    default_backend_name,
    get_backend,
    register_backend,
)
from repro_torch.core.devices import (
    CBRAM,
    MRAM,
    PCM,
    RRAM,
    TECHNOLOGIES,
    DeviceTech,
    custom_tech,
    get_tech,
)
from repro_torch.core.evaluate import (
    IMACResult,
    evaluate_batch,
    structure_key,
    sweep,
    test_imac,
)
from repro_torch.core.imac import (
    IMACConfig,
    IMACNetwork,
    imac_linear,
    linear_forward,
)
from repro_torch.core.interconnect import DEFAULT_INTERCONNECT, Interconnect
from repro_torch.core.mapping import MappedLayer, map_network, map_wb
from repro_torch.core.neurons import NeuronModel, get_neuron
from repro_torch.core.partition import (
    PartitionPlan,
    auto_partition,
    plan_partition,
    plan_topology,
)
from repro_torch.core.solver import (
    CircuitParams,
    SolveOptions,
    Stamps,
    crossbar_power,
    solve_crossbar,
    solve_dense_mna,
    solve_ideal,
)

__all__ = [
    "CBRAM",
    "CircuitParams",
    "DEFAULT_INTERCONNECT",
    "DeviceTech",
    "IMACConfig",
    "IMACNetwork",
    "IMACResult",
    "Interconnect",
    "MRAM",
    "MappedLayer",
    "NeuronModel",
    "PCM",
    "PartitionPlan",
    "RRAM",
    "SolveOptions",
    "SolverBackend",
    "Stamps",
    "TECHNOLOGIES",
    "auto_partition",
    "available_backends",
    "crossbar_power",
    "custom_tech",
    "default_backend_name",
    "evaluate_batch",
    "get_backend",
    "get_neuron",
    "get_tech",
    "imac_linear",
    "linear_forward",
    "map_network",
    "map_wb",
    "plan_partition",
    "plan_topology",
    "register_backend",
    "solve_crossbar",
    "solve_dense_mna",
    "solve_ideal",
    "structure_key",
    "sweep",
    "test_imac",
]
