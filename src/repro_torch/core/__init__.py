"""SimDIT core of the port: the paper's analytical performance model (a
copy of the JAX package's numpy cost model, the per-layer ``simulator``
included) and the DSE study whose grid reductions run in torch on the GPU
(``gridtorch``)."""
from .hardware import (HI1, HI2, HI3, HT1, HT2, HT3, INFER_PRESETS,
                       TRAIN_PRESETS, HardwareSpec)
from .layers import ConvLayer, SimdLayer, fc, phase_key
from .backward import dx_conv, dw_conv, expand_training_graph
from .objectives import (EDP, Cycles, CyclesUnderPowerCap, Energy,
                         Objective, register_objective, resolve_objective)
from .simulator import (LayerReport, NetworkReport, simulate,
                        simulate_network)
from .store import TableStore, store_context
from .study import IntegrityError, Study, Workload

__all__ = [
    "HardwareSpec", "HT1", "HT2", "HT3", "HI1", "HI2", "HI3",
    "TRAIN_PRESETS", "INFER_PRESETS",
    "ConvLayer", "SimdLayer", "fc", "phase_key",
    "dx_conv", "dw_conv", "expand_training_graph",
    "Study", "Workload", "Objective", "Cycles", "Energy", "EDP",
    "CyclesUnderPowerCap", "register_objective", "resolve_objective",
    "TableStore", "store_context", "IntegrityError",
    "LayerReport", "NetworkReport", "simulate", "simulate_network",
]
