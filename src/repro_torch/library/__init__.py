"""The operator library of the port: the on-disk store (:mod:`.store`,
the JAX package's format), Pareto frontiers (:mod:`.pareto`), the
lowering of stored operators to the LUTs the kernels serve
(:mod:`.compile`), and per-layer QoS plans over a frontier (:mod:`.qos`).

Same exports as ``repro.library``; compile and qos load lazily (PEP 562)
on first use, as in the reference.
"""

from .pareto import ParetoFrontier, frontier_sizes, pareto_front
from .store import OperatorRecord, OperatorSignature, OperatorStore

_LAZY = {
    "CompiledLut": ".compile",
    "clear_compile_cache": ".compile",
    "compile_circuit": ".compile",
    "compile_record": ".compile",
    "load_mul_frontier": ".compile",
    "LayerPlan": ".qos",
    "measure_layer_costs": ".qos",
    "measure_sensitivities": ".qos",
    "plan_ladder": ".qos",
    "refresh_plan": ".qos",
    "select_plan": ".qos",
    "stack_luts": ".qos",
    "validate_lut_stack": ".qos",
}


def __getattr__(name: str):
    if name in _LAZY:
        from importlib import import_module

        value = getattr(import_module(_LAZY[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "frontier_sizes",
    "OperatorStore",
    "OperatorRecord",
    "OperatorSignature",
    "ParetoFrontier",
    "pareto_front",
    "CompiledLut",
    "compile_record",
    "compile_circuit",
    "load_mul_frontier",
    "clear_compile_cache",
    "LayerPlan",
    "select_plan",
    "refresh_plan",
    "plan_ladder",
    "validate_lut_stack",
    "measure_layer_costs",
    "measure_sensitivities",
    "stack_luts",
]
