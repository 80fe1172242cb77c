"""The operator library of the port: the on-disk store (:mod:`.store`,
the JAX package's format), Pareto frontiers (:mod:`.pareto`) and the
lowering of stored operators to the LUTs the kernels serve
(:mod:`.compile`)."""

from .pareto import ParetoFrontier, frontier_sizes, pareto_front
from .store import OperatorRecord, OperatorSignature, OperatorStore

__all__ = ["OperatorRecord", "OperatorSignature", "OperatorStore",
           "ParetoFrontier", "frontier_sizes", "pareto_front"]
