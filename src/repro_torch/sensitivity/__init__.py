"""Measured sensitivity, as far as the port has it: per-request QoS
classes (:mod:`.classes`) and the online per-layer estimator fed by the
serving engine's shadow steps (:mod:`.online`).  The offline profiler
(``repro.sensitivity.profile``) is not ported yet."""

from .classes import ClassBook, ClassScheduler, QoSClass, parse_class_mix
from .online import OnlineSensitivity

__all__ = [
    "QoSClass",
    "ClassBook",
    "ClassScheduler",
    "parse_class_mix",
    "OnlineSensitivity",
]
