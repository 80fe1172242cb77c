"""Measured sensitivity, as in ``repro.sensitivity``: the offline
per-layer profiler (:mod:`.profile`), the online per-layer estimator fed
by the serving engine's shadow steps (:mod:`.online`) and per-request QoS
classes (:mod:`.classes`).

``online``/``classes`` are numpy-only; ``profile`` pulls in the torch
model stack and is lazy here (PEP 562, as in the reference).
"""

from .classes import ClassBook, ClassScheduler, QoSClass, parse_class_mix
from .online import OnlineSensitivity

_LAZY = {
    "Probe": ".profile",
    "SensitivityProfile": ".profile",
    "truncation_probe": ".profile",
    "model_eval_drift": ".profile",
    "measure_profile": ".profile",
    "measure_cost_matrix": ".profile",
    "costs_for": ".profile",
    "default_profile_path": ".profile",
    "load_profile": ".profile",
}


def __getattr__(name: str):
    if name in _LAZY:
        from importlib import import_module

        value = getattr(import_module(_LAZY[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "QoSClass",
    "ClassBook",
    "ClassScheduler",
    "parse_class_mix",
    "OnlineSensitivity",
    "Probe",
    "SensitivityProfile",
    "truncation_probe",
    "model_eval_drift",
    "measure_profile",
    "measure_cost_matrix",
    "costs_for",
    "default_profile_path",
    "load_profile",
]
