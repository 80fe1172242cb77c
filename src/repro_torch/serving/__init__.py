from .engine import BatchStats, ServingEngine
from .loadgen import LoadProfile, Request, steady, synth_requests

__all__ = ["BatchStats", "ServingEngine", "LoadProfile", "Request", "steady",
           "synth_requests"]
