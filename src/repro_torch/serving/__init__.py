from .controller import PlanLadder
from .engine import BatchStats, ServingEngine
from .loadgen import LoadProfile, Request, steady, synth_requests

__all__ = ["BatchStats", "ServingEngine", "PlanLadder", "LoadProfile",
           "Request", "steady", "synth_requests"]
