from .controller import (ControllerConfig, PlanLadder, QoSController,
                         effective_load_ms)
from .engine import BatchStats, ServingEngine
from .loadgen import LoadProfile, Request, steady, synth_requests
from .telemetry import Telemetry
from .watcher import LibraryWatcher

__all__ = ["BatchStats", "ServingEngine", "PlanLadder", "QoSController",
           "ControllerConfig", "effective_load_ms", "LibraryWatcher",
           "Telemetry", "LoadProfile", "Request", "steady", "synth_requests"]
