from .controller import (ControllerConfig, PlanLadder, QoSController,
                         effective_load_ms)
from .engine import BatchStats, ContinuousServingEngine, ServingEngine
from .kvcache import OutOfPages, PageAllocator
from .loadgen import (LoadProfile, Request, make_profile, parse_prompt_dist,
                      ramp, spike, steady, synth_requests)
from .router import Replica, ReplicaRouter
from .slots import SeqState, SlotPool, WeightedFairQueues
from .telemetry import Telemetry
from .watcher import LibraryWatcher

__all__ = ["BatchStats", "ContinuousServingEngine", "ServingEngine",
           "PlanLadder", "QoSController", "ControllerConfig",
           "effective_load_ms", "LibraryWatcher", "Telemetry", "LoadProfile",
           "Request", "steady", "ramp", "spike", "make_profile",
           "parse_prompt_dist", "synth_requests", "OutOfPages",
           "PageAllocator", "Replica", "ReplicaRouter", "SeqState",
           "SlotPool", "WeightedFairQueues"]
