"""Multi-replica serving front: a router over ≥2 continuous engines.

One process, several :class:`~repro_torch.serving.engine.ContinuousServingEngine`
replicas sharing a single watched
:class:`~repro_torch.library.store.OperatorStore` — but each with its *own*
plan state.  That is the piece a single engine cannot express: within one
decode step every slot shares one LUT stack, so the way to give ``gold``
exact tiles *while* ``batch`` traffic soaks on W8A8 is to home the
classes on different replicas.  The router:

* **routes** each arrival by class affinity first (a replica declaring
  ``classes=("gold",)`` gets every gold request it can hold), falling
  back to the least-loaded replica (active slots + queued work per slot,
  deterministic tie toward the earlier replica);
* **steps** all replicas in lockstep through their public
  ``submit``/``step_once`` API — each keeps its own slot pool, page
  allocator, telemetry, controller and scheduler;
* **polls the shared store once** per tick and fans a refresh out to
  every replica, each of which rebuilds its own ladder and revalidates
  its own stacks (a refused refresh on one replica leaves only that
  replica on its old plan).

Every replica's decode step is still captured exactly once; the router adds
no device work of its own.

Own copy of ``repro.serving.router``, whole.  On one card the replicas share one
``params`` dict; each has its own engine and its own captured step.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Sequence

from ..obs.trace import event as trace_event
from .engine import ContinuousServingEngine
from .loadgen import LoadProfile, Request, synth_requests
from .telemetry import Telemetry

__all__ = ["Replica", "ReplicaRouter"]


@dataclass
class Replica:
    """One engine plus its private control plane and class affinity."""

    name: str
    engine: ContinuousServingEngine
    controller: object | None = None
    scheduler: object | None = None
    online: object | None = None
    classes: tuple[str, ...] = ()    # QoS classes homed here ((): any)
    telemetry: Telemetry = field(default_factory=Telemetry)
    # per-replica obs.health.HealthPlane: its ok/warn/page state adds a
    # routing penalty so a degraded replica sheds load to healthy peers
    health: object | None = None

    @property
    def routing_score(self) -> float:
        score = self.engine.load_score
        if self.health is not None:
            score += self.health.penalty
        return score


class ReplicaRouter:
    def __init__(self, replicas: Sequence[Replica], *, watcher=None) -> None:
        if len(replicas) < 2:
            raise ValueError(
                f"a router fronts at least 2 replicas, got {len(replicas)}")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names {names}")
        self.replicas = list(replicas)
        self.watcher = watcher
        self.routed: dict[str, int] = {r.name: 0 for r in self.replicas}

    # ----------------------------------------------------------------- route
    def route(self, request: Request) -> Replica:
        """Class affinity first, then least-loaded *healthy*.  Affinity is
        a preference, not a wall: if no replica claims the class (or the
        claiming replicas are the only ones and all is equal) the load
        tie-break still yields a deterministic home.  A replica whose
        health plane reports warn/page carries a load-score penalty
        (:attr:`Replica.routing_score`) so it measurably sheds admissions
        while it burns — without being black-holed: it still wins when
        every healthy peer is proportionally busier."""
        homed = [r for r in self.replicas
                 if request.qos_class in r.classes]
        candidates = homed or self.replicas
        return min(candidates, key=lambda r: r.routing_score)

    def submit(self, request: Request, now: float | None = None) -> Replica:
        r = self.route(request)
        r.engine.submit(request, now)
        self.routed[r.name] += 1
        return r

    # ----------------------------------------------------------------- serve
    def start(self, *, log: Callable[[str], None] | None = None) -> None:
        for r in self.replicas:
            # stamp before start(): every req.* lifecycle event a replica
            # emits names the engine that served the request, so merged
            # timelines stay attributable in a multi-replica trace
            r.engine.replica_name = r.name
            r.engine.start(telemetry=r.telemetry, controller=r.controller,
                           scheduler=r.scheduler, online=r.online,
                           health=r.health, log=log)

    def step_all(self) -> bool:
        """One decode step on every replica with active work."""
        stepped = [r.engine.step_once() for r in self.replicas]
        return any(stepped)

    def _poll_shared_store(self, log=None) -> None:
        """One poll of the shared store, fanned out to every replica —
        per-replica ladders/levels survive, only the frontier refreshes."""
        if self.watcher is None or not self.watcher.poll():
            return
        try:
            fr = self.watcher.load_frontier()
        except LookupError as e:
            if log:
                log(f"router watcher: refresh skipped ({e})")
            return
        for r in self.replicas:
            if r.engine.plan is None:
                continue
            try:
                if r.engine._width_map is not None:
                    changed = r.engine.refresh_mixed(
                        fr, controller=r.controller, scheduler=r.scheduler,
                        telemetry=r.telemetry)
                else:
                    compiled, exact_area, _bits = fr
                    changed = r.engine.refresh_library(
                        compiled, exact_area, controller=r.controller,
                        scheduler=r.scheduler, telemetry=r.telemetry)
                trace_event("router.refresh", replica=r.name,
                            changed=changed)
            except (LookupError, ValueError) as e:
                if log:
                    log(f"router watcher ({r.name}): refresh skipped ({e})")

    def serve(self, profile: LoadProfile, *, seed: int = 0,
              steps_per_tick: int | None = None,
              log: Callable[[str], None] | None = None) -> dict:
        """Serve one load profile across the fleet and return the merged
        summary.  Arrivals route per request; all replicas then step in
        lockstep so a gold-homed replica never waits on a busy batch
        one."""
        import time

        self.start(log=log)
        per_tick = synth_requests(profile, self.replicas[0].engine.cfg
                                  .vocab_size, seed)
        steps = steps_per_tick or max(r.engine.steps_per_tick
                                      for r in self.replicas)
        for tick, reqs in enumerate(per_tick):
            now = time.perf_counter()
            for r in reqs:
                self.submit(r, now)
            for _ in range(steps):
                if not self.step_all():
                    break
            self._poll_shared_store(log)
        while self.step_all():
            pass
        return self.summary()

    # --------------------------------------------------------------- results
    def summary(self) -> dict:
        per = {}
        for r in self.replicas:
            s = r.telemetry.summary()
            s["routed"] = self.routed[r.name]
            s["trace_count"] = r.engine.trace_count
            if r.engine.plan is not None:
                s["plan"] = r.engine.plan.plan_id
                s["widths"] = list(r.engine.widths)
            if r.health is not None:
                s["health"] = r.health.report()
            per[r.name] = s
        total_req = sum(s["requests"] for s in per.values())
        out = {
            "replicas": per,
            "requests": total_req,
            "preemptions": sum(s.get("preemptions", 0)
                               for s in per.values()),
        }
        # fleet-level cost dividend: the per-replica attributions sum —
        # the invariant the multi-replica provenance test pins against
        # the merged ledger
        costs = [s["costs"] for s in per.values() if "costs" in s]
        if costs:
            out["costs"] = {
                "mlp_macs": sum(c["mlp_macs"] for c in costs),
                "approx_macs": sum(c["approx_macs"] for c in costs),
                "area_mac_saved": [
                    round(sum(c["area_mac_saved"][0] for c in costs), 4),
                    round(sum(c["area_mac_saved"][1] for c in costs), 4)],
            }
        return out
