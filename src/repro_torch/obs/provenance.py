"""Approximation-provenance ledger: which circuits computed which tokens.

The trace answers *when* things happened; this ledger answers *what
produced each output*.  QoS-Nets-style adaptive serving reassigns
operators mid-request — a preempted-and-resumed ``gold`` request can
decode its first tokens on one plan and its last on another after a
mid-flight swap — so quality claims ("drift stayed under budget") are
only auditable if every generated token can be traced back to the
(plan, ladder level, width map, per-layer operator content keys) that
was live when it was sampled, together with the shadow-drift samples
measured in that window.

Three append-only record kinds, one JSON object per line:

* ``plan``  — a plan's identity, written once per writer: ``plan_id``
  -> per-layer operator content keys (``"exact"`` for exact layers),
  the width map when serving mixed width, and — for the cost plane —
  the per-layer operator area bracket (``areas``/``areas_hi``, exact
  layers carry the baseline) plus the per-layer ``exact_area``.  The
  analog of telemetry's plan table, but durable next to the trace.
* ``model`` — the serving model's LUT-routable MLP MAC vector
  (:func:`repro_torch.obs.costs.mlp_macs_per_layer`), written once per
  writer so the reference's ``python -m repro.obs costs`` prices a ledger offline
  without reloading the model config.
* ``range`` — one request's contiguous run of generated-token indices
  ``[t0, t1)`` decoded under a single plan/ladder level, plus the
  shadow-drift samples the engine measured while the range was open.
  Ranges close on plan change, preemption, and completion, so the
  ledger of a completed request tiles ``[0, gen_len)`` exactly.
* ``done``  — the request completed: expected ``gen_len``, total decode
  steps, preemption count.  :func:`audit` treats a ``done`` without a
  gap-free range cover as a provenance failure.

File discipline mirrors :mod:`repro_torch.obs.trace`: one ``prov-<tag>.jsonl``
per writing process in the same trace directory, one flushed line per
record (a crash tears at most the final line), read-time merge with
torn-line tolerance and dedup by ``(writer tag, sequence)`` so re-copied
files stay idempotent.  Provenance volume is a few records per request —
no rotation needed.  Everything is stdlib-only.

Own copy of ``repro.obs.provenance``, whole.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Callable

__all__ = [
    "PROV_GLOB",
    "ProvenanceLedger",
    "ledger_for",
    "read_ledger",
    "audit",
]

PROV_GLOB = "prov-*.jsonl"


class ProvenanceLedger:
    """One process's provenance writer (see module docstring).

    ``tag`` defaults to ``<hostname>-<pid>`` like the tracer's; serving
    code shares one ledger per ``(root, tag)`` via :func:`ledger_for` so
    router replicas in one process never interleave conflicting sequence
    numbers into the same file.
    """

    def __init__(self, root: str | os.PathLike, *, tag: str | None = None,
                 clock: Callable[[], float] = time.time) -> None:
        import socket

        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.tag = tag or f"{socket.gethostname()}-{os.getpid()}"
        self._clock = clock
        self._seq = 0
        self._fh = None
        self._lock = threading.Lock()
        self._plans_written: set[str] = set()
        self._model_written = False

    @property
    def path(self) -> Path:
        return self.root / f"prov-{self.tag}.jsonl"

    def _write(self, doc: dict) -> None:
        with self._lock:
            doc = {**doc, "w": self.tag, "n": self._seq,
                   "t": self._clock()}
            self._seq += 1
            if self._fh is None:
                self._fh = open(self.path, "a")
            self._fh.write(json.dumps(doc, sort_keys=True) + "\n")
            self._fh.flush()

    # ----------------------------------------------------------------- write
    def note_plan(self, plan_id: str, layers: list[str],
                  width_map=None, *, areas=None, areas_hi=None,
                  exact_area=None) -> None:
        """Record a plan's identity once per writer (content-addressed
        ids make cross-writer duplicates harmless — ``audit`` keeps the
        first).  ``areas``/``areas_hi`` carry the per-layer operator
        area bracket and ``exact_area`` the per-layer exact baseline,
        so the cost plane can price the plan offline."""
        if plan_id in self._plans_written:
            return
        self._plans_written.add(plan_id)
        doc = {"k": "plan", "plan": plan_id, "layers": list(layers),
               "width_map": (list(int(b) for b in width_map)
                             if width_map is not None else None)}
        if areas is not None:
            doc["areas"] = [round(float(a), 6) for a in areas]
        if areas_hi is not None:
            doc["areas_hi"] = [round(float(a), 6) for a in areas_hi]
        if exact_area is not None:
            doc["exact_area"] = round(float(exact_area), 6)
        self._write(doc)

    def note_model(self, *, name: str, macs: list[int]) -> None:
        """Record the model's per-layer LUT-routable MAC vector once per
        writer — the denominator every cost attribution joins against."""
        if self._model_written:
            return
        self._model_written = True
        self._write({"k": "model", "name": name,
                     "n_layers": len(macs),
                     "macs": [int(m) for m in macs]})

    def record_range(self, *, rid: int, cls: str, t0: int, t1: int,
                     plan: str, level: int | None,
                     drift: list[float], replica: str | None = None) -> None:
        doc = {"k": "range", "rid": int(rid), "cls": cls,
               "t0": int(t0), "t1": int(t1), "plan": plan,
               "level": level, "drift": list(drift)}
        if replica:
            doc["replica"] = replica
        self._write(doc)

    def record_done(self, *, rid: int, cls: str, gen_len: int, steps: int,
                    preempts: int, replica: str | None = None) -> None:
        doc = {"k": "done", "rid": int(rid), "cls": cls,
               "gen_len": int(gen_len), "steps": int(steps),
               "preempts": int(preempts)}
        if replica:
            doc["replica"] = replica
        self._write(doc)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# one shared writer per (root, tag): two engines started in one traced
# process (router mode) must append through one sequence counter, or the
# read-time (w, n) dedup would silently drop records
_ledgers: dict[tuple[str, str], ProvenanceLedger] = {}
_ledgers_lock = threading.Lock()


def ledger_for(root: str | os.PathLike, tag: str | None = None, *,
               clock: Callable[[], float] = time.time) -> ProvenanceLedger:
    probe = ProvenanceLedger(root, tag=tag, clock=clock)
    key = (str(Path(root)), probe.tag)
    with _ledgers_lock:
        return _ledgers.setdefault(key, probe)


# ---------------------------------------------------------------------------
# read-time merge + audit
# ---------------------------------------------------------------------------
def read_ledger(root: str | os.PathLike) -> list[dict]:
    """Union every ``prov-*.jsonl`` under ``root``: skip torn lines,
    dedup by ``(writer, seq)``, return records sorted by write order."""
    root = Path(root)
    records: dict[tuple[str, int], dict] = {}
    for path in sorted(root.glob(PROV_GLOB)):
        for line in path.read_text().splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue   # torn tail of a crashed writer
            if isinstance(doc, dict) and "w" in doc and "n" in doc:
                records.setdefault((doc["w"], int(doc["n"])), doc)
    return sorted(records.values(),
                  key=lambda r: (r.get("t", 0.0), r["w"], r["n"]))


def audit(records: list[dict]) -> dict:
    """Per-request provenance report over merged ledger records.

    A request that recorded ``done`` is *complete* when its ranges tile
    ``[0, gen_len)`` with no gap and no overlap and every referenced
    plan id has a ``plan`` record (``"exact"`` — the planless serve — is
    implicitly known).  Requests without a ``done`` (still in flight, or
    a serve that crashed) are reported but never counted as failures.

    Records are grouped by ``(rid, replica)``: two replicas that served
    the same rid (separate routers sharing one trace dir) never blend
    ranges into a false overlap — the report keys stay plain rids when
    unique and become ``"<rid>@<replica>"`` only on collision.
    """
    plans: dict[str, dict] = {}
    reqs: dict[tuple, dict] = {}
    for r in records:
        if r["k"] == "plan":
            entry = {"layers": r.get("layers", []),
                     "width_map": r.get("width_map")}
            for extra in ("areas", "areas_hi", "exact_area"):
                if r.get(extra) is not None:
                    entry[extra] = r[extra]
            plans.setdefault(r["plan"], entry)
        elif r["k"] in ("range", "done"):
            gkey = (r["rid"], r.get("replica") or "")
            row = reqs.setdefault(gkey, {"ranges": [], "done": None})
            if r["k"] == "range":
                row["ranges"].append(r)
            else:
                row["done"] = r

    rid_groups: dict[int, int] = {}
    for rid, _ in reqs:
        rid_groups[rid] = rid_groups.get(rid, 0) + 1
    out_reqs: dict = {}
    n_done = n_complete = 0
    for gkey in sorted(reqs):
        rid, replica = gkey
        row = reqs[gkey]
        ranges = sorted(row["ranges"], key=lambda r: (r["t0"], r["t1"]))
        done = row["done"]
        drift = [d for r in ranges for d in r.get("drift", ())]
        problems: list[str] = []
        covered = 0
        for r in ranges:
            if r["t0"] < covered:
                problems.append(f"overlap at token {r['t0']}")
            elif r["t0"] > covered:
                problems.append(f"gap at tokens [{covered}, {r['t0']})")
            covered = max(covered, r["t1"])
            if r["plan"] != "exact" and r["plan"] not in plans:
                problems.append(f"plan {r['plan']} has no plan record")
        rep = {
            "cls": (ranges[0]["cls"] if ranges
                    else done["cls"] if done else "?"),
            "ranges": [{
                "t0": r["t0"], "t1": r["t1"], "plan": r["plan"],
                "level": r.get("level"),
                "drift_samples": len(r.get("drift", ())),
            } for r in ranges],
            "tokens_covered": covered,
            "drift_samples": len(drift),
        }
        if replica:
            rep["replica"] = replica
        if drift:
            rep["mean_drift"] = round(sum(drift) / len(drift), 6)
            rep["max_drift"] = round(max(drift), 6)
        if done is not None:
            n_done += 1
            rep["gen_len"] = done["gen_len"]
            rep["steps"] = done["steps"]
            rep["preempts"] = done["preempts"]
            if covered != done["gen_len"]:
                problems.append(
                    f"ranges cover {covered}/{done['gen_len']} tokens")
            if not problems:
                n_complete += 1
        else:
            problems.append("no done record (in flight or crashed)")
        rep["complete"] = done is not None and not [
            p for p in problems if not p.startswith("no done")]
        rep["problems"] = problems
        out_reqs[rid if rid_groups[rid] == 1
                 else f"{rid}@{replica or '?'}"] = rep

    return {
        "plans": plans,
        "requests": out_reqs,
        "n_requests": len(out_reqs),
        "n_done": n_done,
        "n_complete": n_complete,
        "n_failed": n_done - n_complete,
    }
