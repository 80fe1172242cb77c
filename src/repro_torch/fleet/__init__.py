"""Distributed operator-library filling: plan → workers → one shared store.

Own copy of ``repro.fleet``.  The searches in :mod:`repro_torch.core`
each find operators one benchmark at a time; the library
(:mod:`repro_torch.library`) only pays off when its frontier is *dense*
across benchmarks, bit widths and error thresholds.  This package runs
that densification as a fleet:

* :mod:`repro_torch.fleet.plan` — expands a **sweep spec** into a
  deterministic list of :class:`~repro_torch.core.engine.SearchJob`\\ s
  (the cross product benchmarks × bits × ET grid × engines, with per-job
  seeds derived stably from the spec seed; the same jobs as the
  reference's).
* :mod:`repro_torch.fleet.worker` — runs jobs against the engine registry
  and commits every sound :class:`~repro_torch.core.engine.Candidate`
  into one shared :class:`~repro_torch.library.OperatorStore`.  CPU
  engines (anneal / rewrite) fan out over a multiprocessing pool (forked
  while this process has not initialised CUDA, spawned once it has); the
  ``tensor`` engine runs in-process on one card, its population and the
  ``template_eval`` kernel there.
* ``python -m repro_torch.fleet`` — the CLI; prints an end-of-run
  frontier-densification report (operators added, per-signature record
  and frontier counts before/after).

Resume is free twice over: the store is content-addressed (re-finding a
netlist is a no-op ``put``), and each completed job leaves a receipt
under ``<library>/_fleet/<job-key>.json`` that later runs skip.

Sweep-spec format
-----------------
``--sweep`` takes a named preset (``smoke``, ``8bit``, ``nightly``) or a
path to a JSON file::

    {
      "name": "my-sweep",
      "benchmarks": ["mul", "adder"],        // operator kinds
      "bits": [2, 3, 4],                     // operand bit widths
      "ets": [1, 2, 4],                      // absolute thresholds, and/or
      "et_fracs": [0.0625, 0.25],            // fractions of the max exact
                                             //   output value (per kind/bits)
      "engines": ["shared", "tensor", "anneal"],
      "budget_s": 60.0,                      // wall budget per job
      "seed": 0,                             // base seed; job seeds derive
      "engine_opts": {                       // engine constructor knobs
        "tensor": {"population": 1024, "generations": 40},
        "anneal": {"steps": 4000, "restarts": 3}
      }
    }

Every field except ``benchmarks`` / ``bits`` / ``engines`` and one of
``ets`` / ``et_fracs`` is optional.  Engines the port cannot run (the
SMT pair, which needs z3) are skipped with a notice rather than failing
the sweep.

Example::

    python -m repro_torch.fleet --library runs/lib --sweep smoke
    python -m repro_torch.fleet --library runs/lib --sweep 8bit --device cpu
"""

from .plan import SWEEPS, SweepSpec, load_spec, plan_jobs
from .worker import JobResult, run_job, run_sweep

__all__ = [
    "SweepSpec",
    "SWEEPS",
    "load_spec",
    "plan_jobs",
    "JobResult",
    "run_job",
    "run_sweep",
]
