"""Fleet workers: run :class:`SearchJob`\\ s, commit results to one store.

Own copy of ``repro.fleet.worker``.  Execution model (see the package
docstring): the CPU-bound engines (anneal, muscat, mecals) are host numpy,
so they fan out over a ``multiprocessing`` pool whose workers never touch
CUDA; ``tensor`` jobs stay in the parent process, on the card it was
given -- CUDA cannot be used in a process forked after it started.  Where
more than one card is visible, they run on a fleet mesh of all of them
(:func:`repro_torch.launch.mesh.make_fleet_mesh`), their population split
over its ``data`` axis, as the reference's worker does.

Every finished job writes a receipt under ``<library>/_fleet/`` keyed by
:meth:`SearchJob.key` plus a digest of its engine options (the same name
and content as the reference's for the same job and options); a later run
of the same sweep skips receipted jobs (status ``ok``) entirely, which
together with the store's content-addressing makes resume a no-op -- while
a sweep with *changed* engine options re-executes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import time
import traceback
from dataclasses import dataclass, field
from functools import partial
from pathlib import Path

import torch

from ..core.engine import SearchJob, available_engines, get_engine
from ..library.store import OperatorStore, atomic_write_json
from ..obs.export import dump_metrics
from ..obs.metrics import get_registry
from ..obs.trace import current_tracer
from ..obs.trace import span as trace_span

__all__ = ["JobResult", "run_job", "run_sweep", "flag_outlier_jobs",
           "RECEIPT_DIR"]

RECEIPT_DIR = "_fleet"   # skipped by OperatorStore.signatures() (not a signature)


@dataclass
class JobResult:
    """What one job did — enough for the CLI's run table."""

    job: SearchJob
    status: str               # "ok" | "skipped" | "failed"
    n_results: int = 0
    wall_s: float = 0.0
    engine_s: float = 0.0     # pure engine time (no receipt/commit IO)
    error: str | None = None
    stats: dict = field(default_factory=dict)   # engine stats (ok jobs)


def _flush_worker_obs() -> None:
    """Snapshot this process's metrics into the trace dir (if tracing).

    Pool workers call this at the end of every job: the snapshot file is
    per-process and atomically replaced, so repeated flushes just widen
    that worker's cumulative view and the parent's read-time merge sees
    whatever each worker last completed — crash included.
    """
    tracer = current_tracer()
    if tracer is not None:
        dump_metrics(tracer.root, get_registry())


def _receipt_path(library_root: str | os.PathLike, job: SearchJob,
                  opts: dict) -> Path:
    """Receipt file for (job, engine options).

    The options digest is part of the name: re-running a sweep with
    changed ``engine_opts`` (more generations, deeper annealing) must
    re-execute the job, not silently skip it on the old receipt.
    """
    opts_key = hashlib.sha256(
        json.dumps(opts, sort_keys=True).encode()
    ).hexdigest()[:8]
    return Path(library_root) / RECEIPT_DIR / f"{job.key()}-{opts_key}.json"


def run_job(job: SearchJob, library_root: str | os.PathLike,
            engine_opts: dict | None = None,
            device: str | torch.device | None = None, mesh=None) -> JobResult:
    """Run one job and commit every sound candidate into the shared store.

    ``device``: where a ``tensor`` job runs (the tensor engine's own
    default, the card, when ``None``); ``mesh``: a fleet mesh whose
    devices it runs on instead.  Both are runtime wiring, as the
    reference's mesh: they go to the engine's constructor, never into the
    options a receipt records.  Top-level (picklable) so a
    multiprocessing pool can map over it.
    """
    t0 = time.time()
    opts = dict((engine_opts or {}).get(job.engine, {}))
    receipt = _receipt_path(library_root, job, opts)
    if receipt.is_file():
        try:
            prior = json.loads(receipt.read_text())
        except json.JSONDecodeError:
            prior = {}
        if prior.get("status") == "ok":   # failed jobs are retried
            return JobResult(job, "skipped",
                             n_results=int(prior.get("n_results", 0)))

    ctor_opts = dict(opts)
    if job.engine == "tensor" and device is not None:
        ctor_opts["device"] = device
    if job.engine == "tensor" and mesh is not None:
        ctor_opts["mesh"] = mesh
    store = OperatorStore(library_root)
    reg = get_registry()
    with trace_span("fleet.job", engine=job.engine,
                    benchmark=job.benchmark_name, et=job.et,
                    metric=job.error_metric, seed=job.seed,
                    key=job.key()) as sp:
        try:
            t_eng = time.time()
            outcome = get_engine(job.engine, **ctor_opts).run(job)
            engine_s = time.time() - t_eng
            sig = job.signature()
            t_commit = time.time()
            for cand in outcome.results:
                store.put_circuit(
                    cand.circuit, sig, area=cand.area, source=job.engine,
                    proxies=cand.proxies, params=cand.params,
                    meta={**cand.meta, "wall_s": cand.wall_s,
                          "job": job.key()},
                )
            commit_s = time.time() - t_commit
        except Exception as exc:
            sp.set(status="failed", error=f"{type(exc).__name__}: {exc}")
            reg.counter("fleet_jobs_total", engine=job.engine,
                        status="failed").inc()
            atomic_write_json(receipt, {
                "status": "failed",
                "job": dataclasses.asdict(job),
                "engine_opts": opts,
                "error": f"{type(exc).__name__}: {exc}",
                "traceback": traceback.format_exc(limit=8),
                "wall_s": round(time.time() - t0, 3),
            })
            _flush_worker_obs()
            return JobResult(job, "failed", wall_s=time.time() - t0,
                             error=f"{type(exc).__name__}: {exc}")
        sp.set(status="ok", n_results=len(outcome.results),
               engine_s=round(engine_s, 4), commit_s=round(commit_s, 4))

    reg.counter("fleet_jobs_total", engine=job.engine, status="ok").inc()
    reg.histogram("fleet_job_s", engine=job.engine).observe(time.time() - t0)
    atomic_write_json(receipt, {
        "status": "ok",
        "job": dataclasses.asdict(job),
        "engine_opts": opts,
        "n_results": len(outcome.results),
        "stats": outcome.stats,
        "engine_s": round(engine_s, 4),
        "commit_s": round(commit_s, 4),
        "wall_s": round(time.time() - t0, 3),
    })
    _flush_worker_obs()
    return JobResult(job, "ok", n_results=len(outcome.results),
                     wall_s=time.time() - t0, engine_s=engine_s,
                     stats=dict(outcome.stats))


def flag_outlier_jobs(results: list[JobResult], *, threshold: float = 4.0,
                      min_group: int = 4) -> list[tuple[JobResult, float]]:
    """Flag jobs whose engine wall-time is a robust-z outlier among the
    ``ok`` jobs sharing their (engine, signature) group — the fleet-side
    consumer of the health plane's detector math.  Groups smaller than
    ``min_group`` are skipped (median/MAD over 2–3 samples flags noise,
    not outliers).  Flagged jobs are counted
    (``fleet_job_outliers_total{engine}``) and traced (``fleet.outlier``),
    and returned with their z-scores."""
    from ..obs.anomaly import robust_zscores
    from ..obs.trace import event as trace_event

    groups: dict[tuple, list[JobResult]] = {}
    for r in results:
        if r.status != "ok" or r.engine_s <= 0:
            continue
        key = (r.job.engine, r.job.benchmark, r.job.bits,
               r.job.error_metric, r.job.et)
        groups.setdefault(key, []).append(r)
    reg = get_registry()
    flagged: list[tuple[JobResult, float]] = []
    for rs in groups.values():
        if len(rs) < min_group:
            continue
        for r, z in zip(rs, robust_zscores([x.engine_s for x in rs])):
            if abs(z) < threshold:
                continue
            flagged.append((r, z))
            reg.counter("fleet_job_outliers_total",
                        engine=r.job.engine).inc()
            trace_event("fleet.outlier", key=r.job.key(),
                        engine=r.job.engine,
                        engine_s=round(r.engine_s, 4), zscore=round(z, 2))
    return flagged


def pool_method() -> str:
    """How the CPU engines' pool starts its workers: ``fork`` while this
    process has not initialised CUDA, ``spawn`` once it has (a forked
    child cannot use, or safely inherit, a CUDA context)."""
    return "spawn" if torch.cuda.is_initialized() else "fork"


def run_sweep(spec, library_root: str | os.PathLike, *,
              workers: int | None = None,
              device: str | torch.device | None = None,
              log=print) -> list[JobResult]:
    """Plan ``spec``, run every job, return per-job results.

    ``workers``: pool size for the CPU engines (0/1 = run everything
    sequentially in-process — deterministic, used by tests).  ``device``:
    where the tensor jobs run, in this process; without one they run on a
    fleet mesh of every card where more than one is visible, as the
    reference's do where ``jax.device_count() > 1``.  Engines the port
    cannot run (the SMT pair, which needs z3) are dropped with a notice.
    """
    from .plan import plan_jobs

    jobs = plan_jobs(spec)
    runnable = set(available_engines())
    dropped = {j for j in jobs if j.engine not in runnable}
    if dropped:
        log(f"fleet: skipping {len(dropped)} job(s) on unavailable engines "
            f"{sorted({j.engine for j in dropped})} (z3 missing?)")
    tensor_jobs = [j for j in jobs if j.engine == "tensor" and j not in dropped]
    cpu_jobs = [j for j in jobs if j.engine != "tensor" and j not in dropped]

    results: list[JobResult] = []
    worker = partial(run_job, library_root=str(library_root),
                     engine_opts=spec.engine_opts)
    if workers and workers > 1 and len(cpu_jobs) > 1:
        method = pool_method()
        n = min(workers, len(cpu_jobs))
        log(f"fleet: {len(cpu_jobs)} CPU job(s) on a {method} pool of "
            f"{n} worker(s)")
        with multiprocessing.get_context(method).Pool(n) as pool:
            results.extend(pool.map(worker, cpu_jobs))
    else:
        results.extend(worker(j) for j in cpu_jobs)

    mesh = None
    if tensor_jobs and device is None and torch.cuda.device_count() > 1:
        from ..launch.mesh import make_fleet_mesh

        mesh = make_fleet_mesh()
    for j in tensor_jobs:
        results.append(run_job(j, library_root, engine_opts=spec.engine_opts,
                               device=device, mesh=mesh))

    for r in results:
        log(f"  {r.job.describe():58s} {r.status:8s} "
            f"{r.n_results:3d} result(s) {r.wall_s:6.1f}s"
            + (f"  {r.error}" if r.error else ""))
    return results
