"""Tensorized population search for the SHARED template, in PyTorch.

Port of ``repro.core.tensor_search``.  A population of candidate
parameter assignments is scored against the *entire* input space in one
evaluation per generation (:func:`repro_torch.kernels.ops.template_eval`:
the hand-written ``template_eval`` kernel on a card, its plain version on
the CPU), then evolved with elitist mutation.  Fitness mirrors the paper's
proxy logic: sound candidates are ranked by an area-proxy score built from
PIT / ITS / literal counts, unsound ones by their ET violation.  The
winners are re-verified exhaustively and synthesized for true area.

Differences from the JAX version: one explicit ``torch.Generator`` on the
device replaces ``jax.random`` keys, so the random numbers differ from
JAX's but a run with ``backend="auto"`` and one with ``backend="ref"``
draw identical ones.  Under a ``mesh``
(:func:`repro_torch.launch.mesh.make_fleet_mesh`) the population is held
on the mesh's first device, where the generator draws; each generation
evaluates one contiguous shard of it on each device and gathers the
fitness back for the argsort, where the reference keeps the population
sharded over ``data``.  The draws are the one generator's either way, so
a run on a mesh equals the meshless run at the same (rounded) population
bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..kernels.ref import word_bits_int32
from .circuits import Circuit, input_truth_tables
from .engine import Candidate, SearchOutcome, harvest
from .templates import IGNORE, SharedTemplate, TemplateParams

__all__ = ["tensor_search", "harvest_population"]

# unsound candidates rank above this; every fitness value is an integer
# below 2**24 (BIG + 100 wce + esum <= 1,090,780 for mul_i8), so float32
# holds it exactly
BIG = 1e6


def _proxy_score(lits: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Area proxy per candidate: ``PIT``-weighted + literal count + max
    sum fan-in, the quantities the paper shows correlate with area."""
    used_prod = (sel > 0).any(dim=1)                      # (P, T)
    lit_cnt = ((lits != IGNORE) & used_prod[:, :, None]).sum((1, 2))
    pit = used_prod.sum(dim=1)
    its = (sel > 0).sum(dim=2).max(dim=1).values
    return 10.0 * pit + 2.0 * lit_cnt + 3.0 * its


def _fitness(lits, sel, wce, esum, et: int) -> torch.Tensor:
    """Float32 fitness per candidate from its ``template_eval`` result:
    the proxy score where sound, ``BIG + 100 wce + esum`` where not."""
    violation = BIG + 100.0 * wce.float() + esum.float()
    return torch.where(wce <= et, _proxy_score(lits, sel), violation)


def harvest_population(tpl: SharedTemplate, lits: torch.Tensor,
                       sel: torch.Tensor, fit: torch.Tensor, *,
                       exact_values: np.ndarray, et: int, keep: int,
                       name: str, t0: float) -> list[Candidate]:
    """Exhaustively re-verify and synthesize the best distinct candidates
    of a scored population, in stable fitness order, until ``keep`` are
    found or the next one is unsound.  :func:`harvest` raises
    :class:`~repro_torch.core.engine.UnsoundResultError` if a netlist
    disagrees with the fitness (a kernel fault).  ``wall_s`` of each
    candidate is counted from ``t0``."""
    order = torch.argsort(fit, stable=True).cpu().numpy()
    fit_np = fit.cpu().numpy()
    lits_np = lits.cpu().numpy()
    sel_np = sel.cpu().numpy()
    results: list[Candidate] = []
    seen: set[bytes] = set()
    for idx in order:
        if len(results) >= keep or float(fit_np[idx]) >= BIG:
            break
        p = TemplateParams(lits_np[idx].astype(np.int8), sel_np[idx].astype(bool))
        fingerprint = p.lits.tobytes() + p.sel.tobytes()
        if fingerprint in seen:
            continue
        seen.add(fingerprint)
        results.append(harvest(tpl, p, exact_values, et, engine="tensor",
                               name=name, wall_s=time.time() - t0,
                               meta={"fitness": float(fit_np[idx])}))
    return results


def tensor_search(
    exact: Circuit,
    et: int,
    *,
    pit: int | None = None,
    population: int = 4096,
    generations: int = 60,
    elites: int = 64,
    seed: int = 0,
    keep: int = 16,
    seeds: list[TemplateParams] | None = None,
    wall_budget_s: float | None = None,
    device: str | torch.device = "cuda",
    backend: ops.Backend = "auto",
    mesh=None,
) -> SearchOutcome:
    """Evolve shared-template parameters toward minimal-area sound circuits.

    ``seeds``: optional known-good parameter assignments injected into the
    initial population, each tiled over a slab of it.  ``device``: where
    the population lives (``"cuda"`` unless the caller asks for
    ``"cpu"``); ``backend``: passed to ``ops.template_eval``.  The kernel
    is launched once per generation and once at harvest, on each device of
    the mesh.  ``mesh``: a :class:`~repro_torch.launch.mesh.FleetMesh`
    whose devices take the place of ``device``; ``population`` is rounded
    up to a multiple of its ``data`` extent, as the reference rounds it.
    A run cut by ``wall_budget_s`` is not reproducible; one that the
    generation count ends is.
    """
    if mesh is not None:
        devices = list(mesh.devices)
        # population must tile evenly over the data axis; round up
        population += (-population) % mesh.shape["data"]
    else:
        devices = [resolve_device(device)]
    dev = devices[0]
    n, m = exact.n_inputs, exact.n_outputs
    T = pit if pit is not None else 2 * m
    tpl = SharedTemplate(n, m, pit=T)
    # the packed words as int32 with the same bits, once a device: both
    # the kernel and the plain version take them so
    in_tt = word_bits_int32(torch.from_numpy(input_truth_tables(n)))
    exact_vals = torch.from_numpy(exact.eval_words().astype(np.int32))
    tables = [(in_tt.to(d), exact_vals.to(d)) for d in devices]
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.time()

    def shards(x):
        return [c.to(d) for c, d in zip(x.tensor_split(len(devices)), devices)]

    def fitness(lits, sel):
        fits = [_fitness(lp, sp, *ops.template_eval(lp, sp, tt, ev, backend=backend), et)
                for lp, sp, (tt, ev) in zip(shards(lits), shards(sel), tables)]
        # the only step across shards: the fitness gathered for the argsort
        return fits[0] if len(fits) == 1 else torch.cat([f.to(dev) for f in fits])

    def rand(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def randint(high, shape):
        return torch.randint(0, high, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def step(lits, sel):
        fit = fitness(lits, sel)
        best = torch.argsort(fit, stable=True)[:elites]
        elite_lits, elite_sel = lits[best], sel[best]
        # children: mutate random elites
        parent = randint(elites, (population - elites,)).long()
        c_lits, c_sel = elite_lits[parent], elite_sel[parent]
        mut_l = rand(c_lits.shape) < 0.04
        c_lits = torch.where(mut_l, randint(3, c_lits.shape), c_lits)
        mut_s = rand(c_sel.shape) < 0.04
        c_sel = torch.where(mut_s, 1 - c_sel, c_sel)
        return torch.cat([elite_lits, c_lits]), torch.cat([elite_sel, c_sel])

    # init population: IGNORE-biased literals (small products are the
    # useful building blocks) and sparse selection (low starting proxies)
    u = rand((population, T, n))
    lits = torch.where(u < 0.25, 0, torch.where(u < 0.5, 1, 2)).to(torch.int32)
    sel = (rand((population, m, T)) < 0.3).to(torch.int32)
    if seeds:
        # tile each seed over a slab of the population (mutation diversifies)
        slab = max(1, population // (4 * len(seeds)))
        row = 0
        for sp in seeds:
            s_lits = np.full((T, n), IGNORE, dtype=np.int32)
            s_sel = np.zeros((m, T), dtype=np.int32)
            t_src = min(sp.lits.shape[0], T)
            s_lits[:t_src] = sp.lits[:t_src]
            s_sel[:, :t_src] = sp.sel[:, :t_src]
            end = min(population, row + slab)
            lits[row:end] = torch.from_numpy(s_lits).to(dev)
            sel[row:end] = torch.from_numpy(s_sel).to(dev)
            row = end

    outcome = SearchOutcome(engine="tensor", benchmark=exact.name, et=et,
                            stats={"generations": 0, "evaluations": 0})
    for _ in range(generations):
        if wall_budget_s is not None and time.time() - t0 > wall_budget_s:
            break
        lits, sel = step(lits, sel)
        outcome.stats["generations"] += 1
        outcome.stats["evaluations"] += population

    fit = fitness(lits, sel)
    outcome.results = harvest_population(
        tpl, lits, sel, fit, exact_values=exact.eval_words(), et=et,
        keep=keep, name=f"{exact.name}_tensor", t0=t0)
    outcome.wall_s = time.time() - t0
    return outcome
