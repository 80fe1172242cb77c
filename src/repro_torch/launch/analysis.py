"""Roofline terms of a step, and the reports the launchers print.

The roofline half is the counterpart of ``repro.launch.analysis``.  The
reference reads per-device FLOPs and bytes from XLA's ``cost_analysis``
and parses the collectives out of the optimized HLO text.  The port has
no XLA text, so ``_DTYPE_BYTES``, ``_shape_bytes``, ``_group_size`` and the
``collective_stats(hlo_text)`` parser have no counterpart: a
:class:`CostCounter` (a ``TorchDispatchMode``) counts the ops a step
dispatches instead, per device:

- FLOPs, by torch's flop formulas (matmuls, batched matmuls and
  convolutions; elementwise ops count none), at each op's local shapes;
- bytes accessed, each op's operand and result bytes summed as XLA's
  ``bytes accessed`` sums them (views move none);
- one :class:`CollectiveStats` entry per collective, at its local payload
  and the size of the group it runs over; an all-to-all that DTensor
  asks for counts as one, though a CPU group runs it as a gather;
- the peak of the local bytes the ops allocate and hold at once
  (:meth:`CostCounter.temp_bytes`), the counterpart of XLA's
  ``temp_size_in_bytes``: each new storage an op returns counts from that
  op until the storage dies.

Under DTensor the counter sees the local ops each rank runs, so the counts
are per device, as the reference's SPMD counts are.  The kernels report
their own work at the operations and bytes their bounds use
(:mod:`repro_torch.kernels.ops`), on the kernel route and the plain route
alike; attention's forward is priced at the (query, key) pairs its mask
leaves, and its backward, which no kernel runs, at the plain route's ops.

Terms (per step and device -> seconds, against one H100's data-sheet
peaks in :mod:`repro_torch.launch.mesh`, not measurements):

    compute    = FLOPs / PEAK_FLOPS_BF16
    memory     = bytes / HBM_BW
    collective = wire_bytes / LINK_BW
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from ..kernels import ops
from . import mesh as hw

__all__ = ["CollectiveStats", "CostCounter", "Roofline", "analyze",
           "model_flops_decode", "model_flops_train", "plan_report",
           "sensitivity_report"]


# ring-algorithm wire factors: bytes on the wire per participant,
# as a multiple of the (per-shard input / full output) payload.
def _wire_bytes(op: str, out_bytes: int, group: int) -> float:
    if op == "collective-permute":  # uses source_target_pairs, not groups
        return float(out_bytes)
    if group <= 1:
        return 0.0
    f = (group - 1) / group
    if op == "all-gather":
        return f * out_bytes                 # output is the gathered buffer
    if op == "all-reduce":
        return 2.0 * f * out_bytes           # reduce-scatter + all-gather
    if op == "reduce-scatter":
        return f * out_bytes * group         # output is the scattered shard
    if op == "all-to-all":
        return f * out_bytes
    return 0.0


@dataclass
class CollectiveStats:
    counts: dict[str, int] = field(default_factory=dict)
    payload_bytes: dict[str, float] = field(default_factory=dict)
    wire_bytes_total: float = 0.0

    def add(self, op: str, payload: int, wire: float) -> None:
        self.counts[op] = self.counts.get(op, 0) + 1
        self.payload_bytes[op] = self.payload_bytes.get(op, 0.0) + payload
        self.wire_bytes_total += wire


# the functional collectives DTensor issues -> the reference's op names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


# DTensor's sharding-propagation methods, on its op dispatcher and its
# sharding propagator, whichever of them a version of torch has
_PROPAGATION = ("_propagate_op_sharding_dispatch_slow_path", "propagate",
                "propagate_op_sharding_non_cached", "_propagate_tensor_meta_non_cached")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class CostCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes accessed and collectives of the ops run
    under it (module docstring).  ``log_ops`` keeps one line a counted op,
    the counterpart of the reference's saved HLO."""

    def __init__(self, *, log_ops: bool = False):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = CollectiveStats()
        self.log: list[str] | None = [] if log_ops else None
        self.memory = _LiveBytes()
        self._hidden = 0       # > 0: ops are not counted (a kernel's scope)
        self._quiet = 0        # > 0: neither ops nor collectives are
        self._saved = None

    def __enter__(self):
        from torch.distributed.tensor import DTensor, placement_types

        self._saved = (ops.COUNTER, placement_types.shard_dim_alltoall)
        ops.COUNTER = self
        placement_types.shard_dim_alltoall = self._alltoall(self._saved[1])
        # DTensor's sharding propagation is work no device does: it runs
        # each new op once on global-shape fake tensors to learn its
        # output's metadata, and an op it decomposes on a fake mesh that it
        # builds once a process, so that the cell counted first in a
        # process would count ops the later ones do not.  Each entry point
        # that this version of torch has is hidden
        self._patched = []
        for obj in (DTensor._op_dispatcher, DTensor._op_dispatcher.sharding_propagator):
            for name in _PROPAGATION:
                fn = getattr(type(obj), name, None)
                if fn is not None:
                    setattr(obj, name, self._hide(fn.__get__(obj)))
                    self._patched.append((obj, name))
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor import placement_types

        ops.COUNTER, placement_types.shard_dim_alltoall = self._saved
        for obj, name in self._patched:
            delattr(obj, name)
        self.memory.close()
        return super().__exit__(*exc)

    def _hide(self, inner):
        def hidden(*args, **kwargs):
            self._quiet += 1
            try:
                return inner(*args, **kwargs)
            finally:
                self._quiet -= 1
        return hidden

    def _alltoall(self, inner):
        """DTensor's shard-to-shard redistribution, counted as the
        all-to-all it asks for (a CPU group runs a gather and a chunk)."""
        hidden = self._hide(inner)

        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            if not self._quiet:
                self._collective("all-to-all", _nbytes(input), mesh.size(mesh_dim))
            return hidden(input, gather_dim, shard_dim, mesh, mesh_dim)
        return alltoall

    def _collective(self, op: str, payload: int, group: int) -> None:
        self.collectives.add(op, payload, _wire_bytes(op, payload, group))
        if self.log is not None:
            self.log.append(f"{op} payload={payload} group={group}")

    def temp_bytes(self, outputs=()) -> int:
        """The peak of the local bytes held at once by storages that the
        counted ops allocated, less those of
        ``outputs``: arguments are never counted, and outputs are the
        record's ``output_size_in_bytes``.  A DTensor counts its local
        shard only, as the counter sees only local ops."""
        return self.memory.peak(outputs)

    def kernel(self, work, like=None):
        """A scope that adds one kernel call's work, ``work()`` -> (FLOPs,
        bytes), scaled to this device's share of ``like`` when it is a
        DTensor, and hides the aten ops inside it (``work``'s own too; a
        nested scope adds nothing).  Collectives inside it still count."""
        return _KernelScope(self, work, like)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor then runs its local ops and collectives, which come
            # back here with plain tensors
            return NotImplemented
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        if not self._quiet:
            self.memory.allocated((args, kwargs), out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns = packet._qualified_op_name.split("::")[0]
        if ns == "_c10d_functional":
            op = _COLLECTIVES.get(packet.__name__)
            if op is not None and not self._quiet:
                from torch.distributed.distributed_c10d import _resolve_process_group

                group = _resolve_process_group(args[-1]).size()
                self._collective(op, _nbytes(out), group)
            return
        if self._hidden or self._quiet or func.is_view:
            return
        fn = flop_registry.get(packet)
        flops = float(fn(*args, **kwargs, out_val=out)) if fn is not None else 0.0
        nbytes = sum(_nbytes(t) for t in tree_leaves((args, kwargs, out)))
        self.flops += flops
        self.bytes += nbytes
        if self.log is not None:
            shapes = [tuple(t.shape) for t in tree_leaves(args)
                      if isinstance(t, torch.Tensor)]
            self.log.append(f"{func} flops={flops:.0f} bytes={nbytes} {shapes}")


class _LiveBytes:
    """The storages that ops return new, each live from that op until it
    dies: torch keeps one Python object for a storage while it lives, so
    ``weakref.finalize`` on it marks its end.  Views and in-place results
    share an operand's storage and add nothing.  A timeline of (storage,
    +/- bytes) events gives the peak with any storages left out.
    :meth:`close` ends the timeline: a storage that dies later frees
    nothing here, and nothing of this object outlives it."""

    def __init__(self):
        self.live: dict[int, int] = {}            # id(storage) -> its event
        self.events: list[tuple[int, int]] = []    # (first event, bytes)
        self._finalizers: list[weakref.finalize] = []

    def allocated(self, operands, out) -> None:
        have = {id(t.untyped_storage()) for t in tree_leaves(operands)
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            key = id(s)
            if key in have or key in self.live:
                continue
            tok, n = len(self.events), s.nbytes()
            self.live[key] = tok
            self.events.append((tok, n))
            self._finalizers.append(weakref.finalize(s, self._freed, key, tok, n))

    def close(self) -> None:
        for f in self._finalizers:
            f.detach()
        self._finalizers.clear()

    def _freed(self, key: int, tok: int, n: int) -> None:
        if self.live.get(key) == tok:
            del self.live[key]
        self.events.append((tok, -n))

    def peak(self, outputs=()) -> int:
        from torch.distributed.tensor import DTensor

        skip = set()
        for t in tree_leaves(outputs):
            if isinstance(t, torch.Tensor):
                t = t.to_local() if isinstance(t, DTensor) else t
                skip.add(self.live.get(id(t.untyped_storage())))
        cur = top = 0
        for tok, n in self.events:
            if tok not in skip:
                cur += n
                top = max(top, cur)
        return top


class _KernelScope:
    def __init__(self, counter: CostCounter, work, like):
        self.counter, self.work, self.like = counter, work, like

    def __enter__(self):
        c = self.counter
        c._hidden += 1
        if c._hidden == 1 and not c._quiet:
            flops, nbytes = self.work()
            share = _local_share(self.like)
            c.flops += flops * share
            c.bytes += nbytes * share
            if c.log is not None:
                c.log.append(f"kernel flops={flops * share:.0f} "
                             f"bytes={nbytes * share:.0f}")

    def __exit__(self, *exc):
        self.counter._hidden -= 1


def _local_share(x) -> float:
    """This device's share of the work on ``x``: its local elements over
    the global ones (1 for a plain tensor)."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor) and x.numel():
        return x.to_local().numel() / x.numel()
    return 1.0


@dataclass
class Roofline:
    """All counted quantities are PER DEVICE (the counter sees each rank's
    local ops); ``model_flops`` is the GLOBAL analytic 6·N·D / 2·N·D."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float        # per device (counted ops; the reference's name)
    hlo_bytes: float        # per device
    wire_bytes: float       # per device (ring wire bytes)
    model_flops: float      # global
    bytes_per_device: float | None
    collectives: dict[str, int]
    model_bytes: float = 0.0  # global minimum HBM traffic (decode: weights+cache)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / hw.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / hw.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / hw.LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total_hlo = self.hlo_flops * self.chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def t_star(self) -> float:
        """Ideal step time: useful FLOPs at peak, or (for bandwidth-bound
        steps like decode) the unavoidable HBM traffic at full bandwidth —
        whichever bound is tighter."""
        return max(
            self.model_flops / (self.chips * hw.PEAK_FLOPS_BF16),
            self.model_bytes / (self.chips * hw.HBM_BW),
        )

    @property
    def t_step(self) -> float:
        """The modelled step: the largest term (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """ideal step time / modelled step time."""
        return self.t_star / self.t_step if self.t_step else 0.0

    def as_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes, "wire_bytes": self.wire_bytes,
            "model_flops": self.model_flops,
            "bytes_per_device": self.bytes_per_device,
            "model_bytes": self.model_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective, "t_star": self.t_star,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives,
        }


def local_bytes(tree) -> int:
    """Bytes of every tensor of ``tree`` on this device (a DTensor's local
    shard)."""
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in tree_leaves(tree))


def analyze(fn, *args, arch: str, shape: str, mesh_name: str, chips: int,
            model_flops: float, model_bytes: float = 0.0) -> Roofline:
    """Run ``fn(*args)`` once under a :class:`CostCounter`, on whatever
    device the arguments lie on, and price it.  ``bytes_per_device`` is
    the arguments' local bytes."""
    with CostCounter() as c:
        fn(*args)
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=c.flops, hlo_bytes=c.bytes,
        wire_bytes=c.collectives.wire_bytes_total, model_flops=model_flops,
        bytes_per_device=float(local_bytes(args)),
        collectives=dict(c.collectives.counts), model_bytes=model_bytes)


# ---------------------------------------------------------------------------
# QoS layer-plan reporting: which approximate operator each layer runs on
# ---------------------------------------------------------------------------
def plan_report(plan) -> str:
    """Human-readable per-layer operator table for a QoS
    :class:`~repro_torch.library.qos.LayerPlan` -- operator key, area vs
    the exact baseline, compiled-table error, and the plan-level totals."""
    lines = [
        f"{'layer':>5s}  {'operator':<18s} {'area µm²':>9s} {'Δarea':>7s} "
        f"{'pred.drift':>10s}"
    ]
    for c in plan.choices:
        name = c.key if c.key is not None else "exact"
        saving = 1.0 - c.area / plan.exact_area if plan.exact_area else 0.0
        lines.append(
            f"{c.layer:>5d}  {name:<18s} {c.area:>9.3f} {100 * saving:>6.1f}% "
            f"{c.predicted_drift:>10.5f}"
        )
    lines.append(
        f"total area {plan.total_area:.3f} µm² vs exact "
        f"{plan.exact_total_area:.3f} µm² "
        f"({100 * plan.area_saving:.1f}% saving), predicted drift "
        f"{plan.predicted_total:.5f} <= budget {plan.budget:.5f}"
    )
    return "\n".join(lines)


def sensitivity_report(profile) -> str:
    """Human-readable measured per-layer sensitivity table for a
    :class:`~repro_torch.sensitivity.profile.SensitivityProfile` -- one
    column per profiled serving width (drift per unit compiled-table mae),
    printed next to the per-layer operator table so a plan can be read
    against the measurements that priced it."""
    widths = profile.widths
    head = f"{'layer':>5s}"
    for b in widths:
        head += f"  {'w' + str(b) + ' drift/mae':>14s}"
    lines = [f"measured sensitivities: {profile.model} "
             f"({profile.n_layers} layers)", head]
    sens = {b: profile.sensitivities(b) for b in widths}
    for l in range(profile.n_layers):
        row = f"{l:>5d}"
        for b in widths:
            row += f"  {sens[b][l]:>14.5f}"
        lines.append(row)
    for b in widths:
        hot = int(sens[b].argmax())
        lines.append(
            f"w{b}: most sensitive layer {hot} "
            f"({sens[b][hot]:.5f}), least {int(sens[b].argmin())} "
            f"({sens[b].min():.5f})"
            + (f", measured cost matrix over "
               f"{len(profile.costs[b][0])} operator(s)"
               if b in profile.costs else "")
        )
    return "\n".join(lines)


def model_flops_train(n_active_params: int, tokens: int) -> float:
    return 6.0 * n_active_params * tokens


def model_flops_decode(n_active_params: int, tokens: int) -> float:
    return 2.0 * n_active_params * tokens
