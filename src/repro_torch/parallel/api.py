"""Logical-axis sharding: the one place mesh layout decisions live.

Own copy of ``repro.parallel.api``.  Model code annotates tensors with
*logical* axis names (``'batch'``, ``'model'``, ``'fsdp'``, ...).  A
:class:`ShardingContext` resolves those to mesh axes under the active
mesh, with a divisibility guard: a logical axis whose dimension does not
divide by its mesh extent falls back to replication instead of producing
uneven shards (e.g. whisper's 51,865 vocab).  Outside any context every
annotation is a no-op, so the same model code runs single-device tests
and the 512-rank dry-run unchanged.

The mesh is anything with axis names and a per-axis extent: a
:class:`torch.distributed.device_mesh.DeviceMesh` (its ``mesh_dim_names``
and ``shape``), or a stand-in with ``axis_names`` and a ``shape`` dict.
Where GSPMD turns a sharding constraint into collectives, :func:`shard`
redistributes a :class:`~torch.distributed.tensor.DTensor` to the resolved
placements, so DTensor inserts the same collectives.  DTensors are laid
out under a context: outside one, every helper here takes the plain path
at once, before it imports anything.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any

import torch

# logical axis -> preferred mesh axes (in priority order; filtered by mesh)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),        # data parallel (pod is outer DP)
    "fsdp": ("data",),               # weight/optimizer-state sharding
    "model": ("model",),             # tensor parallel
    "expert": ("data",),             # expert parallelism (MoE dispatch)
    "expert_fsdp": ("data",),        # expert-stack weight sharding
    "cache_seq": ("data",),          # context-parallel long KV caches
}


class P(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (replicated),
    one mesh axis name, or a tuple of names (the dim sharded over each,
    outer first) -- the entries of ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P" + super().__repr__()


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: extent}`` of a DeviceMesh or a stand-in mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def axis_extent(name: str) -> int:
    """Mesh extent a logical axis would shard over (1 outside a context)."""
    ctx = current()
    if ctx is None:
        return 1
    axes = mesh_axes(ctx.mesh)
    extent = 1
    for a in ctx.rules.get(name, ()):
        extent *= axes.get(a, 1)
    return extent


@dataclass(frozen=True)
class ShardingContext:
    mesh: Any
    rules: dict[str, tuple[str, ...]] = field(default_factory=lambda: dict(DEFAULT_RULES))

    def resolve(self, shape: tuple[int, ...], axes: tuple[str | None, ...]) -> P:
        """Logical names -> :class:`P` with divisibility fallback."""
        assert len(shape) == len(axes), (shape, axes)
        have = mesh_axes(self.mesh)
        parts: list = []
        for dim, name in zip(shape, axes):
            if name is None:
                parts.append(None)
                continue
            mesh_axes_ = tuple(a for a in self.rules.get(name, ()) if a in have)
            extent = 1
            for a in mesh_axes_:
                extent *= have[a]
            if not mesh_axes_ or extent <= 1 or dim % extent != 0:
                parts.append(None)  # replicate rather than shard unevenly
            else:
                parts.append(mesh_axes_ if len(mesh_axes_) > 1 else mesh_axes_[0])
        return P(*parts)


# process-wide, not per thread as the reference's: the autograd engine
# runs a backward (and a checkpointed layer's recomputation) on threads
# of its own, which must see the same mesh
_ctx: ShardingContext | None = None


def current() -> ShardingContext | None:
    return _ctx


@contextmanager
def activate(mesh, rules: dict[str, tuple[str, ...]] | None = None):
    global _ctx
    prev = _ctx
    _ctx = ShardingContext(mesh, {**DEFAULT_RULES, **(rules or {})})
    try:
        yield _ctx
    finally:
        _ctx = prev


def placements(spec: P, mesh) -> list:
    """A :class:`P` as DTensor placements on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim ``d`` names, ``Replicate()`` on the others.
    A dim over several mesh axes (``("pod", "data")``) is sharded by each,
    in mesh order, which must be the order the spec names them."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: mesh axes {group} out of mesh order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} named twice")
            out[i] = Shard(d)
    return out


def shard(x, *axes: str | None):
    """Annotate ``x`` with logical axes; no-op outside a context.

    Under a context a DTensor is redistributed to the resolved placements
    (DTensor issues the collectives GSPMD would).  A plain tensor counts
    as replicated, as under ``implicit_replication``: it is returned as it
    is when the spec replicates every dim, else made a replicated DTensor
    and redistributed."""
    ctx = current()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate

    spec = ctx.resolve(tuple(x.shape), axes)
    if not isinstance(x, DTensor):
        if all(s is None for s in spec):
            return x
        x = DTensor.from_local(x, ctx.mesh, [Replicate()] * ctx.mesh.ndim,
                               run_check=False)
    return _Constraint.apply(x, ctx.mesh, tuple(placements(spec, ctx.mesh)))


def reshard(x, *axes: str | None):
    """:func:`shard` for the value only: its gradient comes back in the
    layout ``x`` had (DTensor's own ``redistribute``), where ``shard``
    constrains the gradient as the value.  For a gather that only a
    reshape needs: a product whose output was sharded then takes its
    gradient's local slice, where a replicated gradient would repeat that
    product's weight gradient on every rank (GSPMD slices it there)."""
    ctx = current()
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return shard(x, *axes)
    spec = ctx.resolve(tuple(x.shape), axes)
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))


class _Constraint(torch.autograd.Function):
    """A layout constraint on a value and, as GSPMD's sharding constraint
    is, on its gradient: both are redistributed to the same placements
    (DTensor's own ``redistribute`` would return the gradient in the
    layout the value had before)."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(ctx.mesh, ctx.want), None, None


def fsdp_gather(w):
    """A weight gathered over its FSDP axes before a product (ZeRO-3's
    all-gather, which GSPMD inserts itself): every ``Shard`` on a mesh dim
    of the ``fsdp`` rule becomes ``Replicate``, the ``model`` shards stay.
    Without it DTensor may gather the ``model`` shards instead and repeat
    the whole product on every rank of that axis.  A plain tensor, or no
    context, passes through; its backward reduce-scatters the gradient."""
    ctx = current()
    if ctx is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(w, DTensor):
        return w
    fsdp = set(ctx.rules.get("fsdp", ()))
    names = w.device_mesh.mesh_dim_names
    want = [Replicate() if names[i] in fsdp and p.is_shard() else p
            for i, p in enumerate(w.placements)]
    return w.redistribute(w.device_mesh, want)


def on_shards(fn, *args, out_like=None):
    """``fn(*args)``, run on each rank's local shards under a mesh.  The
    DTensor arguments must be split alike along the dims ``fn`` treats
    independently (the plain ones are taken as replicated); each passes
    its local tensor, and each result becomes a DTensor in the layout of
    its counterpart in ``out_like`` (a tensor, or a tuple for a tuple of
    results; the first DTensor argument by default).  For work that is
    independent along the sharded dims (attention and the RWKV scan over
    batch and heads): DTensor would fold a batch shard and a head shard
    into one dim, which some of its versions refuse, and would dispatch a
    scan's every step.  Without a context or a DTensor argument, just
    ``fn(*args)``."""
    if current() is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor

    lead = next((a for a in args if isinstance(a, DTensor)), None)
    if lead is None:
        return fn(*args)
    from torch.distributed.tensor.experimental import local_map

    like = lead if out_like is None else out_like
    out = (tuple(list(t.placements) for t in like) if isinstance(like, tuple)
           else list(like.placements))
    return local_map(fn, out_placements=out, device_mesh=lead.device_mesh)(*args)


def gather_rows(x, index, *axes: str | None):
    """``x[index]``: the rows of ``x`` that an integer ``index`` names,
    the result laid out by the logical ``axes`` (one for each dim of
    ``index``, then ``x``'s trailing dims, which stay whole).

    Under a mesh each rank gathers only its own share of the result:
    ``x`` is all-gathered along its row shards, and the rank indexes it by
    its slice of ``index``.  The backward adds each rank's gradient rows
    into a zero ``x``, summed over the ranks that split the result and
    scattered back to ``x``'s row shards (:class:`_GatherRows`), so that
    no rank holds the whole result, and DTensor's rules for ``index_put``
    are never asked.  Without a context or a DTensor ``x``, just
    ``x[index]``."""
    if current() is None:
        return x[index]
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x[index]
    mesh, x, index, out, work = _rows_layout(x, index, axes)
    gathered = [i for i, p in enumerate(x.placements) if p.is_shard()]
    from torch.distributed.tensor.experimental import local_map

    return local_map(
        lambda xl, il: _GatherRows.apply(xl, il, mesh, gathered, work),
        out_placements=out, device_mesh=mesh)(x, index)


def scatter_rows(v, index, n: int, *axes: str | None):
    """The adjoint of :func:`gather_rows`: an ``(n, ...)`` tensor of zeros
    with each row ``v[j]`` added into row ``index[j]``, laid out by the
    logical ``axes`` of its dims (the first sharded, if at all, the others
    whole).  ``v`` has ``index``'s dims and then the rows'.

    Each rank adds the rows of its own share of ``v`` into a
    whole zero result, which is summed over the ranks that split ``v``
    and scattered to the result's row shards (:class:`_ScatterRows`); the
    backward gathers the result's gradient and indexes it.  ``v`` is a
    DTensor under a mesh."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    ctx = current()
    mesh = v.device_mesh
    # v and its index alike: shards on the index's dims only, no partial sums
    keep = [p if p.is_shard() and p.dim < index.ndim else Replicate()
            for p in v.placements]
    v = v.redistribute(mesh, keep)
    index = _as_dtensor(index, mesh).redistribute(mesh, keep)
    work = [i for i, p in enumerate(keep) if p.is_shard()]
    out = placements(ctx.resolve((n, *v.shape[index.ndim:]), axes), mesh)
    if any(p.is_shard() and p.dim != 0 for p in out):
        raise ValueError(f"scatter_rows shards its rows only, not {axes}")
    spread = [i for i, p in enumerate(out) if p.is_shard()]
    return local_map(
        lambda vl, il: _ScatterRows.apply(vl, il, n, mesh, spread, work),
        out_placements=out, device_mesh=mesh)(v, index)


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _rows_layout(x, index, axes):
    """``x`` with its row shards kept and every other dim whole, the
    result's placements, ``index`` in them, and the mesh dims that split
    the result."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    x = x.redistribute(mesh, [p if p.is_shard() and p.dim == 0 else Replicate()
                              for p in x.placements])
    out = placements(current().resolve((*index.shape, *x.shape[1:]), axes), mesh)
    if any(p.is_shard() and p.dim >= index.ndim for p in out):
        raise ValueError(f"gather_rows shards the index's dims only, not {axes}")
    index = _as_dtensor(index, mesh).redistribute(mesh, out)
    return mesh, x, index, out, [i for i, p in enumerate(out) if p.is_shard()]


def _collective(op: str, x, mesh, i: int, *args):
    """A functional collective of ``x`` over mesh dim ``i``, waited on."""
    c10d = torch.ops._c10d_functional
    group = mesh.get_group(i)
    if op == "all_reduce":
        out = c10d.all_reduce(x.contiguous(), *args, group.group_name)
    else:
        out = getattr(c10d, op)(x.contiguous(), *args, group.size(), group.group_name)
    return c10d.wait_tensor(out)


def _all_gather_rows(x, mesh, dims):
    """``x``'s row shards over mesh ``dims`` gathered, innermost first."""
    for i in reversed(dims):
        x = _collective("all_gather_into_tensor", x, mesh, i)
    return x


def _sum_to_row_shard(full, mesh, dims, work):
    """Whole rows, partial over the mesh dims in ``work``, to this rank's
    row shard over ``dims``: summed and scattered where a dim is in
    ``work``, sliced where it is not, then summed over the rest of
    ``work``."""
    for i in dims:              # outermost first
        if i in work:
            full = _collective("reduce_scatter_tensor", full, mesh, i, "sum")
        else:
            full = full.chunk(mesh.size(i))[mesh.get_local_rank(i)]
    for i in work:
        if i not in dims:
            full = _collective("all_reduce", full, mesh, i, "sum")
    return full


def max_across(x, mesh, dims):
    """The elementwise max of each rank's local ``x`` over mesh ``dims``
    (no gradient)."""
    for i in dims:
        x = _collective("all_reduce", x, mesh, i, "max")
    return x


def sum_across(x, mesh, dims):
    """The sum of each rank's local ``x`` over mesh ``dims``, the same on
    every rank of them; its gradient reaches each rank's term unchanged."""
    return _SumAcross.apply(x, mesh, dims)


class _SumAcross(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dims):
        for i in dims:
            x = _collective("all_reduce", x, mesh, i, "sum")
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherRows(torch.autograd.Function):
    """On local tensors: ``x``'s rows gathered over mesh dims
    ``gathered``, indexed by this rank's ``index``; the ranks over mesh
    dims ``work`` hold different shares of the result."""

    @staticmethod
    def forward(ctx, x, index, mesh, gathered, work):
        full = _all_gather_rows(x, mesh, gathered)
        ctx.save_for_backward(index)
        ctx.mesh, ctx.gathered, ctx.work = mesh, gathered, work
        ctx.full = (full.shape, full.dtype)
        return full[index]

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        shape, dtype = ctx.full
        full = torch.zeros(shape, dtype=dtype, device=grad.device)
        full.index_put_((index,), grad.to(dtype), accumulate=True)
        return (_sum_to_row_shard(full, ctx.mesh, ctx.gathered, ctx.work),
                None, None, None, None)


class _ScatterRows(torch.autograd.Function):
    """On local tensors: this rank's rows ``v`` added into ``n`` zero
    rows at ``index``, summed over mesh dims ``work`` and left in this
    rank's row shard over mesh dims ``spread``."""

    @staticmethod
    def forward(ctx, v, index, n, mesh, spread, work):
        rows = v.shape[index.ndim:]
        full = torch.zeros((n, *rows), dtype=v.dtype, device=v.device)
        full.index_add_(0, index.reshape(-1), v.reshape(-1, *rows))
        ctx.save_for_backward(index)
        ctx.mesh, ctx.spread = mesh, spread
        return _sum_to_row_shard(full, mesh, spread, work)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        full = _all_gather_rows(grad, ctx.mesh, ctx.spread)
        return full[index], None, None, None, None, None


def on_matmul_shards(fn, a, b):
    """``fn(a, b)`` for a product ``a (M, K) @ b (K, N)`` that a kernel
    computes, run on each rank's local shards under a mesh: ``K`` is
    gathered whole on both sides, ``a`` keeps its row shards and ``b`` its
    column shards (gathered on a mesh dim that also shards ``a``'s rows),
    and the result is a DTensor sharded as both, rows where ``a`` is and
    columns where ``b`` is.  A plain argument counts as replicated.
    Without a context or a DTensor argument, just ``fn(a, b)``."""
    if current() is None:
        return fn(a, b)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    lead = next((t for t in (a, b) if isinstance(t, DTensor)), None)
    if lead is None:
        return fn(a, b)
    mesh = lead.device_mesh

    def keep(t, dim):
        if not isinstance(t, DTensor):
            return [Replicate()] * mesh.ndim
        return [p if p == Shard(dim) else Replicate() for p in t.placements]

    pa = keep(a, 0)
    pb = [Replicate() if pa[i] != Replicate() else p for i, p in enumerate(keep(b, 1))]
    out = [pa[i] if pa[i] != Replicate() else pb[i] for i in range(mesh.ndim)]
    args = [t.redistribute(mesh, p) if isinstance(t, DTensor) else t
            for t, p in ((a, pa), (b, pb))]
    return local_map(fn, out_placements=out, device_mesh=mesh)(*args)


def index_copy_(dst, dim: int, index, src):
    """``dst.index_copy_(dim, index, src)`` for a one-element ``index``.
    A DTensor takes a masked write instead, which keeps its layout: some
    versions of DTensor have no rule for ``index_copy_``, and others, for
    a dst sharded along ``dim`` (a context-parallel cache), relabel its
    layout without moving the shards."""
    if current() is None:
        return dst.index_copy_(dim, index, src)
    from torch.distributed.tensor import DTensor

    if not isinstance(dst, DTensor):
        return dst.index_copy_(dim, index, src)
    shape = [1] * dst.ndim
    shape[dim] = dst.shape[dim]
    hit = (torch.arange(dst.shape[dim], device=dst.device) == index).reshape(shape)
    return dst.copy_(torch.where(hit, src, dst))


def is_dtensor(x) -> bool:
    if current() is None:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def like(x, ref):
    """``x`` laid out as ``ref`` when both are DTensors (a gradient as its
    parameter, which an in-place update needs); otherwise ``x``."""
    if current() is None:
        return x
    from torch.distributed.tensor import DTensor

    if (isinstance(x, DTensor) and isinstance(ref, DTensor)
            and tuple(x.placements) != tuple(ref.placements)):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x


def spec_for_logical(shape: tuple[int, ...], axes: tuple[str | None, ...]) -> P:
    """Resolve a spec under the active context (replicated if none)."""
    ctx = current()
    if ctx is None:
        return P()
    return ctx.resolve(shape, axes)
