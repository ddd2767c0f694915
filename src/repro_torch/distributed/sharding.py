"""Logical-axis sharding: the rules context, activation constraints, the
parameters' shardings, the global screen's table merge over patient
shards and the LM parameters' FSDP axis.

Model code annotates activations with *logical* axis names
(``constrain(x, ("batch", "seq", None))``).  The launcher installs a rule
set mapping logical names to mesh axes (``axis_rules``); outside any rule
context, and on a plain tensor, the annotations are no-ops, so one-card
runs and CPU unit tests never see a mesh.  On a ``DTensor`` inside the
rules ``constrain`` redistributes to the spec's placements, where the
reference's ``with_sharding_constraint`` tells XLA's partitioner.

A ``PartitionSpec`` is a tuple here (``P``, the tuple that
``models/layers.param_specs`` carries): one entry a tensor dimension, each
None, a mesh axis name or a tuple of them.  ``NamedSharding(mesh, spec)``
is the twin of JAX's over a ``torch.distributed.device_mesh.DeviceMesh``:
its ``placements`` give DTensor's (a tensor dimension whose entry names
mesh axes is ``Shard(dim)`` on each of them) and ``shard_shape`` the
per-rank shape.  ``distribute`` and ``distribute_module`` place fake or
real tensors by a sharding without moving data through the group
(``src_data_rank=None``: each rank keeps its own slice).
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.utils._pytree import tree_map

from repro_torch.core.encoding import as_tensor

_RULES: contextvars.ContextVar = contextvars.ContextVar("axis_rules", default=None)


class P(tuple):
    """A PartitionSpec: ``P('data', None)`` is the tuple ``('data', None)``;
    an entry of one axis in a tuple is that axis, as JAX spells it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if type(e) is tuple and len(e) == 1 else e
                                     for e in entries))


def is_spec(v) -> bool:
    """Whether ``v`` is a PartitionSpec: a ``P``, or a plain tuple whose
    entries are None, an axis name or a tuple of axis names."""
    if isinstance(v, P):
        return True
    return type(v) is tuple and all(
        e is None or isinstance(e, str)
        or (type(e) is tuple and all(isinstance(a, str) for a in e)) for e in v)


def axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, an axis, or a tuple of them)."""
    return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))


def default_rules(mesh) -> dict:
    """The logical -> mesh-axis mapping of the single- and multi-pod
    meshes."""
    axes = mesh.mesh_dim_names
    batch = tuple(a for a in ("pod", "data") if a in axes)
    return {
        "batch": batch if len(batch) > 1 else (batch[0] if batch else None),
        "model": "model" if "model" in axes else None,
        "fsdp": "data" if "data" in axes else None,
        "seq": None,            # flipped to ('data',) for long-context SP
        "seq_res": None,        # Megatron-SP residual (cfg.sp_residual)
        "expert": "model" if "model" in axes else None,
    }


@contextlib.contextmanager
def axis_rules(mesh, rules: dict | None = None):
    """Install ``rules`` (default ``default_rules(mesh)``) for the block.
    Inside, DTensor also takes the plain tensors a step makes (positions,
    masks) as replicated (its implicit replication, restored after)."""
    token = _RULES.set((mesh, rules or default_rules(mesh)))
    dispatcher = DTensor._op_dispatcher
    implicit = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = implicit
        _RULES.reset(token)


def current_rules():
    """``(mesh, rules)`` inside ``axis_rules``, else None."""
    return _RULES.get()


def with_current_rules(fn):
    """``fn`` run under the rules that stand now, wherever it is called: a
    checkpointed layer is recomputed in the backward on autograd's own
    thread on the card, which a context variable does not reach."""
    ctx = _RULES.get()
    if ctx is None:
        return fn

    def run(*args, **kwargs):
        with axis_rules(*ctx):
            return fn(*args, **kwargs)

    return run


def logical_to_pspec(names, rules) -> P:
    return P(*[rules.get(n) if isinstance(n, str) else n for n in names])


class NamedSharding:
    """A spec over a ``DeviceMesh``: ``placements`` (one a mesh dimension)
    and ``shard_shape`` (a rank's shape of a global shape, each sharded
    dimension divided by its axes' sizes, rounded up as DTensor's first
    shards are)."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, P(*spec)

    @property
    def placements(self) -> tuple:
        out = [Replicate()] * self.mesh.ndim
        for dim, entry in enumerate(self.spec):
            for a in entry_axes(entry):
                out[self.mesh.mesh_dim_names.index(a)] = Shard(dim)
        return tuple(out)

    def shard_shape(self, global_shape) -> tuple:
        shape = list(global_shape)
        for dim, entry in enumerate(self.spec):
            n = math.prod(axis_size(self.mesh, a) for a in entry_axes(entry))
            shape[dim] = -(-shape[dim] // n)
        return tuple(shape)


def fit_pspec(spec, shape, mesh) -> P:
    """``spec`` for an activation of ``shape``: each dim keeps the longest
    prefix of its axes whose sizes divide it (the batch of 32 sequences
    on ``('data', 'model')`` keeps 'data').  XLA pads an uneven shard;
    DTensor's views of a dim sharded unevenly over two axes go wrong, so
    the port shards what divides and replicates the rest."""
    out = []
    for i, entry in enumerate(spec):
        keep, size = [], 1
        for a in entry_axes(entry):
            size *= axis_size(mesh, a)
            if i >= len(shape) or shape[i] % size:
                break
            keep.append(a)
        out.append(tuple(keep) if len(keep) > 1 else (keep[0] if keep else None))
    return P(*out)


def on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor inside ``axis_rules``."""
    return isinstance(x, DTensor) and _RULES.get() is not None


def model_entry(*sizes, taken=()):
    """The rules' 'model' axis where it divides every one of ``sizes``
    (heads, and a GQA model's KV heads, so its groups stay whole) and no
    axis in ``taken`` holds it; else None."""
    mesh, rules = _RULES.get()
    ma = rules["model"]
    if not ma or ma in taken:
        return None
    n = axis_size(mesh, ma)
    return ma if all(s % n == 0 for s in sizes) else None


def batch_entry(b: int, exclude=()):
    """The rules' batch entry for a batch of ``b`` (``fit_pspec``'s), less
    the axes in ``exclude``."""
    mesh, rules = _RULES.get()
    axes = tuple(a for a in entry_axes(rules["batch"]) if a not in exclude)
    return fit_pspec(P(axes or None), (b,), mesh)[0]


def constrain(x, names):
    """``x`` laid out by the logical ``names`` inside ``axis_rules``: a
    DTensor is redistributed to the spec's placements (``fit_pspec``;
    DTensor issues the collectives); outside the rules, and for a plain
    tensor, ``x``."""
    ctx = _RULES.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = fit_pspec(logical_to_pspec(names, rules), x.shape, mesh)
    placements = NamedSharding(mesh, spec).placements
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def _ranks(x, dim: int) -> int:
    return math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                     if p.is_shard(dim))


def _replicated(x, dim: int):
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(dim) else p
                                          for p in x.placements])


def _strides(shape) -> tuple:
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return tuple(stride)


def _wrapped(local, mesh, placements, shape) -> DTensor:
    """``local`` as a rank's shard of a contiguous DTensor of ``shape``."""
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_strides(shape))


def unflatten(x, dim: int, sizes):
    """``x.unflatten(dim, sizes)``.  On a DTensor the reshape runs on the
    local tensor, the outer of the two dims keeping ``dim``'s sharding, so
    the gradient comes back in that layout.  A ``dim`` sharded over a
    number of ranks that does not divide ``sizes[0]`` (gemma2-2b's 8
    heads on a 16-wide 'model' axis) is gathered first: DTensor cannot
    split an uneven shard, where XLA splits the inner size too.  The
    gather shows in the dry run's collective count."""
    if not isinstance(x, DTensor):
        return x.unflatten(dim, sizes)
    dim %= x.ndim
    outer, inner = sizes
    if outer == -1:
        outer = x.shape[dim] // inner
    if inner == -1:
        inner = x.shape[dim] // outer
    if outer % _ranks(x, dim):
        x = _replicated(x, dim)
    local = x.to_local()
    local = local.unflatten(dim, (local.shape[dim] // inner, inner))
    placements = [Shard(p.dim + 1) if p.is_shard() and p.dim > dim else p
                  for p in x.placements]
    return _wrapped(local, x.device_mesh, placements,
                    (*x.shape[:dim], outer, inner, *x.shape[dim + 1:]))


def flatten(x, dim: int):
    """``x`` with dims ``dim`` and ``dim + 1`` merged.  On a DTensor the
    reshape runs on the local tensor (the inner dim gathered first if it
    is sharded), so the gradient comes back in this layout."""
    if not isinstance(x, DTensor):
        return x.flatten(dim, dim + 1)
    dim %= x.ndim
    if _ranks(x, dim + 1) > 1:
        x = _replicated(x, dim + 1)
    placements = [Shard(p.dim - 1) if p.is_shard() and p.dim > dim + 1 else p
                  for p in x.placements]
    return _wrapped(x.to_local().flatten(dim, dim + 1), x.device_mesh, placements,
                    (*x.shape[:dim], x.shape[dim] * x.shape[dim + 1], *x.shape[dim + 2:]))


def placements_of(mesh, spec, partial=()) -> list:
    """``spec``'s placements over ``mesh``, the axes in ``partial`` pending
    a sum (``Partial``)."""
    out = list(NamedSharding(mesh, spec).placements)
    for a in partial:
        out[mesh.mesh_dim_names.index(a)] = Partial()
    return out


def to_local_as(t: DTensor, spec, grad_partial=()):
    """``t``'s local tensor once laid out by ``spec`` over its mesh; the
    gradient that comes back to it is a partial sum over ``grad_partial``
    (the axes whose ranks use the same slice on other tokens)."""
    mesh = t.device_mesh
    return t.redistribute(mesh, placements_of(mesh, spec)).to_local(
        grad_placements=placements_of(mesh, spec, grad_partial))


def local_call(fn, args, in_specs, out_specs, out_shapes, grad_partial=None,
               out_partial=()):
    """``fn`` on the ranks' local tensors, for a computation that needs no
    communication inside (a recurrence over time, per sequence and head):
    each DTensor of ``args`` is laid out by its spec of ``in_specs``
    (``fit_pspec``; an arg whose spec is None passes as it is) and handed
    to ``fn`` as its local tensor (``to_local_as``); ``fn``'s outputs (a
    tree matching ``out_specs``) come back as DTensors laid out by
    ``out_specs``, of the global shapes ``out_shapes``.  ``grad_partial``
    maps an arg's index to the axes over which its gradient is a partial
    sum (a replicated weight each rank applies to its own tokens: DTensor
    reduces it once, at the boundary); the outputs are partial sums over
    the axes ``out_partial`` (each rank's share of a total).  The mesh is
    the rules' (``axis_rules``); the reference's twin is ``shard_map``."""
    mesh, _ = _RULES.get()
    tensor_leaf = lambda v: v is None or isinstance(v, torch.Tensor)  # noqa: E731

    def localize(a, spec, partial):
        if spec is None or not isinstance(a, DTensor):
            return a
        return to_local_as(a, fit_pspec(spec, a.shape, mesh), partial)

    local = [a if spec is None else
             tree_map(lambda t, sp, i=i: localize(t, sp, (grad_partial or {}).get(i, ())),
                      a, spec, is_leaf=tensor_leaf)
             for i, (a, spec) in enumerate(zip(args, in_specs))]

    def wrap(t, spec, shape):
        if t is None:
            return None
        return _wrapped(t, mesh, placements_of(mesh, fit_pspec(spec, shape, mesh),
                                               out_partial), shape)

    return tree_map(wrap, fn(*local), out_specs, out_shapes, is_leaf=tensor_leaf)


def gather_fsdp(w):
    """A weight as FSDP uses it: a DTensor parameter inside the rules is
    gathered over the batch (data-parallel) axes, keeping its 'model'
    (TP or EP) sharding; its gradient is then reduce-scattered back by
    DTensor.  Anything else is returned as it is."""
    ctx = _RULES.get()
    if ctx is None or not isinstance(w, DTensor):
        return w
    mesh, rules = ctx
    batch = entry_axes(rules["batch"])
    placements = [Replicate() if mesh.mesh_dim_names[i] in batch else p
                  for i, p in enumerate(w.placements)]
    return w if placements == list(w.placements) else w.redistribute(mesh, placements)


def sanitize_pspec(spec, shape, mesh) -> P:
    """Drop mesh axes a dim is not divisible by (small weights replicate).
    Mirrors the fallback rule every production sharder needs: a [768, 8]
    gate projection cannot shard 8 ways over a 16-wide 'model' axis."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None if i >= len(shape) else entry)
            continue
        size = math.prod(axis_size(mesh, a) for a in entry_axes(entry))
        out.append(entry if shape[i] % size == 0 else None)
    return P(*out)


def _leaves_as_specs(tree):
    return tree_map(lambda s: P(*s), tree, is_leaf=is_spec)


def sanitize_tree(spec_tree, struct_tree, mesh):
    """``sanitize_pspec`` of each spec of ``spec_tree`` against the shape
    of the tensor at the same place of ``struct_tree`` (a host scalar, such
    as a cache's ``pos``, has the shape ``()``)."""
    specs = _leaves_as_specs(spec_tree)
    return tree_map(lambda s, x: sanitize_pspec(s, getattr(x, "shape", ()), mesh),
                    specs, struct_tree,
                    is_leaf=lambda v: isinstance(v, P))


def param_shardings(mesh, spec_tree, struct_tree=None):
    """PartitionSpec tree (from model init) -> NamedSharding tree,
    sanitized against the struct shapes when provided."""
    if struct_tree is not None:
        spec_tree = sanitize_tree(spec_tree, struct_tree, mesh)
    return tree_map(lambda s: NamedSharding(mesh, s), _leaves_as_specs(spec_tree),
                    is_leaf=lambda v: isinstance(v, P))


def distribute(t: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``t`` (the global tensor, fake or real) as a DTensor laid out by
    ``sharding``; each rank keeps its own slice and nothing is sent."""
    return distribute_tensor(t, sharding.mesh, sharding.placements, src_data_rank=None)


def distribute_tree(tree, shardings):
    """``distribute`` of each tensor of ``tree`` by the sharding at its
    place in ``shardings``; a leaf that is not a tensor stays."""
    return tree_map(lambda t, s: distribute(t, s) if isinstance(t, torch.Tensor) else t,
                    tree, shardings, is_leaf=lambda v: isinstance(v, NamedSharding))


@torch.no_grad()
def distribute_module(module: nn.Module, shardings: dict) -> nn.Module:
    """``module`` with each parameter replaced, in place, by a DTensor
    parameter laid out by ``shardings[name]``; ``requires_grad`` is
    kept."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner)
        setattr(owner, leaf, nn.Parameter(distribute(p.detach(), shardings[name]),
                                          requires_grad=p.requires_grad))
    return module


def merge_sharded_counts(tables, mesh=None) -> torch.Tensor:
    """Global screen table from per-shard bucket-count tables.

    Per-shard sketch tables count distinct (patient, sequence) pairs over
    *disjoint* patient sets, so the global table is their elementwise sum
    (the reference's psum over the ``('data',)`` mesh).  Every table moves
    to ``mesh[0]`` (or to the first table's device without a mesh) with
    ``.to()``, device to device, and the sum runs there in int32."""
    tables = [as_tensor(t, torch.int32) for t in tables]
    dev = mesh[0] if mesh is not None else tables[0].device
    return torch.stack([t.to(dev) for t in tables]).sum(0, dtype=torch.int32)


def fsdp_axis_for(cfg):
    """The mesh axis (or axes) the FSDP dimension of a weight shards over:
    None without ``cfg.fsdp``; ``'data'``, or with TP off ``('data',
    'model')`` (the idle TP axis folded into FSDP)."""
    if not cfg.fsdp:
        return None
    return "data" if cfg.tp_internals else ("data", "model")
