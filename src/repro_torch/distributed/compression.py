"""Gradient compression for the slow (cross-pod) axis: int8 all-reduce
with error feedback.

Inside a ``sharding.local_call`` of a train step, replace the sum of ``g``
over the axis with ``compressed_psum_mean(g, 'pod', err)``: values are
quantized to int8 against a shared scale (one ``MAX`` all-reduce of a
scalar), summed as int32 (4x fewer bytes on the wire than float32: the
paper's pack-to-integers trick applied to gradients), and the local
quantization residual is carried to the next step (error feedback keeps
SGD unbiased in the long run).

The functions take a rank's local tensors; ``axis_name`` is a dimension
of the mesh of ``sharding.axis_rules``, whose process group carries the
two all-reduces.  The float32 arithmetic is the reference's, operation
for operation (``torch.round`` rounds half to even, as ``jnp.round``), so
the mean and the new error are the reference's bit for bit.
"""
from __future__ import annotations

import torch
from torch.distributed import _functional_collectives as funcol
from torch.utils._pytree import tree_flatten, tree_unflatten

from repro_torch.distributed.sharding import current_rules


def quantize(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _group(axis_name: str):
    ctx = current_rules()
    if ctx is None:
        raise RuntimeError(f"axis {axis_name!r} names a mesh dimension: call inside "
                           "sharding.axis_rules(mesh)")
    return ctx[0].get_group(axis_name)


def compressed_psum_mean(g, axis_name: str, err=None):
    """Mean-allreduce of ``g`` over ``axis_name`` via int8.  Returns
    (mean_g float32, new_err); ``err`` is the local error-feedback
    buffer."""
    group = _group(axis_name)
    g = g.to(torch.float32)
    if err is not None:
        g = g + err
    gmax = funcol.all_reduce(g.abs().amax(), "max", group)
    scale = torch.clamp(gmax, min=1e-12) / 127.0
    q = quantize(g, scale)
    new_err = g - q.to(torch.float32) * scale
    total = funcol.all_reduce(q.to(torch.int32), "sum", group)
    n = torch.distributed.get_world_size(group)
    return total.to(torch.float32) * scale / float(n), new_err


def tree_compressed_psum_mean(grads, axis_name: str, err_tree=None):
    """``compressed_psum_mean`` of every leaf of ``grads``, with its error
    buffer from ``err_tree`` (zeros when None): (the means, the new
    errors), each a tree like ``grads``."""
    leaves, spec = tree_flatten(grads)
    errs = ([torch.zeros(g.shape, dtype=torch.float32, device=g.device) for g in leaves]
            if err_tree is None else tree_flatten(err_tree)[0])
    out = [compressed_psum_mean(g, axis_name, e) for g, e in zip(leaves, errs)]
    return (tree_unflatten([m for m, _ in out], spec),
            tree_unflatten([e for _, e in out], spec))
