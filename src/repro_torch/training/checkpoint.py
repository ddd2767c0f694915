"""Checkpointing: atomic, resumable, async-capable.

Layout:  <dir>/step_<N>/arrays.npz + manifest.json, written to a tmp dir
and atomically renamed — a crashed writer never corrupts the latest
checkpoint, which is what restart-after-failure relies on.  ``save_async``
copies every leaf to the host then writes on a background thread, so the
caller may update the tree in place at once.  The layout is the
reference's, so a checkpoint written by either package loads in the other.

A tree is nested dicts, lists, tuples (named tuples included) and ``None``
around leaves (tensors, numpy arrays, scalars).  It flattens as JAX's
``tree_util`` flattens it: dict keys in sorted order, ``None`` an empty
subtree, and the manifest's ``treedef`` is JAX's spelling of the
structure.  Leaves go to the host with ``.detach().cpu().numpy()``.

A tree with ``DTensor`` leaves (a state sharded over a ``DeviceMesh``) is
saved by every rank of the default process group together: each DTensor
is gathered (``full_tensor()``, a collective over its mesh that each of
its ranks joins), only rank 0 writes, and a barrier follows, so the
checkpoint is complete on every rank's return (``save_async``: on
``wait()``, or the next save through the same ``Saver``).  The file is the
same host numpy, so a sharded state restores into a plain tree on any
mesh (``elastic.reshard`` places it).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree):
    """-> (leaves, treedef string): depth first, dict keys sorted."""
    leaves = []

    def walk(x) -> str:
        if x is None:
            return "None"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            inner = ", ".join(walk(v) for v in x)
            return f"CustomNode(namedtuple[{type(x).__name__}], [{inner}])"
        if isinstance(x, tuple):
            inner = ", ".join(walk(v) for v in x)
            return f"({inner},)" if len(x) == 1 else f"({inner})"
        if isinstance(x, list):
            return "[" + ", ".join(walk(v) for v in x) + "]"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in order, by
    ``leaves``."""
    it = iter(leaves)

    def walk(x):
        if x is None:
            return None
        if isinstance(x, dict):
            new = {k: walk(x[k]) for k in sorted(x)}
            return {k: new[k] for k in x}
        if _is_namedtuple(x):
            return type(x)._make(walk(v) for v in x)
        if isinstance(x, (tuple, list)):
            return type(x)(walk(v) for v in x)
        return next(it)

    return walk(like)


def _to_host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _snapshot(x) -> np.ndarray:
    """A host copy of ``x`` that owns its memory: ``_to_host`` of a CPU
    tensor or a numpy array is a view, which a later in-place update of
    the live value (a train step's ``copy_``) would change under the
    background writer."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def _gathered(leaves: list, host) -> tuple[list, bool, bool]:
    """-> (``host`` of each leaf, the tree is sharded, this rank writes).

    A sharded tree's DTensors are gathered on every rank of their meshes;
    only rank 0 of the default group writes, and it must be in every
    mesh."""
    if not any(isinstance(x, DTensor) for x in leaves):
        return [host(x) for x in leaves], False, True
    writer = dist.get_rank() == 0
    hosted = []
    for x in leaves:
        if isinstance(x, DTensor):
            if x.device_mesh.get_coordinate() is None:
                if writer:
                    raise ValueError("rank 0 of the default group, which writes the "
                                     "checkpoint, holds no shard of a DTensor leaf")
                continue
            x = x.full_tensor()
        if writer:
            hosted.append(host(x))
    return hosted, True, writer


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Blocking atomic save; returns the checkpoint path.  With DTensor
    leaves, every rank calls it (see the module's docstring)."""
    leaves, treedef = _flatten(tree)
    hosted, sharded, writer = _gathered(leaves, _to_host)
    if writer:
        _write(ckpt_dir, step, hosted, treedef, extra)
    if sharded:
        dist.barrier()
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _write(ckpt_dir: str, step: int, hosted: list, treedef: str,
           extra: dict | None) -> None:
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"a{i}": a for i, a in enumerate(hosted)})
    manifest = {"step": step, "n_leaves": len(hosted),
                "treedef": treedef, "extra": extra or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


class Saver:
    """Async checkpoint writer with *instance-scoped* pending state: each
    Saver owns its pending thread and a lock, so two independent savers
    never join or forget each other's writes; the module-level
    ``save_async``/``wait`` are shims over a default instance."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._sharded = False       # the pending write owes a barrier
        self._lock = threading.Lock()

    def save_async(self, ckpt_dir: str, step: int, tree,
                   extra: dict | None = None) -> None:
        """Snapshot to host now, write in the background.  With DTensor
        leaves, every rank calls it, and ``wait`` on every rank."""
        leaves, treedef = _flatten(tree)
        # device->host (and a sharded tree's gathers) happen here
        hosted, sharded, writer = _gathered(leaves, _snapshot)
        t = threading.Thread(target=_write, daemon=True,
                             args=(ckpt_dir, step, hosted, treedef, extra))
        # join-then-start under the lock: writes through one Saver are
        # serialized, and a concurrent wait() can never observe (or join)
        # a not-yet-started thread
        with self._lock:
            self._finish()
            if writer:
                t.start()
                self._thread = t
            self._sharded = sharded

    def _finish(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            dist.barrier()
            self._sharded = False

    def wait(self) -> None:
        with self._lock:
            self._finish()


_DEFAULT_SAVER = Saver()


def save_async(ckpt_dir: str, step: int, tree, extra: dict | None = None):
    """Module-level shim over a process-default :class:`Saver`."""
    _DEFAULT_SAVER.save_async(ckpt_dir, step, tree, extra)


def wait():
    _DEFAULT_SAVER.wait()


def latest(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def load(path: str) -> tuple[list, dict]:
    """Load a checkpoint's raw leaves + manifest without a reference tree
    (the session checkpoint format stores its structure in ``extra``)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        leaves = [z[f"a{i}"] for i in range(manifest["n_leaves"])]
    return leaves, manifest


def restore(path: str, tree_like):
    """Restore into the structure of ``tree_like`` (shapes must match).
    Each leaf takes its counterpart's dtype; a tensor counterpart gives a
    tensor on the counterpart's device."""
    leaves, manifest = load(path)
    ref_leaves, _ = _flatten(tree_like)
    if len(ref_leaves) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, the tree "
                         f"{len(ref_leaves)}")
    cast = []
    for a, r in zip(leaves, ref_leaves):
        if torch.is_tensor(r):
            cast.append(torch.from_numpy(np.array(a)).to(
                device=r.device, dtype=r.dtype))
        else:
            cast.append(np.asarray(a, dtype=np.asarray(r).dtype))
    return _unflatten(tree_like, cast), manifest
