"""Meshes: the patient-sharding 1-D tuple of devices, and the LM side's
2-D and 3-D ``DeviceMesh``es.

The reference's ``('data',)`` mesh is a JAX device mesh; here it is the
tuple of ``torch.device``s the shards of the streaming service pin to:
``cuda:0 .. cuda:k-1`` for the visible cards, or ``(cpu,)`` when the
caller asks for the CPU.

The production meshes are the reference's: single pod 16 x 16 = 256 ranks
``('data', 'model')``, multi-pod 2 x 16 x 16 = 512 ranks ``('pod', 'data',
'model')``.  ``make_production_mesh`` builds one over a fake process group
(the ``"fake"`` backend that PyTorch ships: every collective is accepted
and moves nothing) of that many ranks, this process being rank 0, so a
step traces per-rank on one card or the CPU (``launch/dryrun``).  This
module owns that group: a fake group of another size is torn down and
replaced, a default group that is not fake makes it raise, and
``release()`` (or leaving ``production_mesh``) tears it down.
``make_test_mesh`` builds over the default group the caller initialised
(a spawned ``gloo`` world in the tests, on the CPU or all ranks on one
card), or over some of its ranks.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _fake_group(world: int) -> None:
    """A fake default group of ``world`` ranks (this process rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()!r} process group is initialised; the production "
                "mesh needs a fake one of its own")
        if dist.get_world_size() == world:
            return
        release()
    dist.init_process_group("fake", rank=0, world_size=world, store=FakeStore())


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The reference's production mesh as a ``DeviceMesh`` of ``device``'s
    type over a fake group of 256 (512 with ``multi_pod``) ranks."""
    shape, axes = PRODUCTION[multi_pod]
    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu'")
    _fake_group(math.prod(shape))
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def release() -> None:
    """Tear down the fake group ``make_production_mesh`` made, if it stands."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


@contextlib.contextmanager
def production_mesh(*, multi_pod: bool = False, device="cuda"):
    """``make_production_mesh`` for the block; its group is torn down after."""
    try:
        yield make_production_mesh(multi_pod=multi_pod, device=device)
    finally:
        release()


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device="cuda", ranks=None):
    """A small mesh over the default group the caller initialised: over
    the whole group (its world size must be the mesh's size), or over the
    group's ``ranks`` in row-major order (the mesh of an elastic restart
    that lost ranks).  Every rank of the group calls it; one outside
    ``ranks`` holds no shard of what is placed on the mesh."""
    kind = torch.device(device).type
    if ranks is None:
        return init_device_mesh(kind, tuple(shape), mesh_dim_names=axes)
    return DeviceMesh(kind, torch.tensor(list(ranks)).reshape(tuple(shape)),
                      mesh_dim_names=axes)


def gloo_cuda_all_gather():
    """Run the functional all-gather of CUDA tensors through the process
    group's own ``all_gather_into_tensor``, for a ``gloo`` world whose
    ranks share a card (NCCL refuses two ranks on one device).

    Over ``gloo``, PyTorch 2.11's ``_c10d_functional.all_gather_into_tensor``
    (what DTensor's ``redistribute`` and ``full_tensor`` issue) corrupts
    host memory for CUDA tensors, and the process dies later of a
    segmentation fault; ``dist.all_gather_into_tensor`` on the same
    tensors is sound.  This registers, for the CUDA dispatch key, a kernel
    of that op which calls it and returns the gathered tensor (the wait is
    then a no-op).  Returns the registration's library: the kernel stays
    registered while it lives."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather_into_tensor(x, group_size: int, group_name: str):
        out = x.new_empty((x.shape[0] * group_size, *x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    return lib


def make_data_mesh(n: int | None = None, device="cuda") -> tuple:
    """1-D mesh over up to ``n`` devices of ``device``'s type: every
    visible card for ``'cuda'`` (raises when none is visible), one CPU
    for ``'cpu'``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return (torch.device("cpu"),)
    if kind != "cuda":
        raise ValueError(f"no data mesh over {kind!r} devices")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is visible; pass device='cpu'")
    count = count if n is None else min(n, count)
    return tuple(torch.device("cuda", i) for i in range(count))


def shard_devices(n_shards: int, mesh=None) -> list:
    """One device per shard slot, in mesh position order.

    Shard ``s`` of the streaming service lives at mesh position ``s``;
    with fewer devices than shards the assignment wraps round-robin
    (co-resident shards still mine correctly, they share a device).
    Without a mesh, the mesh of every visible card."""
    devices = list(mesh) if mesh is not None else list(make_data_mesh())
    return [devices[s % len(devices)] for s in range(n_shards)]
