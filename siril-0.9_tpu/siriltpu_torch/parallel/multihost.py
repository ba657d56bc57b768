"""Multi-process scale-out on ``torch.distributed`` (SURVEY §5.8).

Port of ``siriltpu.parallel.multihost``. The reference is single-node
OpenMP; across processes the same workload becomes one program per
process over a mesh that spans every process's devices:

- ``init_distributed`` brings up the process group
  (``torch.distributed.init_process_group``): NCCL where a card is
  visible, gloo when the caller asks for it (the CPU tests);
- ``local_frame_indices`` tells each process which global frame indices
  its own mesh entries consume, so each process reads ONLY its shard from
  disk (the analog of the reference's per-thread locked-fd block reads,
  SURVEY P5);
- ``global_frames_from_local`` assembles the global frames from those
  process-local reads with one ``all_gather``;
- ``make_multihost_register_stack`` runs the register + rejection stack
  of ``parallel.sharded`` over the global mesh: each process registers
  its frame shards and stacks its row slabs, and the shifts and the slabs
  are gathered with ``all_reduce``.

The collectives used, ``all_reduce`` and ``all_gather``, are ones that
gloo and NCCL both implement. Neither takes uint16, so words cross
widened to int32. NCCL cannot place two ranks on one card,
so one card runs a group of world size 1.

Proven by a real 2-process gloo cluster (``parallel._mh_worker``,
tests/test_torch_multihost.py).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from siriltpu_torch.parallel.mesh import (Mesh, Sharding, _rank, frames_sharding,
                                          group_up)
from siriltpu_torch.utils.interop import frames_from_numpy, u16_to_i32


def comm_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, the CPU under gloo."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None, *, backend: Optional[str] = None) -> None:
    """Bring up the process group. Idempotent.

    ``coordinator_address``: ``host:port`` (rank 0 listens there), or an
    ``init_method`` URL (``tcp://host:port``, ``file:///path``); None reads
    the ``env://`` variables (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK),
    as ``torchrun`` sets them. ``backend`` defaults to NCCL, which needs a
    visible card: without one, pass ``backend="gloo"``. Under NCCL the
    process's card is ``local_device_ids[0]``, else rank modulo the visible
    cards."""
    import torch.distributed as dist

    if group_up():
        return
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: no CUDA device is visible for NCCL; pass "
                "backend='gloo' for a group on the CPU")
        backend = "nccl"
    if coordinator_address is None:
        method = "env://"
    elif "://" in coordinator_address:
        method = coordinator_address
    else:
        method = f"tcp://{coordinator_address}"
    if backend == "nccl":
        ids = list(local_device_ids or [])
        rank = process_id if process_id is not None else 0
        torch.cuda.set_device(ids[0] if ids else rank % torch.cuda.device_count())
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=method, **kwargs)


def spans_group(mesh: Mesh) -> bool:
    """Whether work over ``mesh`` is combined across processes: True when
    a group is up and the mesh holds every process's entries (world size 1
    included), False for a mesh of this process alone. A mesh that holds
    some processes but not all is refused."""
    import torch.distributed as dist

    if not group_up():
        return False
    owners = set(np.unique(mesh.ranks).tolist())
    if owners == set(range(dist.get_world_size())):
        return True
    if owners == {dist.get_rank()}:
        return False
    raise ValueError(f"mesh entries of processes {sorted(owners)} in a group of "
                     f"{dist.get_world_size()}")


def local_frame_indices(sharding: Sharding, global_shape: Tuple[int, ...], *,
                        rank: Optional[int] = None) -> List[int]:
    """Global frame indices (axis 0 of ``global_shape``) that THIS
    process's (or process ``rank``'s) mesh entries consume under
    ``sharding``, sorted.

    Each process reads exactly these frames from its copy of the sequence
    (or its shard of a distributed filesystem) and feeds them to
    ``global_frames_from_local``."""
    frames: set = set()
    for index in sharding.indices_map(tuple(global_shape), rank).values():
        frames.update(range(index[0].start, index[0].stop))
    return sorted(frames)


def global_frames_from_local(sharding: Sharding, local_frames: np.ndarray,
                             global_shape: Tuple[int, ...]) -> torch.Tensor:
    """The global (F, H, W) uint16 frames on this process's first mesh
    entry's device, assembled from every process's local frames (stacked
    in ``local_frame_indices`` order) with one ``all_gather`` of the frames
    and one of their indices."""
    import torch.distributed as dist

    mesh = sharding.mesh
    device = mesh.devices[mesh.ranks == _rank()][0]
    mine = local_frame_indices(sharding, global_shape)
    local = np.ascontiguousarray(local_frames, dtype=np.uint16)
    if len(local) != len(mine):
        raise ValueError(f"{len(local)} local frames for indices {mine}")
    cd = comm_device() if group_up() else torch.device("cpu")
    # collectives take no uint16: the words cross as int32
    data = u16_to_i32(frames_from_numpy(local, cd))
    idx = torch.tensor(mine, dtype=torch.int64, device=cd)
    datas, idxs = [data], [idx]
    if group_up():
        world = dist.get_world_size()
        datas = [torch.empty_like(data) for _ in range(world)]
        idxs = [torch.empty_like(idx) for _ in range(world)]
        dist.all_gather(datas, data)
        dist.all_gather(idxs, idx)
        del data
    out = torch.empty(tuple(global_shape), dtype=torch.int16, device=device)
    for d, i in zip(datas, idxs):
        out[i.to(device)] = d.to(device).to(torch.int16)
    return out.view(torch.uint16)


def make_multihost_register_stack(mesh: Mesh, sel: Tuple[int, int, int],
                                  rejection: str = "sigma", sig=(3.0, 3.0)):
    """Fused register + rejection stack over a (possibly multi-process)
    ``frames`` mesh with per-process input feeding.

    Returns ``run(read_frame, nframes, (h, w)) -> np.ndarray`` where
    ``read_frame(i)`` produces global frame ``i`` as (H, W) uint16, called
    only for this process's own indices. The stacked (H, W) uint16 result
    is returned, the same on every process."""
    from siriltpu_torch.parallel.sharded import sharded_register_stack

    sharding = frames_sharding(mesh)
    nmesh = mesh.shape["frames"]

    def run(read_frame: Callable[[int], np.ndarray], nframes: int,
            hw: Tuple[int, int]) -> np.ndarray:
        if nframes % nmesh:
            raise ValueError(
                f"{nframes} frames not divisible by the {nmesh}-way frames "
                f"mesh; pad or filter the sequence to a multiple")
        h, w = hw
        gshape = (nframes, h, w)
        mine = local_frame_indices(sharding, gshape)
        local = np.stack([np.asarray(read_frame(i), dtype=np.uint16)
                          for i in mine])
        frames = global_frames_from_local(sharding, local, gshape)
        out, _ = sharded_register_stack(mesh, sel, rejection, sig, frames)
        return out

    return run


__all__ = ["init_distributed", "local_frame_indices", "global_frames_from_local",
           "make_multihost_register_stack", "comm_device", "spans_group",
           "group_up"]
