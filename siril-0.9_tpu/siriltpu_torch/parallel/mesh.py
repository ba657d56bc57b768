"""Device meshes, sharding descriptors and the frame-sharded map.

Port of ``siriltpu.parallel.mesh``. The reference is single-node
shared-memory OpenMP (SURVEY §2.9); its parallel patterns map onto a mesh
of devices as:

- P2 OpenMP-over-frames  -> data parallelism on a ``frames`` mesh axis
  (registration, star detection, the warp: :func:`run_frames_sharded`);
- P3 OpenMP-over-row-blocks -> spatial sharding on a ``rows`` axis
  (rejection stacking: every entry owns a row slab over ALL frames,
  ``parallel.sharded``);
- P6 streaming accumulation -> a per-shard accumulate plus one sum of the
  partials, ``torch.distributed.all_reduce`` across processes.

A :class:`Mesh` is a grid of ``torch.device`` entries with named axes, as
``jax.sharding.Mesh`` is. An entry may repeat a device: four entries on
``cuda:0`` run four shards one after the other on one card, the analog of
the JAX package's virtual CPU devices
(``xla_force_host_platform_device_count``). When a process group is up
(``parallel.multihost.init_distributed``), :func:`make_mesh` spans every
process: each process contributes its own devices, in rank order, and
``Mesh.ranks`` says which process owns each entry.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from siriltpu_torch.utils.interop import frames_from_numpy


def group_up() -> bool:
    """Whether a ``torch.distributed`` process group is up."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if group_up() else 0


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if group_up() else 1


class Mesh:
    """An n-d grid of devices with named axes.

    ``devices``: object array of ``torch.device``, of the mesh's shape;
    ``ranks``: int array of the same shape, the process that owns each
    entry (entries of other processes hold this process's devices in
    their places: only their owner runs them); ``shape``: axis name ->
    size, in axis order."""

    def __init__(self, devices, axis_names: Tuple[str, ...], ranks=None):
        devs = np.asarray(devices, dtype=object)
        self.devices = np.empty(devs.shape, dtype=object)
        for idx in np.ndindex(devs.shape):
            self.devices[idx] = torch.device(devs[idx])
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        self.ranks = (np.full(self.devices.shape, _rank(), dtype=np.int64)
                      if ranks is None else
                      np.asarray(ranks, dtype=np.int64).reshape(self.devices.shape))

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def is_local(self) -> bool:
        """Every entry belongs to this process."""
        return bool((self.ranks == _rank()).all())

    def axis_entries(self, axis: str):
        """(device, rank) of each position along ``axis``, the other axes
        at their first position: who runs that position's shard."""
        k = self.axis_names.index(axis)
        out = []
        for i in range(self.devices.shape[k]):
            idx = tuple(i if d == k else 0 for d in range(self.devices.ndim))
            out.append((self.devices[idx], int(self.ranks[idx])))
        return out

    def __repr__(self) -> str:
        return (f"Mesh(shape={self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]}, "
                f"ranks={self.ranks.ravel().tolist()})")


def make_mesh(axes: Tuple[str, ...] = ("frames",),
              shape: Optional[Tuple[int, ...]] = None,
              devices=None) -> Mesh:
    """Build a mesh over this process's ``devices`` (default: every
    visible CUDA device, or this process's own card when a process group
    is up; with none visible and no ``devices``, raises).

    Default: a 1-D mesh over all devices on the ``frames`` axis. Pass
    shape=(a, b) with axes=("frames", "rows") for 2-D layouts. A device
    may be listed more than once. With a process group up, the mesh holds
    every process's devices in rank order (each process passes the same
    number of devices) and ``shape`` counts them all."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices= (for "
                "example ['cpu'] * 8) for a mesh on the CPU")
        if group_up():
            # the card init_distributed pinned this process to: the other
            # cards belong to the other processes
            devices = [torch.device("cuda", torch.cuda.current_device())]
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    local = [torch.device(d) for d in np.asarray(devices, dtype=object).ravel()]
    world = _world()
    if world > 1:
        import torch.distributed as dist

        from siriltpu_torch.parallel.multihost import comm_device

        counts = [torch.zeros(1, dtype=torch.int64, device=comm_device())
                  for _ in range(world)]
        dist.all_gather(counts, torch.tensor([len(local)], dtype=torch.int64,
                                             device=comm_device()))
        counts = [int(c) for c in counts]
        if len(set(counts)) != 1:
            raise ValueError(f"processes pass different device counts {counts}")
    devs = np.empty(world * len(local), dtype=object)
    devs[:] = local * world
    ranks = np.repeat(np.arange(world), len(local))
    n = devs.size
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(devs.reshape(shape), axes, ranks.reshape(shape))


class Sharding(NamedTuple):
    """How an array lies on a mesh: ``spec[d]`` names the mesh axis that
    splits array dimension d (None: not split); dimensions past the spec
    are not split, and mesh axes the spec does not name replicate."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]

    def indices_map(self, global_shape: Tuple[int, ...], rank: Optional[int] = None):
        """{flat entry index: tuple of slices} of the entries of process
        ``rank`` (default: this one): the block of an array of
        ``global_shape`` that each of them holds."""
        rank = _rank() if rank is None else rank
        mesh = self.mesh
        out = {}
        for flat, idx in enumerate(np.ndindex(mesh.devices.shape)):
            if int(mesh.ranks[idx]) != rank:
                continue
            sl = []
            for d, n in enumerate(global_shape):
                axis = self.spec[d] if d < len(self.spec) else None
                if axis is None:
                    sl.append(slice(0, n))
                    continue
                k = mesh.axis_names.index(axis)
                parts = mesh.devices.shape[k]
                step = -(-n // parts)
                sl.append(slice(min(idx[k] * step, n), min((idx[k] + 1) * step, n)))
            out[flat] = tuple(sl)
        return out


def frames_sharding(mesh: Mesh) -> Sharding:
    """(F, H, W) arrays sharded along the frame axis."""
    return Sharding(mesh, ("frames", None, None))


def rows_sharding(mesh: Mesh, axis: str = "frames") -> Sharding:
    """(F, H, W) arrays sharded along rows (reusing the mesh axis)."""
    return Sharding(mesh, (None, axis, None))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def pad_frames_to_mesh(nframes: int, mesh: Mesh, axis: str = "frames") -> int:
    """Padded frame count divisible by the mesh axis size."""
    n = mesh.shape[axis]
    return ((nframes + n - 1) // n) * n


def _pad(a, pad: int):
    """``a`` (a NumPy array or a tensor) zero-padded by ``pad`` frames;
    uint16 tensors are padded as their int16 view."""
    if isinstance(a, torch.Tensor):
        raw = a.view(torch.int16) if a.dtype == torch.uint16 else a
        if pad:
            raw = torch.cat([raw, raw.new_zeros((pad,) + tuple(raw.shape[1:]))])
        return raw
    a = np.asarray(a)
    if pad:
        a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])
    return a


def _cut(a, start: int, stop: int, device, u16: bool) -> torch.Tensor:
    """Frames [start, stop) of a padded array as a tensor on ``device``
    (uint16 stays uint16)."""
    if isinstance(a, torch.Tensor):
        part = a[start:stop].to(device)
        return part.view(torch.uint16) if u16 else part
    part = a[start:stop]
    if part.dtype == np.uint16:
        return frames_from_numpy(part, device)
    return torch.from_numpy(np.ascontiguousarray(part)).to(device)


def _cat(parts, device):
    """Concatenate per-shard outputs along their first axis, pytree-wise:
    tensors (on ``device``), lists, and tuples and dicts of them."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        if first.dtype == torch.uint16:
            return torch.cat([p.view(torch.int16).to(device)
                              for p in parts]).view(torch.uint16)
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, list):
        return [x for p in parts for x in p]
    if isinstance(first, tuple):
        return tuple(_cat([p[i] for p in parts], device) for i in range(len(first)))
    if isinstance(first, dict):
        return {k: _cat([p[k] for p in parts], device) for k in first}
    raise TypeError(f"cannot concatenate shard outputs of type {type(first)}")


def _trim(out, f: int):
    if isinstance(out, tuple):
        return tuple(_trim(o, f) for o in out)
    if isinstance(out, dict):
        return {k: _trim(v, f) for k, v in out.items()}
    return out[:f]


def run_frames_sharded(fn, mesh: Mesh, *arrays, out_device=None):
    """Run ``fn(*arrays)`` with every array's leading (frames) axis
    sharded over ``mesh``, partition-invariantly.

    The frame axis is zero-padded to a multiple of the mesh's ``frames``
    size and cut into contiguous shards in mesh order; each shard (NumPy
    arrays and tensors alike) becomes a tensor on its entry's device and
    ``fn`` runs on it there. The outputs (tensors, lists, or tuples and
    dicts of them) are concatenated in mesh order, tensors on
    ``out_device`` (default: the first entry's device), and trimmed back.
    ``fn`` must be frame-local (no cross-frame math): then sharded ==
    unsharded bit for bit, the analog of the reference's
    frame-independent OpenMP registration loop (registration.c:276-279).
    Every entry of ``mesh`` must belong to this process."""
    if not mesh.is_local():
        raise ValueError("run_frames_sharded needs a mesh of this process's "
                         "devices; across processes use "
                         "parallel.multihost.make_multihost_register_stack")
    entries = mesh.axis_entries("frames")
    f = int(arrays[0].shape[0])
    fp = pad_frames_to_mesh(f, mesh)
    per = fp // len(entries)
    u16 = [isinstance(a, torch.Tensor) and a.dtype == torch.uint16 for a in arrays]
    padded = [_pad(a, fp - f) for a in arrays]
    outs = []
    for j, (dev, _) in enumerate(entries):
        shard = [_cut(a, j * per, (j + 1) * per, dev, u)
                 for a, u in zip(padded, u16)]
        outs.append(fn(*shard))
    dev0 = entries[0][0] if out_device is None else torch.device(out_device)
    return _trim(_cat(outs, dev0), f)


__all__ = ["Mesh", "Sharding", "make_mesh", "frames_sharding", "rows_sharding",
           "replicated", "pad_frames_to_mesh", "run_frames_sharded"]
