"""Memory probing and stacking block budgeting.

Port of ``siriltpu.core.memory``.

Reference: ``get_available_memory_in_MB`` (src/core/utils.c:354) and the
stacking memory model
(stacking.c:1903-1915): rows per block =
memory_percent · available_MB / (rx · nb_frames · 2 bytes · nthreads).
"""

from __future__ import annotations

import torch


def get_available_memory_mb() -> int:
    """Available system memory in MB (MemAvailable from /proc/meminfo)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return 2048


def get_used_memory_mb() -> int:
    """Resident set size of this process in MB (update_used_memory)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return 0


def stacking_block_rows(rx: int, nb_frames: int, *,
                        memory_percent: float = 0.9,
                        nthreads: int = 1,
                        bytes_per_px: int = 2) -> int:
    """The reference's row budget (stacking.c:1906-1915), with the
    >=4-blocks-per-channel floor handled by the caller."""
    mem_bytes = get_available_memory_mb() * (1 << 20) * memory_percent
    rows = int(mem_bytes / (rx * nb_frames * bytes_per_px * max(nthreads, 1)))
    return max(rows, 1)


def get_device_memory_bytes(device) -> int:
    """Device memory free on a CUDA ``device`` right now
    (``torch.cuda.mem_get_info``); for the CPU, the available system
    memory."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return get_available_memory_mb() << 20


def starfind_chunk_frames(h: int, w: int, *, device, n_devices: int = 1,
                          nmax: int = 2048, box: int = 21) -> int:
    """Frames per device-resident star-find chunk, from the memory free on
    ``device`` (the registration analog of the reference's row-budget
    model, stacking.c:1903-1915): per frame the batched star finder holds
    the uint16 layer, ~4 f32 wavelet planes, the peak score map and the
    gathered PSF boxes; chunks are rounded to a multiple of the device
    count so frame shards stay even."""
    per_frame = h * w * (2 + 4 * 5) + nmax * box * box * 4
    budget = get_device_memory_bytes(device) * 0.35
    c = max(1, int(budget / per_frame))
    c = min(c, 64)
    if n_devices > 1:
        c = max(n_devices, (c // n_devices) * n_devices)
    return c


__all__ = ["get_available_memory_mb", "get_used_memory_mb", "stacking_block_rows",
           "get_device_memory_bytes", "starfind_chunk_frames"]
