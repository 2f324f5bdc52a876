"""Device selection: entry points run on CUDA unless the caller asks
for the CPU (``device_type="cpu"``). Asking for CUDA on a machine
without a card raises; nothing falls back to the CPU quietly. The card
is the current CUDA device: under ``torchrun`` (``LOCAL_RANK`` set),
network.py ``ensure_distributed`` makes it ``cuda:{LOCAL_RANK}`` when
it sets up the group; a caller that sets up the group sets the device
too.

The port's explicit sync channel lives here too: ``device_get`` is the
one counted blocking device -> host read (the learners' per-split and
per-tree reads, the evaluation read, the host-side refits' reads) and
``block_until_ready`` waits for a device's queued work (the telemetry
stream sync). ``start_read`` begins a copy without waiting (the
pipelined loop's evaluation scalars: a non-blocking copy into pinned
host memory and a CUDA event behind it); ``device_get`` of the returned
``PendingRead`` waits on that event, so the trailing read is counted
and traced like any other. Callers reach both through this module's
attributes (``device.device_get(t)``), so ``obs/trace.py
install_sync_tracing`` can patch them to time and attribute every such
block. ``upload`` is the other direction without a wait: host data into
pinned memory, then a non-blocking copy to the card (the per-round bag,
the per-tree feature masks).
"""
from __future__ import annotations

from typing import Any, List, Sequence, Union

import numpy as np
import torch

from . import log


def resolve_device(config) -> torch.device:
    """torch.device for ``config.device_type`` ("cuda" or "cpu")."""
    if config.device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        log.fatal("device_type=%s but no CUDA device is available; pass "
                  "device_type='cpu' to run on the CPU", config.device_type)
    return torch.device("cuda", torch.cuda.current_device())


class PendingRead:
    """A device -> host copy in flight (``start_read``): the pinned host
    tensor it lands in and the CUDA event recorded behind the copy on
    the current stream (None for a CPU tensor, whose copy is the tensor
    itself)."""
    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event) -> None:
        self.host = host
        self.event = event

    @property
    def nbytes(self) -> int:
        return self.host.numel() * self.host.element_size()


def start_read(t: torch.Tensor) -> PendingRead:
    """Start the host copy of ``t`` without waiting for it: on the card
    one non-blocking copy into pinned host memory, ordered after the
    kernels queued before it, so later in-place updates of ``t``'s
    sources cannot reach it. ``device_get`` of the result waits."""
    t = t.detach()
    if t.device.type != "cuda":
        return PendingRead(t, None)
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return PendingRead(host, event)


def device_get(t: Union[torch.Tensor, Sequence[torch.Tensor], PendingRead]
               ) -> Union[np.ndarray, List[np.ndarray]]:
    """Host numpy copy of a tensor (or of each tensor of a list or
    tuple): one blocking read when the tensor lies on the card; of a
    ``PendingRead``, the wait for its copy."""
    if isinstance(t, PendingRead):
        if t.event is not None:
            t.event.synchronize()
        t = t.host
    if isinstance(t, (list, tuple)):
        return [x.detach().cpu().numpy() for x in t]
    return t.detach().cpu().numpy()


def block_until_ready(device: Any) -> None:
    """Wait until every kernel queued on ``device`` has finished (a
    no-op for the CPU, whose work is done when the call returns)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def upload(arr: Any, device: Any, dtype: Any = None) -> torch.Tensor:
    """``arr`` (numpy or a CPU tensor) as a tensor on ``device`` without
    waiting for the card: on CUDA one copy into pinned host memory and a
    non-blocking copy on the current stream (the caching host allocator
    keeps the pinned block until that copy has run), so the stream's
    queued work is not drained; on the CPU ``torch.as_tensor``."""
    t = torch.as_tensor(arr, dtype=dtype)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)
