"""Device selection: entry points run on CUDA unless the caller asks
for the CPU (``device_type="cpu"``). Asking for CUDA on a machine
without a card raises; nothing falls back to the CPU quietly. The card
is the current CUDA device: under ``torchrun`` (``LOCAL_RANK`` set),
network.py ``ensure_distributed`` makes it ``cuda:{LOCAL_RANK}`` when
it sets up the group; a caller that sets up the group sets the device
too."""
from __future__ import annotations

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
