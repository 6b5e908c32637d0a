"""Device resolution for the PyTorch port.

The caller names the device; nothing here guesses one.  ``"cuda"`` (or
``"cuda:N"``) without a usable GPU raises instead of quietly running on the
CPU, so a run that was meant for the card never reports CPU numbers.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The ``torch.device`` for ``device`` ("cuda", "cuda:N", "cpu" or a
    ``torch.device``); raises when that device cannot run here."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               "available")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {device!r} requested but only "
                               f"{torch.cuda.device_count()} GPU(s) present")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
