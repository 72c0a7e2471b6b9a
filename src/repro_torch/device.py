"""Where an entry point of the port runs: ``"cuda"`` unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` needs a card: without
    one this raises instead of carrying on on the CPU."""

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return dev
