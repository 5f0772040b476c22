"""Where the port's entry points run.

Entry points take ``device=None`` and run on the card.  The CPU is used
only when the caller asks for it (``device="cpu"``, ``--device cpu``);
without a card and without that request they raise instead of moving.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu "
            "on the command line) to run the port on the CPU")
    return dev
