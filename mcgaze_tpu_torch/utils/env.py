"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device), refusing a CUDA device when there is no card:
    the entry points default to 'cuda' and never move to the CPU on their
    own; a caller who wants the CPU passes device='cpu'."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {device} requested but torch.cuda.is_available() is '
            "False; pass device='cpu' to run on the CPU")
    return device
