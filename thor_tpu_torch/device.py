"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU. There is
no silent fallback: asking for CUDA without a card raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda". Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_current(fn: str, dev: torch.device):
    """A kernel wrapper's check that its tensors lie on the current CUDA
    device: the kernels are ctypes calls that launch on the calling
    thread's current device, which must not read another card's memory."""
    cur = torch.cuda.current_device()
    if dev.index != cur:
        raise ValueError(f"{fn}: the tensors lie on {dev} but the current "
                         f"CUDA device is cuda:{cur}; call it under "
                         f"torch.cuda.device({dev})")
