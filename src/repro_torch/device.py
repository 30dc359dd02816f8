"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The port runs on the card unless the caller asks for the CPU: a CUDA
    device without a card raises instead of carrying on on the CPU.
    ``"meta"`` (shapes only: the dry run) is taken when asked for by name,
    never as a fallback."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device available; pass device='cpu' to run "
            "the port on the CPU (its plain PyTorch kernel versions)")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev
