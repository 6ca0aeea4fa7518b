"""Device policy of the port: entry points run on the card unless the
caller asks for the CPU, and never fall back silently."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no card
    is present (pass device="cpu" to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and (dev.index or 0) >= torch.cuda.device_count():
        raise ValueError(f"no card {dev}: {torch.cuda.device_count()} "
                         f"present")
    return dev
