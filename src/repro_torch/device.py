"""Where the port runs when the caller names no device: the current CUDA
device, or an error. The CPU is only ever a device the caller asks for."""

import torch

__all__ = ["default_device"]


def default_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the current CUDA device,
    and raises where there is none (``who`` names the caller)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on CUDA unless told otherwise, and no CUDA device is"
                " available; pass device='cpu' for the CPU path")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
