"""Device resolution for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Asking for
CUDA on a machine without a usable card is an error: there is no silent
CPU fallback, so a run can never report CPU work as the card's.
"""

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """'cuda' (the default), 'cuda:N' or 'cpu' -> a validated torch.device."""
    dev = torch.device(name)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but torch.cuda.is_available() is "
            f"False; pass --device cpu to run on the CPU")
    if dev.index is not None and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"device {name!r} requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s) exist")
    return dev
