"""Device selection for the entry points: the card unless the caller asks
for something else, and an error — never the CPU — when there is no card."""

from __future__ import annotations

import torch


def require_device(device="cuda") -> torch.device:
    """`device` as a torch.device; raises if it names CUDA and no card is
    there.  Entry points call this on their `device` argument, whose
    default is "cuda": only a caller that passes device="cpu" runs there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "halo2_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
