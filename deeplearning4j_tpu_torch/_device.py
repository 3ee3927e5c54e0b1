"""Device resolution for the port's entry points: they run on the card
unless the caller asks for the CPU, and never move to the CPU by
themselves."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is False: no "
                "GPU here. Pass device='cpu' to run the plain PyTorch "
                "versions on the CPU.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"device {dev} is not supported: the port runs on "
                         "'cuda' or, when asked, on 'cpu'")
    return dev
