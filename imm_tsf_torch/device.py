"""The device every entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """cuda unless the caller asks otherwise; never a silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run on the CPU")
        # the port's comparisons are float32 comparisons: no TF32 anywhere
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # cuDNN's convolution backward may sum with atomics, in an order
        # that changes from run to run (Informer's convs, TimesNet's): its
        # deterministic algorithms keep a run, a resumed run and the epoch
        # loop's captured steps equal to the streaming loop bit for bit
        torch.backends.cudnn.deterministic = True
    return dev
