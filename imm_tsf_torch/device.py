"""The device every entry point of the port runs on."""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger("imm_tsf_torch")


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


def resolve_run_device(device: str | torch.device | None, gpu: int = 0,
                       mesh_shape: tuple = ()) -> torch.device:
    """resolve_device, then the reference's `--gpu N` (CUDA device
    selection, reference main.py:752) as the JAX package applies it to a
    single-device run (imm_tsf_tpu/training/trainer.py:530-539, predict.py:
    68-77): a cuda device without an index, `gpu` set and no `mesh_shape`
    becomes cuda:<gpu>, made the current device, when the process sees more
    than `gpu` cards; with fewer it logs the JAX package's warning and stays
    on cuda:0. An explicit index (`--device cuda:0`) wins over `gpu`."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None or not gpu or mesh_shape:
        return dev
    n = torch.cuda.device_count()
    if gpu >= n:
        logger.warning("--gpu %d requested but only %d device(s) visible", gpu, n)
        return torch.device("cuda", 0)
    torch.cuda.set_device(gpu)
    return torch.device("cuda", gpu)
