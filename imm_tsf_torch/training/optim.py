"""The optimizer of the reference protocol (after imm_tsf_tpu/training/optim.py).

Reference (main.py:1024, 1092-1101): torch.optim.Adam(lr, weight_decay)
with the gradients clipped to a global norm of 1.0 before the step.
Torch's Adam adds weight_decay * param to the gradient (L2, not AdamW's
decoupled decay), which is the JAX package's optax chain: clip, then
add_decayed_weights, then scale_by_adam.
"""

from __future__ import annotations

import torch

FROZEN_SUBTREE = "frozen_llm"  # parameters under this name take no updates
# (reference freezes LLM params via requires_grad=False, load_llm.py:117-118)


def trainable_parameters(*modules) -> list[torch.nn.Parameter]:
    """Every parameter of `modules` (None skipped) outside a FROZEN_SUBTREE."""
    return [p for m in modules if m is not None for name, p in m.named_parameters()
            if FROZEN_SUBTREE not in name.split(".")]


def cast_frozen(module: torch.nn.Module, frozen_param_dtype: str) -> None:
    """Store every FROZEN_SUBTREE submodule's floats in bfloat16 when
    frozen_param_dtype is "bfloat16" (the JAX package's
    `_cast_frozen_params`): they take no updates, and each use upcasts them
    (llm/gpt2.py), so the arithmetic stays float32 on bf16-rounded weights."""
    if frozen_param_dtype == "bfloat16":
        for name, sub in module.named_modules():
            if name.split(".")[-1] == FROZEN_SUBTREE:
                sub.to(torch.bfloat16)


def make_optimizer(params, lr: float, w_decay: float) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=w_decay)


def clip_and_step(optimizer: torch.optim.Optimizer, params, clip_norm: float = 1.0) -> None:
    """Clip the gradients to a global norm of `clip_norm`, then step."""
    torch.nn.utils.clip_grad_norm_(params, clip_norm)
    optimizer.step()
