"""Carry trained weights from the JAX package to the port.

`params_from_jax` takes the JAX `params` tree with NumPy leaves
({"model": ..., "fusion": ...}, as `imm_tsf_tpu.training.trainer.
init_state` returns it or an orbax checkpoint restores it) and returns
the port's (model_state_dict, fusion_state_dict):

  - flax Dense `kernel [in, out]` -> torch Linear `weight [out, in]`;
  - LayerNorm `scale` -> `weight`, `bias` -> `bias`;
  - flat Dense pairs (the continuous-time models' `ode/nets.py`
    `dense_params`: `<name>_kernel [in, out]` beside `<name>_bias`) ->
    torch Linear `<name>.weight [out, in]` and `<name>.bias`;
  - raw parameters (the GRU's `gru_*` tensors in their [in, 3H] layout,
    `log_recency_sigma`, CRU's `enc_ln0_scale`, `tm_11_basis`,
    `log_transition_noise` and the like) keep their names and meaning.

Flax names PatchTST's attention blocks `AttentionLayer_<i>` and its
encoder layers `enc_layer_<i>` at the model's top level; the port nests
both under `encoder.layers.<i>`.

`gpt2_params_from_jax` carries a flax `GPT2Model` param tree (the JAX
package's frozen LLM) into the port's `llm.gpt2.GPT2Model` state dict:
Embed `embedding` -> `weight` (not transposed), blocks `h_<i>` -> `h.<i>`.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_RENAMES = (
    (re.compile(r"^AttentionLayer_(\d+)\."), r"encoder.layers.\1.attention."),
    (re.compile(r"^enc_layer_(\d+)\."), r"encoder.layers.\1."),
)
_GPT2_RENAMES = ((re.compile(r"^h_(\d+)\."), r"h.\1."),)


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, path + ".")
        else:
            yield path, v


def _convert(tree: dict, renames=_RENAMES) -> dict:
    leaves = dict(_flatten(tree))
    state = {}
    for path, leaf in leaves.items():
        arr = np.asarray(leaf, dtype=np.float32)
        module, _, name = path.rpartition(".")
        if name == "kernel":
            name, arr = "weight", arr.T
        elif name in ("scale", "embedding"):
            name = "weight"
        elif name.endswith("_kernel") and path[:-len("kernel")] + "bias" in leaves:
            name, arr = name[:-len("_kernel")] + ".weight", arr.T
        elif name.endswith("_bias") and path[:-len("bias")] + "kernel" in leaves:
            name = name[:-len("_bias")] + ".bias"
        key = f"{module}.{name}" if module else name
        for pattern, repl in renames:
            key = pattern.sub(repl, key)
        state[key] = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
    return state


def params_from_jax(params_np: dict) -> tuple[dict, dict | None]:
    """JAX params tree (NumPy leaves) -> (model_state_dict, fusion_state_dict).
    fusion_state_dict is None when the tree has no fusion subtree."""
    fusion = params_np.get("fusion")
    return _convert(params_np["model"]), (_convert(fusion) if fusion else None)


def gpt2_params_from_jax(params_np: dict) -> dict:
    """flax GPT2Model params (NumPy leaves) -> llm.gpt2.GPT2Model state dict."""
    return _convert(params_np, _GPT2_RENAMES)
