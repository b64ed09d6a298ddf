#!/usr/bin/env python3
"""The frozen LLMs' float32 drift in both packages, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_llm_drift.py

Takes chip_smoke.llm_drift_case for BERT, Llama and DeepSeek (each at full
width, 2 layers, vocab cut to 1024, weights from a seed; one bucket call
of 16 notes of 1-64 tokens), carries the weights to the JAX package's
BertModel / LlamaModel and prints one JSON line per LLM: the max |float32
- float64| of the JAX pooled notes and of the port's, both from the
port's float64 run, and the bound chip_smoke.py holds the card to, 4 x
JAX's distance + 1e-6 (chip_smoke.LLM_DRIFT_JAX / LLM_DRIFT_MAX). Takes
about 10 GB and a few minutes (the 4096-wide models in float32 and
float64).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import sys

import numpy as np
import torch
from torch import nn

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def flax_params(model: nn.Module) -> dict:
    """The port's BertModel / LlamaModel -> its flax params: Linear ->
    {"kernel" [in, out], "bias"}, LayerNorm and RMSNorm -> {"scale",
    ("bias")}, Embedding -> {"embedding"}; `layers.<i>` -> `layer_<i>`."""
    tree: dict = {}
    for name, m in model.named_modules():
        if not name:
            continue
        path = name.replace("layers.", "layer_").split(".")
        leaves = {}
        if isinstance(m, nn.Linear):
            leaves["kernel"] = m.weight.detach().numpy().T.copy()
        elif isinstance(m, nn.Embedding):
            leaves["embedding"] = m.weight.detach().numpy().copy()
        elif hasattr(m, "weight") and isinstance(m.weight, nn.Parameter):  # the norms
            leaves["scale"] = m.weight.detach().numpy().copy()
        else:
            continue
        if getattr(m, "bias", None) is not None:
            leaves["bias"] = m.bias.detach().numpy().copy()
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaves
    return tree


def drift(alias: str) -> dict:
    """max |float32 - float64 port| of the JAX package's and the port's
    pooled notes of llm_drift_case(alias)."""
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from imm_tsf_tpu.llm import bert as jbert
    from imm_tsf_tpu.llm import llama as jllama
    from imm_tsf_torch.convert import bert_params_from_jax

    model, ids, mask = cs.llm_drift_case(alias)
    want = cs.pooled_notes(copy.deepcopy(model).double(), ids, mask).numpy()
    got = cs.pooled_notes(model, ids, mask).numpy()
    params = flax_params(model)
    carried = bert_params_from_jax(params)  # the same key map as llama_params_from_jax
    assert all(torch.equal(carried[k], v) for k, v in model.state_dict().items())
    cfg = model.cfg
    jm = (jbert.BertModel(jbert.BertConfig(**dataclasses.asdict(cfg)), n_layers=len(model.layers))
          if alias == "BERT" else
          jllama.LlamaModel(jllama.LlamaConfig(**dataclasses.asdict(cfg)),
                            n_layers=len(model.layers)))

    @jax.jit
    def pooled(p, ids, mask):
        h = jm.apply({"params": p}, input_ids=ids, attn_mask=mask).astype(jnp.float32)
        m = mask[:, :, None].astype(h.dtype)
        return (h * m).sum(1) / jnp.clip(m.sum(1), 1e-6, None)

    jax_out = np.asarray(pooled(params, jnp.asarray(ids, jnp.int32), jnp.asarray(mask)),
                         np.float64)
    jax_d = float(np.abs(jax_out - want).max())
    return {"llm": alias, "layers": len(model.layers), "width": cfg.hidden_size,
            "rows": int(ids.shape[0]), "tokens": int(ids.shape[1]),
            "port_from_float64": float(np.abs(got - want).max()),
            "jax_from_float64": jax_d,
            "port_from_jax": float(np.abs(got - jax_out).max()),
            "largest_float64": float(np.abs(want).max()),
            "bound": 4 * jax_d + 1e-6}


def main() -> int:
    import chip_smoke as cs

    torch.set_num_threads(4)
    for alias in cs.LLM_ALIASES:
        print(json.dumps(drift(alias)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
