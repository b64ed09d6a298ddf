"""Carry trained weights from the JAX package to the port.

`params_from_jax` takes the JAX `params` tree with NumPy leaves
({"model": ..., "fusion": ...}, as `imm_tsf_tpu.training.trainer.
init_state` returns it or an orbax checkpoint restores it), and the
`stats` tree beside it, and returns the port's (model_state_dict,
fusion_state_dict):

  - flax Dense `kernel [in, out]` -> torch Linear `weight [out, in]`;
  - LayerNorm `scale` -> `weight`, `bias` -> `bias`;
  - flat Dense pairs (the continuous-time models' `ode/nets.py`
    `dense_params`: `<name>_kernel [in, out]` beside `<name>_bias`) ->
    torch Linear `<name>.weight [out, in]` and `<name>.bias`;
  - raw parameters (the GRU's `gru_*` tensors in their [in, 3H] layout,
    `log_recency_sigma`, CRU's `enc_ln0_scale`, `tm_11_basis`,
    `log_transition_noise` and the like) keep their names and meaning;
  - Conv `kernel [k, in, out]` -> torch Conv1d `weight [out, in, k]` (the
    same reversal of the axes as a Dense kernel's);
  - BatchNorm `scale`/`bias` -> `weight`/`bias`, and its `batch_stats`
    `mean`/`var` (the JAX trainer's `stats` tree) -> the buffers
    `running_mean`/`running_var`.

Flax names the attention blocks by creation order, `AttentionLayer_<i>`,
and the layers `enc_layer_<i>`, `conv_layer_<i>` and `dec_layer_<i>`, all
at the model's top level; the port nests them (`_model_renames`):
PatchTST's and Informer's encoder layers and their attention under
`encoder.layers.<i>`, Informer's distilling convs under
`encoder.conv_layers.<i>`, and, after the e_layers encoder blocks, each
decoder layer's self- and cross-attention (two blocks a layer, in that
order) under `decoder.layers.<j>`.

tPatchGNN builds its three nn.Sequentials (`filter_generators`, each
graph layer's `nodevec_gate{1,2}_<l>`, `decoder`) from Denses it creates
itself, so flax binds those to the model as `Dense_<i>`, numbered in
creation order (`_sequential_dense`); the port keeps the Sequentials,
whose Linear layers sit at their list index. Its blocks `tf_<l>_<t>`
(with `self_attn`), `T_bias`, `nodevec1`, `nodevec2` and the CNN
`temporal_agg` Conv need no rename, nor do the flat pairs and raw
tensors of the LatentODE (`rec_ode_func_in`, `gru_update1`, ...) and
NeuralFlow (the flows' `<flow>_l<i>_latent_fc<j>` pairs and time-net
`<flow>_l<i>_time_w` vectors, `lstm_ih`, `lstm_hh`).

TimesNet, TimeMixer and TTM need no rename: the port's modules carry
flax's names (`times_block_<i>`, `pdm_block_<b>.season_down_<i>`,
`encoder.ap_block_<j>.mixer_<i>.patch_mixer...`). TimesNet's inception
leaves `conv{1,2}_kernel_<i>` [k, k, in, out] keep their flax layout; its
forward takes the fused kernel to torch's Conv2d [out, in, kh, kw] by
permute(3, 2, 0, 1), a layout change and no flip. TimeMixer's
`down_conv_<i>` kernel [3, in, out] is a Conv like any other.

TimeLLM's frozen GPT-2 (`frozen_llm.h_<i>`) nests as `frozen_llm.h.<i>`,
as `gpt2_params_from_jax` renames it, and its frozen BERT or Llama
(`frozen_llm.layer_<i>`) as `frozen_llm.layers.<i>`, as
`bert_params_from_jax` and `llama_params_from_jax` rename them; its
`mapping_layer` kernel [vocab, ts_vocab] becomes a weight [ts_vocab,
vocab] like any Dense kernel; a bfloat16 leaf (`frozen_param_dtype`)
converts exactly to float32, and a leaf in flax's partitioning box (the
Llama projections' `nn.with_partitioning`) is unboxed.

`assign_flax_sites` gives every Dropout of a port module tree its flax
scope path, for dropout_impl="flax" (layers/fast_dropout.py), by the
same names read the other way: an encoder or decoder layer's attention
dropout sits in its inner attention, which flax binds to the model as
`<class>_<i>` (FullAttention_0, ProbAttention_3: numbered a class, in the
order of `_attention_block`); the layers' own dropout is a fresh flax
module a call (`Dropout_<k>` in `enc_layer_<i>` / `dec_layer_<j>`);
every other site keeps its port path with its last name made flax's
(`dropout` and `head_dropout` -> `Dropout_0`, `dropout<k>` ->
`Dropout_<k - 1>`), one module whose make_rng counter counts its calls.

`gpt2_params_from_jax` carries a flax `GPT2Model` param tree (the JAX
package's frozen LLM) into the port's `llm.gpt2.GPT2Model` state dict:
Embed `embedding` -> `weight` (not transposed), blocks `h_<i>` -> `h.<i>`;
`bert_params_from_jax` and `llama_params_from_jax` do the same for the
flax `BertModel` and `LlamaModel` (`layer_<i>` -> `layers.<i>`). `port_keys`
gives the key map alone, so a tree of shapes can be checked without
materialising it.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER_RENAMES = (
    (re.compile(r"^enc_layer_(\d+)\."), r"encoder.layers.\1."),
    (re.compile(r"^conv_layer_(\d+)\."), r"encoder.conv_layers.\1."),
    (re.compile(r"^dec_layer_(\d+)\."), r"decoder.layers.\1."),
    (re.compile(r"^frozen_llm\.h_(\d+)\."), r"frozen_llm.h.\1."),  # TimeLLM's GPT-2
    (re.compile(r"^frozen_llm\.layer_(\d+)\."), r"frozen_llm.layers.\1."),  # BERT, Llama
)
_STATS_NAMES = {"mean": "running_mean", "var": "running_var"}
_GPT2_RENAMES = ((re.compile(r"^h_(\d+)\."), r"h.\1."),)
_LAYERS_RENAMES = ((re.compile(r"^layer_(\d+)\."), r"layers.\1."),)


def _flatten(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, path + ".")
        elif hasattr(v, "unbox"):  # flax's partitioning box (the Llama projections')
            yield path, v.unbox()
        else:
            yield path, v


def _attention_block(e_layers: int):
    """AttentionLayer_<i> -> its place: encoder layer i for i < e_layers,
    then each decoder layer's self- and cross-attention."""

    def repl(m) -> str:
        i = int(m.group(1))
        if i < e_layers:
            return f"encoder.layers.{i}.attention."
        j, cross = divmod(i - e_layers, 2)
        return f"decoder.layers.{j}.{'cross' if cross else 'self'}_attention."

    return repl


def _sequential_dense(n_layers: int):
    """tPatchGNN's Dense_<i> -> its place in the port's nn.Sequentials:
    filter_generators' three Denses, each graph layer's two gates, then
    the decoder's three (the torch Sequentials count their activations)."""

    def repl(m) -> str:
        i = int(m.group(1))
        if i < 3:
            return f"filter_generators.{2 * i}."
        layer, gate = divmod(i - 3, 2)
        if layer < n_layers:
            return f"nodevec_gate{gate + 1}_{layer}.0."
        return f"decoder.{2 * (i - 3 - 2 * n_layers)}."

    return repl


def _model_renames(tree: dict) -> tuple:
    """The renames of a flax backbone's tree: its encoder layers are the
    enc_layer_<i> it holds; tPatchGNN's graph layers the
    nodevec_linear1_<l>."""
    e_layers = sum(1 for k in tree if re.fullmatch(r"enc_layer_\d+", k))
    gnn_layers = sum(1 for k in tree if re.fullmatch(r"nodevec_linear1_\d+", k))
    gnn = ((re.compile(r"^Dense_(\d+)\."), _sequential_dense(gnn_layers)),) if gnn_layers else ()
    return ((re.compile(r"^AttentionLayer_(\d+)\."), _attention_block(e_layers)),
            *gnn, *_LAYER_RENAMES)


_INNER_ATTENTION = re.compile(
    r"^(encoder\.layers\.(\d+)\.attention|decoder\.layers\.(\d+)\.(self|cross)_attention)"
    r"\.inner$")
_LAYER_DROPOUT = re.compile(r"^(encoder|decoder)\.layers\.(\d+)\.dropout$")
_DROPOUT_NAME = re.compile(r"^(?:head_)?dropout(\d*)$")


def _flax_dropout_path(name: str, inner_names: dict) -> tuple[tuple, bool]:
    """(flax scope path, fresh) of the Dropout at port path `name` under a
    root module; inner_names maps each inner attention's port path to its
    flax name."""
    m = _LAYER_DROPOUT.match(name)
    if m:
        layer = ("enc" if m.group(1) == "encoder" else "dec") + f"_layer_{m.group(2)}"
        return (layer, "Dropout_0"), True
    parent, _, last = name.rpartition(".")
    if parent in inner_names:
        return (inner_names[parent], "Dropout_0"), False
    m = _DROPOUT_NAME.match(last)
    if m is None:
        raise ValueError(f"no flax name for the dropout site {name!r}")
    k = int(m.group(1)) - 1 if m.group(1) else 0
    return (*(parent.split(".") if parent else ()), f"Dropout_{k}"), False


def assign_flax_sites(root) -> list:
    """Set `impl` "flax", `flax_path` and `flax_fresh` on every Dropout
    under `root` (a backbone or the fusion stack: each is its own flax
    apply root); returns [(port path, flax path, fresh)]."""
    from .layers.fast_dropout import Dropout

    def order(item):  # _attention_block's: encoder layers, then each decoder layer's pair
        m = _INNER_ATTENTION.match(item[0])
        return (1, int(m.group(3)), m.group(4) == "cross") if m.group(3) else (0, int(m.group(2)))

    inners = sorted(((n, mod) for n, mod in root.named_modules() if _INNER_ATTENTION.match(n)),
                    key=order)
    inner_names, seen = {}, {}
    for n, mod in inners:
        cls = type(mod).__name__
        inner_names[n] = f"{cls}_{seen.get(cls, 0)}"
        seen[cls] = seen.get(cls, 0) + 1
    sites = []
    for n, mod in root.named_modules():
        if isinstance(mod, Dropout):
            mod.flax_path, mod.flax_fresh = _flax_dropout_path(n, inner_names)
            mod.impl = "flax"
            sites.append((n, mod.flax_path, mod.flax_fresh))
    return sites


def port_keys(tree: dict, renames=()) -> dict:
    """{flax leaf path: (the port's state-dict key, whether the leaf is
    transposed)} for a flax tree; reads only the tree's paths, so its
    leaves may be shapes (`jax.eval_shape`)."""
    paths = {path for path, _ in _flatten(tree)}
    keys = {}
    for path in paths:
        module, _, name = path.rpartition(".")
        transposed = False
        if name == "kernel":
            name, transposed = "weight", True
        elif name in ("scale", "embedding"):
            name = "weight"
        elif name.endswith("_kernel") and path[:-len("kernel")] + "bias" in paths:
            name, transposed = name[:-len("_kernel")] + ".weight", True
        elif name.endswith("_bias") and path[:-len("bias")] + "kernel" in paths:
            name = name[:-len("_bias")] + ".bias"
        key = f"{module}.{name}" if module else name
        for pattern, repl in renames:
            key = pattern.sub(repl, key)
        keys[path] = (key, transposed)
    return keys


def _convert(tree: dict, renames=()) -> dict:
    keys = port_keys(tree, renames)
    state = {}
    for path, leaf in _flatten(tree):
        key, transposed = keys[path]
        arr = np.asarray(leaf, dtype=np.float32)
        state[key] = torch.from_numpy(np.array(arr.T if transposed else arr))  # a writable copy
    return state


def _convert_stats(collections: dict, renames) -> dict:
    """A component's flax state collections ({"batch_stats": ...}) -> torch
    buffers: BatchNorm `mean`/`var` -> `running_mean`/`running_var`;
    the `constants` collection (TimeLLM's `domain_prompt_ids`) keeps its
    names and integer dtype."""
    state = {}
    for kind, tree in collections.items():
        if kind == "constants":
            state.update((path, torch.from_numpy(np.array(leaf)))
                         for path, leaf in _flatten(tree))
            continue
        for key, t in _convert(tree, renames).items():
            module, _, name = key.rpartition(".")
            state[f"{module}.{_STATS_NAMES.get(name, name)}"] = t
    return state


def params_from_jax(params_np: dict, stats_np: dict | None = None) -> tuple[dict, dict | None]:
    """The JAX trainer's (params, stats) trees (NumPy leaves, keyed by
    component as `init_state` returns them) -> (model_state_dict,
    fusion_state_dict). fusion_state_dict is None when the tree has no
    fusion subtree. stats_np carries the BatchNorm running statistics
    (Informer's distilling convs; the fusion modules have none); a
    BatchNorm it does not cover gets flax's init, mean 0 and var 1."""
    stats_np = stats_np or {}
    renames = _model_renames(params_np["model"])
    model = _convert(params_np["model"], renames)
    model.update(_convert_stats(stats_np.get("model") or {}, renames))
    for key in [k for k in model if re.fullmatch(r"encoder\.conv_layers\.\d+\.norm\.weight", k)]:
        base = key[:-len("weight")]
        model.setdefault(base + "running_mean", torch.zeros_like(model[key]))
        model.setdefault(base + "running_var", torch.ones_like(model[key]))
    fusion = params_np.get("fusion")
    return model, (_convert(fusion) if fusion else None)


def gpt2_params_from_jax(params_np: dict) -> dict:
    """flax GPT2Model params (NumPy leaves) -> llm.gpt2.GPT2Model state dict."""
    return _convert(params_np, _GPT2_RENAMES)


def bert_params_from_jax(params_np: dict) -> dict:
    """flax BertModel params (NumPy leaves) -> llm.bert.BertModel state dict."""
    return _convert(params_np, _LAYERS_RENAMES)


def llama_params_from_jax(params_np: dict) -> dict:
    """flax LlamaModel params (NumPy leaves) -> llm.llama.LlamaModel state
    dict (RMSNorm `scale` -> `weight`)."""
    return _convert(params_np, _LAYERS_RENAMES)
