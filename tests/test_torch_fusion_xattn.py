"""The second fusion pair, the port against the JAX package, on the CPU:
`MultiHeadAttention` (with all-padded key rows: zeros, not NaN),
`Time2Vec`, `TTF_T2V_XAttn` on notes 16 and 24 wide into d_txt 16 (with a
note-free sample), `MMF_XAttn_Add`, and `FusionModel` for all four TTF x
MMF pairs: forward to 2e-5 absolute (float32, torch vs XLA summation
order) and every parameter's gradient of sum(out * g) to 1e-4 + 1e-4|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.fusion import mmf as jmmf
from imm_tsf_tpu.fusion import ttf as jttf
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.layers import attention as jattn

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.fusion import mmf, ttf
from imm_tsf_torch.fusion.fusion_model import FusionModel
from imm_tsf_torch.layers.attention import MultiHeadAttention

torch.set_num_threads(1)

ATOL = 2e-5
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
D_TXT, D_MODEL_LLM = 16, 768


def _state(variables):
    state, _ = params_from_jax({"model": jax.tree_util.tree_map(np.asarray,
                                                                variables["params"])})
    return state


def _notes(width, B=4, N=5, T_f=6, seed=0):
    """Ragged notes `width` wide: sample 0 has 2 notes, sample 2 none."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, N), np.float32)
    mask[0, 2:] = 0.0
    mask[2] = 0.0
    notes = rng.standard_normal((B, N, width)).astype(np.float32) * mask[:, :, None]
    tau = np.sort(rng.uniform(0, 5, (B, N)).astype(np.float32), axis=1) * mask
    t_hat = np.tile(np.linspace(5.0, 7.0, T_f, dtype=np.float32), (B, 1))
    return notes, tau, t_hat, mask


def test_multi_head_attention_matches_jax_and_pads_to_zeros():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((3, 4, 16)).astype(np.float32)
    kv = rng.standard_normal((3, 6, 16)).astype(np.float32)
    pad = np.zeros((3, 6), bool)
    pad[0, 3:] = True
    pad[1] = True  # every key padded: the attention gives zeros
    jm = jattn.MultiHeadAttention(16, 2, 0.1)
    v = jm.init(jax.random.PRNGKey(0), q, kv, kv, key_padding_mask=pad)
    tm = MultiHeadAttention(16, 2, 0.1).eval()
    tm.load_state_dict(_state(v))
    want = np.asarray(jm.apply(v, q, kv, kv, key_padding_mask=pad))
    with torch.inference_mode():
        got = tm(T(q), T(kv), T(kv), key_padding_mask=T(pad)).numpy()
        out_b = tm.out_proj.bias.numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1], np.broadcast_to(out_b, (4, 16)), atol=0, rtol=0)
    assert np.isfinite(got).all()
    # torch nn.MultiheadAttention's init: zero biases, in-projections within
    # the joint xavier bound
    init = MultiHeadAttention(16, 2)
    assert float(init.q_proj.bias.detach().abs().max()) == 0.0
    assert float(init.k_proj.weight.detach().abs().max()) <= (6 / 64) ** 0.5


def test_time2vec_matches_jax():
    x = np.random.default_rng(2).uniform(0, 5, (3, 5, 1)).astype(np.float32)
    jm = jttf.Time2Vec(8)
    v = jm.init(jax.random.PRNGKey(1), x)
    tm = ttf.Time2Vec(8)
    tm.load_state_dict(_state(v))
    with torch.inference_mode():
        got = tm(T(x)).numpy()
    assert got.shape == (3, 5, 8)
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, x)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("width", [16, 24])
def test_ttf_t2v_xattn_takes_any_note_width(width):
    notes, tau, t_hat, mask = _notes(width)
    jm = jttf.TTF_T2V_XAttn(d_txt=D_TXT, d_model_llm=D_MODEL_LLM, n_heads_fusion=2)
    v = jm.init({"params": jax.random.PRNGKey(2)}, notes, tau, t_hat, mask)
    assert v["params"]["input_proj"]["kernel"].shape == (width, D_TXT)
    tm = ttf.TTF_T2V_XAttn(D_TXT, D_MODEL_LLM, n_heads_fusion=2, d_notes=width).eval()
    tm.load_state_dict(_state(v))
    E_j, M_j = jm.apply(v, notes, tau, t_hat, mask)
    with torch.inference_mode():
        E_t, M_t = tm(*(T(a) for a in (notes, tau, t_hat, mask)))
    assert E_t.shape == (4, 6, D_TXT)
    np.testing.assert_array_equal(M_t.numpy(), np.asarray(M_j))
    assert not bool(M_t[2])  # the note-free sample
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), atol=ATOL, rtol=0)


def test_mmf_xattn_add_matches_jax():
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((4, 6, 3)).astype(np.float32)
    E = rng.standard_normal((4, 6, D_TXT)).astype(np.float32)
    M = np.asarray([[True], [True], [False], [True]])
    jm = jmmf.MMF_XAttn_Add(d_txt=D_TXT, C=3, d_attn=D_TXT, n_heads_fusion=2, kappa=0.5)
    v = jm.init(jax.random.PRNGKey(3), Y, E, M)
    tm = mmf.MMF_XAttn_Add(D_TXT, 3, D_TXT, n_heads_fusion=2, kappa=0.5).eval()
    tm.load_state_dict(_state(v))
    with torch.inference_mode():
        got = tm(T(Y), T(E), T(M)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply(v, Y, E, M)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[2], Y[2] / 1.5, rtol=1e-6)  # no text: Y / (1 + kappa)


PAIRS = [(t, m) for t in ("TTF_RecAvg", "TTF_T2V_XAttn") for m in ("MMF_GR_Add", "MMF_XAttn_Add")]


@pytest.mark.parametrize("ttf_name,mmf_name", PAIRS)
def test_fusion_model_pairs_match_jax_forward_and_gradients(ttf_name, mmf_name):
    kw = dict(input_dim=3, d_txt=D_TXT, llm_model_fusion="GPT2", TTF_module=ttf_name,
              MMF_module=mmf_name, n_heads_fusion=2, kappa=0.7, recency_sigma=1.3,
              dropout=0.1)
    notes, tau, t_hat, mask = _notes(24, seed=4)
    rng = np.random.default_rng(5)
    Y = rng.standard_normal((4, 6, 3)).astype(np.float32)
    g = rng.standard_normal((4, 6, 3)).astype(np.float32)
    ins = (notes, tau, t_hat, Y, mask)
    jm = JFusionModel(JConfig(**kw))
    v = jm.init({"params": jax.random.PRNGKey(6)}, *ins)
    _, fstate = params_from_jax({"model": {}, "fusion": jax.tree_util.tree_map(
        np.asarray, v["params"])})
    tm = FusionModel(TConfig(**kw), d_notes=24).eval()
    tm.load_state_dict(fstate)

    want = np.asarray(jm.apply(v, *ins))
    out = tm(*(T(a) for a in ins))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL, rtol=0)
    # the note-free sample: Y itself, or Y / (1 + kappa)
    if mmf_name == "MMF_GR_Add":
        np.testing.assert_array_equal(out.detach().numpy()[2], Y[2])
    else:
        np.testing.assert_allclose(out.detach().numpy()[2], Y[2] / (1 + kw["kappa"]), rtol=1e-6)

    jgrads = jax.grad(lambda p: jnp.sum(jm.apply({"params": p}, *ins) * g))(v["params"])
    _, want_g = params_from_jax({"model": {}, "fusion": jax.tree_util.tree_map(
        np.asarray, jgrads)})
    (out * T(g)).sum().backward()
    got_g = {n: p.grad for n, p in tm.named_parameters()}
    assert set(got_g) == set(want_g)
    for n, w in want_g.items():
        np.testing.assert_allclose(got_g[n].numpy(), w.numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=n)
