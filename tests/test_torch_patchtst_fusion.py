"""The port's PatchTST, TTF_RecAvg, MMF_GR_Add and FusionModel against
the JAX modules, in eval, with weights carried across by
convert.params_from_jax. Forwards agree to 2e-5 absolute, the bar of
tests/test_model_parity.py:81 (float32, torch vs XLA summation order)."""

import jax
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.fusion.mmf import MMF_GR_Add as JMMF
from imm_tsf_tpu.fusion.ttf import TTF_RecAvg as JTTF
from imm_tsf_tpu.models import get_model as j_get_model

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.fusion.fusion_model import FusionModel
from imm_tsf_torch.fusion.mmf import MMF_GR_Add
from imm_tsf_torch.fusion.ttf import TTF_RecAvg
from imm_tsf_torch.models import get_model

torch.set_num_threads(1)

ATOL = 2e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _convert_one(params):
    """Convert a bare module's params via the {"model": ...} entry point."""
    state, _ = params_from_jax({"model": _np_tree(params)})
    return state


def _model_batch(rng, B, L, Lp, K):
    obs = rng.standard_normal((B, L, K)).astype(np.float32)
    mask = (rng.random((B, L, K)) < 0.8).astype(np.float32)
    tp = np.sort(rng.uniform(0, 0.5, (B, L)), axis=1).astype(np.float32)
    tpp = np.sort(rng.uniform(0.5, 1.0, (B, Lp)), axis=1).astype(np.float32)
    obs[-1] = mask[-1] = tp[-1] = 0.0  # an all-zero padded batch row
    return tpp, obs * mask, tp, mask


def _cfg_kw(**kw):
    base = dict(model="PatchTST", e_layers=2, d_model=32, d_ff=64, n_heads=2,
                input_dim=3, input_len=16, pred_len=8, dropout=0.1)
    base.update(kw)
    return base


@pytest.mark.parametrize("activation", ["gelu", "relu"])
@pytest.mark.parametrize("fused", [False, True])
def test_patchtst_matches_jax(activation, fused):
    kw = _cfg_kw(activation=activation, use_fused_ffn=fused)
    jmodel = j_get_model(JConfig(**kw))
    tmodel = get_model(TConfig(**kw)).eval()
    rng = np.random.default_rng(0)
    batch = _model_batch(rng, B=4, L=16, Lp=8, K=3)
    variables = jmodel.init({"params": jax.random.PRNGKey(1)}, *batch)
    tmodel.load_state_dict(_convert_one(variables["params"]))
    want = np.asarray(jmodel.apply(variables, *batch, train=False))
    with torch.inference_mode():
        got = tmodel(*(torch.from_numpy(a) for a in batch)).numpy()
    assert got.shape == want.shape == (4, 8, 3)
    assert np.isfinite(got).all()  # the all-zero padded row included
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # shorter inputs are zero-padded to input_len/pred_len like the JAX model
    short = (batch[0][:, :5], batch[1][:, :11], batch[2][:, :11], batch[3][:, :11])
    want_s = np.asarray(jmodel.apply(variables, *short, train=False))
    with torch.inference_mode():
        got_s = tmodel(*(torch.from_numpy(np.ascontiguousarray(a)) for a in short)).numpy()
    np.testing.assert_allclose(got_s, want_s, atol=ATOL, rtol=0)


def test_unported_model_raises():
    # every backbone is ported now: the last three build; an unknown name raises
    for name in ("tPatchGNN", "LatentODE", "NeuralFlow"):
        assert type(get_model(TConfig(model=name, input_dim=3))).__name__.lower() == name.lower()
    with pytest.raises(ValueError, match="Unknown model"):
        get_model(TConfig(model="NoSuchModel"))


def _fusion_inputs(fb, C=3):
    rng = np.random.default_rng(3)
    T = fb["t_hat"].shape[1]
    Y = rng.standard_normal((fb["notes"].shape[0], T, C)).astype(np.float32)
    return fb["notes"], fb["tau"], fb["t_hat"], Y, fb["notes_mask"]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_ttf_recavg_matches_jax(ragged_fusion_batch, use_pallas):
    notes, tau, t_hat, _, nmask = _fusion_inputs(ragged_fusion_batch)
    d_txt = notes.shape[-1]
    jm = JTTF(d_txt=d_txt, d_model_llm=d_txt, recency_sigma=0.7, use_pallas=use_pallas)
    v = jm.init({"params": jax.random.PRNGKey(2)}, notes, tau, t_hat, nmask)
    tm = TTF_RecAvg(d_txt, d_txt, recency_sigma=0.7, use_pallas=use_pallas).eval()
    tm.load_state_dict(_convert_one(v["params"]))
    E_j, M_j = jm.apply(v, notes, tau, t_hat, nmask)
    with torch.inference_mode():
        E_t, M_t = tm(*(torch.from_numpy(a) for a in (notes, tau, t_hat, nmask)))
    np.testing.assert_array_equal(M_t.numpy(), np.asarray(M_j))
    np.testing.assert_allclose(E_t.numpy(), np.asarray(E_j), atol=ATOL, rtol=0)


def test_mmf_gr_add_matches_jax_and_passes_no_text_through():
    rng = np.random.default_rng(4)
    B, T, C, d_txt = 3, 6, 4, 8
    Y = rng.standard_normal((B, T, C)).astype(np.float32)
    E = rng.standard_normal((B, T, d_txt)).astype(np.float32)
    M = np.asarray([[True], [True], [False]])
    jm = JMMF(d_txt=d_txt, C=C, hidden_dim=C)
    v = jm.init({"params": jax.random.PRNGKey(5)}, Y, E, M)
    tm = MMF_GR_Add(d_txt, C, C).eval()
    tm.load_state_dict(_convert_one(v["params"]))
    want = np.asarray(jm.apply(v, Y, E, M))
    with torch.inference_mode():
        got = tm(*(torch.from_numpy(a) for a in (Y, E, M))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[2], Y[2])  # gate 1: exactly the base forecast


@pytest.mark.parametrize("use_pallas", [False, True])
def test_fusion_model_matches_jax(ragged_fusion_batch, use_pallas):
    notes, tau, t_hat, Y, nmask = _fusion_inputs(ragged_fusion_batch)
    kw = dict(input_dim=3, enable_text=True, TTF_module="TTF_RecAvg",
              MMF_module="MMF_GR_Add", d_txt=notes.shape[-1],
              llm_model_fusion="GPT2", recency_sigma=1.3, use_pallas=use_pallas)
    jm = JFusionModel(JConfig(**kw))
    v = jm.init({"params": jax.random.PRNGKey(6)}, notes, tau, t_hat, Y, nmask)
    _, fstate = params_from_jax({"model": {}, "fusion": _np_tree(v["params"])})
    tm = FusionModel(TConfig(**kw)).eval()
    tm.load_state_dict(fstate)
    want = np.asarray(jm.apply(v, notes, tau, t_hat, Y, nmask))
    with torch.inference_mode():
        got = tm(*(torch.from_numpy(a) for a in (notes, tau, t_hat, Y, nmask))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    empty = nmask.sum(1) == 0
    assert empty.any()
    np.testing.assert_array_equal(got[empty], Y[empty])


def test_unported_fusion_modules_raise():
    # every fusion module of the JAX package is ported: only unknown names raise
    for kw in (dict(TTF_module="TTF_Nope"), dict(MMF_module="MMF_Nope")):
        cfg = TConfig(input_dim=3, d_txt=8, **{"TTF_module": "TTF_RecAvg",
                                                "MMF_module": "MMF_GR_Add", **kw})
        with pytest.raises(KeyError, match="Unknown fusion module"):
            FusionModel(cfg)
