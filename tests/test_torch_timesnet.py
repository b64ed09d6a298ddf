"""TimesNet, RevIN and the DFT decomposition, the port against the JAX
package, on the CPU (2e-5 absolute unless stated):

- `dft_decomp`, with a tie at the k-th place (an impulse: every bin's
  magnitude is exactly 1, so every bin is kept);
- `RevIN` norm and denorm under each of affine, subtract_last, non_norm;
- `TimesBlock` through `params_from_jax` (the flax leaves
  conv{1,2}_kernel_<i> keep their names and layout), and the bins it
  picks: planted, well-separated periods pick JAX's bins, and an all-zero
  batch picks f = 0, 1, 2 as lax.top_k orders the tie;
- TimesNet, e_layers 2 with its one shared LayerNorm, inputs shorter than
  input_len too;
- a TimesNet + TTF_RecAvg + MMF_GR_Add service against the JAX service
  (1e-4), and `trainable` from the JAX init against the JAX `trainable`
  (dropout 0): per-step losses to 1e-5 relative.
"""

import jax
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.layers import decomp as jdecomp
from imm_tsf_tpu.layers.revin import RevIN as JRevIN
from imm_tsf_tpu.models import timesnet as jtimesnet

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.layers import decomp
from imm_tsf_torch.layers.revin import RevIN
from imm_tsf_torch.models import get_model, timesnet

from torch_port_parity import (assert_model_matches, model_batch, perturbed, port_state,
                               service_matches_jax, trainable_matches_jax)

torch.set_num_threads(1)

ATOL = 2e-5
T = torch.from_numpy


@pytest.mark.parametrize("top_k, L", [(1, 24), (3, 24), (3, 2)])
def test_dft_decomp_matches_jax(top_k, L):
    """L 2: two bins against top_k 3, where JAX clamps the index to the
    smallest magnitude, the zeroed DC bin's: every bin is kept."""
    x = np.random.default_rng(top_k).standard_normal((3, L, 5)).astype(np.float32)
    x[1, :, 2] = 0.0
    x[1, 0, 2] = 1.0  # an impulse: |X_f| = 1 exactly at every bin, a tie at the k-th place
    want = [np.asarray(a) for a in jdecomp.dft_decomp(x, top_k)]
    got = [a.numpy() for a in decomp.dft_decomp(T(x), top_k)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    # every bin kept, DC too when the index is clamped: the season is the
    # impulse, less its mean when DC is dropped
    season = x[1, :, 2] - (1 / L if L > top_k else 0.0)
    np.testing.assert_allclose(got[0][1, :, 2], season, atol=1e-6)


@pytest.mark.parametrize("affine, subtract_last, non_norm",
                         [(True, False, False), (True, True, False), (False, False, True),
                          (False, True, False)])
def test_revin_matches_jax(affine, subtract_last, non_norm):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 12, 3)) * 2 + 1).astype(np.float32)
    y = rng.standard_normal((4, 6, 3)).astype(np.float32)
    jm = JRevIN(3, affine=affine, subtract_last=subtract_last, non_norm=non_norm)
    v = perturbed(jm.init(jax.random.PRNGKey(0), x, "norm"))
    tm = RevIN(3, affine=affine, subtract_last=subtract_last, non_norm=non_norm)
    tm.load_state_dict({k: T(np.asarray(a)) for k, a in v.get("params", {}).items()})
    j_out, j_stats = jm.apply(v, x, "norm")
    t_out, t_stats = tm(T(x), "norm")
    np.testing.assert_allclose(t_out.detach().numpy(), np.asarray(j_out), atol=1e-5, rtol=0)
    j_back = jm.apply(v, y, "denorm", j_stats)
    t_back = tm(T(y), "denorm", t_stats)
    np.testing.assert_allclose(t_back.detach().numpy(), np.asarray(j_back), atol=1e-5,
                               rtol=1e-6)


BLOCK_KW = dict(model="TimesNet", d_model=6, d_ff=8, top_k=3, num_kernels=3)


def _block_pair(T_len: int):
    cfg_kw = dict(BLOCK_KW, input_len=T_len - 4, pred_len=4)
    jb = jtimesnet.TimesBlock(JConfig(**cfg_kw), T_len)
    tb = timesnet.TimesBlock(TConfig(**cfg_kw)).eval()
    return jb, tb


class _Recorder:
    """Records the bins each package's TimesBlock picks."""

    def __init__(self, monkeypatch):
        self.jax, self.port = [], []
        top_k, top_lags = jax.lax.top_k, timesnet.top_lags

        def j_top_k(x, k):
            out = top_k(x, k)
            self.jax.append(np.asarray(out[1]).tolist())
            return out

        def t_top_lags(x, k):
            out = top_lags(x, k)
            self.port.append(out[0].tolist())
            return out

        monkeypatch.setattr(jax.lax, "top_k", j_top_k)
        monkeypatch.setattr(timesnet, "top_lags", t_top_lags)


def test_times_block_through_params_from_jax_matches_jax(monkeypatch):
    T_len = 20
    x = np.random.default_rng(4).standard_normal((3, T_len, 6)).astype(np.float32)
    jb, tb = _block_pair(T_len)
    v = jax.jit(jb.init)(jax.random.PRNGKey(0), x)
    assert "conv1_kernel_2" in v["params"] and v["params"]["conv1_kernel_2"].shape == (5, 5, 6, 8)
    params = perturbed(v["params"])
    tb.load_state_dict(port_state(params))
    rec = _Recorder(monkeypatch)
    want = np.asarray(jb.apply({"params": params}, x))
    with torch.inference_mode():
        got = tb(T(x)).numpy()
    assert rec.jax == rec.port
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["planted", "zeros"])
def test_times_block_picks_jax_bins(monkeypatch, case):
    T_len, B, N = 24, 2, 6
    t = np.arange(T_len)
    if case == "planted":  # bins 2, 5 and 8, amplitudes 3 : 2 : 1, and a little noise
        x = sum(a * np.cos(2 * np.pi * f * t / T_len + ph)
                for a, f, ph in ((3, 2, 0.3), (2, 5, 1.1), (1, 8, 2.0)))
        x = np.broadcast_to(x[None, :, None], (B, T_len, N)) + 0.01 * np.random.default_rng(
            0).standard_normal((B, T_len, N))
        expect = [2, 5, 8]
    else:  # every amplitude 0: lax.top_k's tie order, f = 0 (the period T) first
        x = np.zeros((B, T_len, N))
        expect = [0, 1, 2]
    x = x.astype(np.float32)
    jb, tb = _block_pair(T_len)
    params = perturbed(jax.jit(jb.init)(jax.random.PRNGKey(0), x)["params"])
    tb.load_state_dict(port_state(params))
    rec = _Recorder(monkeypatch)
    want = np.asarray(jb.apply({"params": params}, x))
    with torch.inference_mode():
        got = tb(T(x)).numpy()
    assert rec.jax == rec.port == [expect]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


CFG_KW = dict(model="TimesNet", input_dim=3, input_len=12, pred_len=6, d_model=8, d_ff=16,
              e_layers=2, top_k=3, num_kernels=2)


def test_timesnet_through_params_from_jax_matches_jax():
    batch = model_batch(5, B=4, L=12, Lp=6, K=3)
    short = (batch[0][:, :5], batch[1][:, :9], batch[2][:, :9], batch[3][:, :9])
    tm = get_model(TConfig(**CFG_KW))
    assert isinstance(tm, timesnet.TimesNet)
    params = assert_model_matches(jtimesnet.TimesNet(JConfig(**CFG_KW)), tm, batch, ATOL, short)
    assert "layer_norm" in params and "layer_norm" not in params["times_block_0"]


def test_timesnet_service_matches_jax_service(tmp_path):
    service_matches_jax(tmp_path, CFG_KW)


def test_timesnet_trainable_from_jax_init_matches_jax_trainable(tmp_path):
    got = trainable_matches_jax(tmp_path, dict(model="TimesNet", d_model=8, d_ff=16,
                                               e_layers=2, top_k=3, num_kernels=2))
    assert isinstance(got["model"], timesnet.TimesNet)
