"""The port's CRU path against the JAX package, on the CPU.

Covers the CRU collate (bit for bit), the Kalman scan on both routes
(the default loop against `cru_scan_xla`; the fused route's plain version
against the Pallas kernel `cru_scan_fwd_pallas` in interpret mode, on the
post-means and all four residuals), the CRU module with weights carried
by convert.params_from_jax, and a CRU + TTF_RecAvg + MMF_GR_Add service
against the JAX package's ForecastService.

Tolerances (float32, torch vs XLA summation order): the scan 1e-5, as
tests/test_cru_fused_scan.py holds the JAX routes to each other; the
module 2e-5 absolute, the bar of tests/test_model_parity.py:81; service
answers 1e-4, as tests/test_torch_serving.py (de-normalisation by `std`
scales the module gap).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data import collate as JC
from imm_tsf_tpu.data.dataset import Chunk as JChunk
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.ops import cru_scan as jscan
from imm_tsf_tpu.ops.pallas.cru_scan_kernel import cru_scan_fwd_pallas

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.data import collate as TC
from imm_tsf_torch.data.dataset import Chunk as TChunk
from imm_tsf_torch.kernels import cru_scan as kscan
from imm_tsf_torch.kernels import expm as kexpm
from imm_tsf_torch.models import get_model
from imm_tsf_torch.ops import cru_scan as tscan
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

ORDER = ("y_mean", "y_var", "valid", "dts", "coeff_w", "coeff_b",
         "dense_basis", "trans_var", "init_cu", "init_cl")


def _scan_inputs(B=4, T=12, lod=4, K=5, seed=0, pad_tail=0, basis_scale=0.2):
    """After tests/test_cru_fused_scan.py:_mk_inputs: sorted times with
    repeat-padded tails (dt = 0 identity steps) and invalid steps."""
    rng = np.random.default_rng(seed)
    lsd = 2 * lod
    tp = np.sort(rng.random((B, T)).astype(np.float32) * 3, axis=1)
    if pad_tail:
        tp[:, -pad_tail:] = tp[:, [-pad_tail - 1]]
    dts = np.concatenate([tp[:, 1:] - tp[:, :-1], np.ones((B, 1), np.float32)], axis=1)
    valid = (rng.random((B, T)) > 0.3).astype(np.float32)
    if pad_tail:
        valid[:, -pad_tail:] = 0.0
    return dict(
        y_mean=rng.standard_normal((B, T, lod)).astype(np.float32),
        y_var=(0.1 + rng.random((B, T, lod))).astype(np.float32),
        valid=valid, dts=dts.astype(np.float32),
        coeff_w=(rng.standard_normal((lsd, K)) * 0.3).astype(np.float32),
        coeff_b=(rng.standard_normal(K) * 0.1).astype(np.float32),
        dense_basis=(rng.standard_normal((4, K, lod, lod)) * basis_scale).astype(np.float32),
        trans_var=(0.05 + rng.random(lsd) * 0.1).astype(np.float32),
        init_cu=(1.0 + rng.random(lod)).astype(np.float32),
        init_cl=(1.0 + rng.random(lod)).astype(np.float32),
    )


def _t(a):
    return [torch.from_numpy(a[k]) for k in ORDER]


def _j(a):
    return [jnp.asarray(a[k]) for k in ORDER]


# ------------------------------------------------------------------ collate
def _chunks(chunk_cls, seed=0, D=3):
    """Ragged chunks: one with no history, one with a single forecast time."""
    rng = np.random.default_rng(seed)
    out = []
    for i, (n, p) in enumerate([(5, 3), (0, 2), (9, 1), (1, 4)]):
        tt = np.concatenate([np.sort(rng.uniform(0, 6.9, n)), np.sort(rng.uniform(7, 14, p))])
        vals = rng.standard_normal((n + p, D)).astype(np.float32)
        mask = (rng.random((n + p, D)) < 0.7).astype(np.float32)
        mask[n:] = 1.0
        out.append(chunk_cls(f"c{i}", tt.astype(np.float32), vals, mask,
                             np.asarray([0.5], np.float32), [np.ones(4, np.float32)]))
    return out


def test_cru_collate_is_bit_identical():
    want = JC.cru_collate(_chunks(JChunk), 7.0, 14.0, 12, 6)
    got = TC.cru_collate(_chunks(TChunk), 7.0, 14.0, 12, 6)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # no history: every observed time repeats 0; pads repeat the last real time
    assert (got["observed_tp"][1] == 0).all()
    np.testing.assert_array_equal(got["tp_to_predict"][2], got["tp_to_predict"][2, 0])


def test_serving_collates_cru_batches_as_jax():
    from imm_tsf_tpu.serving import collate_chunks as j_collate

    from imm_tsf_torch.serving import collate_chunks as t_collate

    kw = dict(model="CRU", history=7, input_len=12, pred_len=6, input_dim=3,
              enable_text=True, use_text_embeddings=True, d_txt=4)
    want = j_collate(JConfig(**kw), _chunks(JChunk), 4, 14.0, pad_to=8)
    got = t_collate(TConfig(**kw), _chunks(TChunk), 4, 14.0, pad_to=8)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --------------------------------------------------------------------- scan
@pytest.mark.parametrize("pad_tail", [0, 3])
@pytest.mark.parametrize("kernel", [True, False])
def test_default_route_matches_jax(pad_tail, kernel, monkeypatch):
    """The default route (kernel=True) and the plain version that
    cru_scan_auto(kernel=False) runs on either route."""
    monkeypatch.delenv("IMM_TSF_CRU_FUSED", raising=False)
    a = _scan_inputs(pad_tail=pad_tail)
    want = np.asarray(jscan.cru_scan_xla(*_j(a)))
    before = kexpm.launches
    got = tscan.cru_scan_auto(*_t(a), kernel=kernel).numpy()
    assert kexpm.launches == before  # CPU tensors take the plain expm
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if pad_tail:  # pad steps are exact identities
        np.testing.assert_array_equal(got[:, -pad_tail:], np.repeat(got[:, -pad_tail - 1:-pad_tail],
                                                                   pad_tail, axis=1))


@pytest.mark.parametrize("case", ["pad_tail", "squaring_tier"])
def test_fused_plain_version_matches_pallas_kernel(case):
    """Post-means and the four residuals against the TPU kernel in
    interpret mode. "pad_tail" runs Taylor-4 on its dt = 0 steps;
    "squaring_tier" scales the bases so 44 % of the Van Loan blocks need
    Taylor-12 with squarings (inf-norms up to 8)."""
    a = (_scan_inputs(pad_tail=3) if case == "pad_tail"
         else _scan_inputs(seed=3, basis_scale=1.0))
    j = _j(a)
    want_out, want_res = cru_scan_fwd_pallas(
        *j[:6], jscan._build_bigG(j[6]), jscan._build_qb(j[7]), j[8], j[9], 7)
    before = kscan.launches
    got_out, got_res = kscan.fused_cru_scan(*_t(a))
    assert kscan.launches == before
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("pm", "pcu", "pcl", "pcs"), got_res, want_res):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=name)
    # the fused route's post-means are the default route's
    np.testing.assert_allclose(tscan.cru_scan(*_t(a)).numpy(),
                               tscan.cru_scan_xla(*_t(a)).numpy(), rtol=1e-6, atol=1e-6)


def test_auto_reads_the_route_at_each_call(monkeypatch):
    a = _t(_scan_inputs())
    calls = []
    monkeypatch.setattr(kscan, "fused_cru_scan",
                        lambda *args: calls.append(1) or kscan.cru_scan_reference(*args))
    monkeypatch.delenv("IMM_TSF_CRU_FUSED", raising=False)
    default = tscan.cru_scan_auto(*a)
    assert calls == []
    monkeypatch.setenv("IMM_TSF_CRU_FUSED", "1")
    fused = tscan.cru_scan_auto(*a)
    assert calls == [1]
    torch.testing.assert_close(fused, default, rtol=1e-6, atol=1e-6)
    monkeypatch.delenv("IMM_TSF_CRU_FUSED")
    tscan.cru_scan_auto(*a, kernel=False)  # the plain version on either route
    assert calls == [1]


# ------------------------------------------------------------------- module
def _model_batch(B=4, L=10, Lp=6, C=3, seed=3):
    """Raw times in days, as cru_collate gives them; the last sample has no
    history (repeat-padded zeros)."""
    rng = np.random.default_rng(seed)
    tp = np.sort(rng.random((B, L)).astype(np.float32) * 7, axis=1)
    tpp = 7 + np.sort(rng.random((B, Lp)).astype(np.float32) * 7, axis=1)
    mask = (rng.random((B, L, C)) > 0.4).astype(np.float32)
    data = rng.standard_normal((B, L, C)).astype(np.float32) * mask
    tp[-1], mask[-1], data[-1] = 0.0, 0.0, 0.0
    return tpp, data, tp, mask


def _jax_cru(kw, batch, seed=0):
    """The JAX CRU with its banded bases drawn N(0, 0.3^2) (zero-init bases
    would make every expm trivial), params as NumPy."""
    jmodel = j_get_model(JConfig(**kw))
    params = jax.tree_util.tree_map(
        np.asarray, jmodel.init({"params": jax.random.PRNGKey(seed)}, *batch)["params"])
    rng = np.random.default_rng(seed + 1)
    for k in ("11", "12", "21", "22"):
        b = params[f"tm_{k}_basis"]
        params[f"tm_{k}_basis"] = (rng.standard_normal(b.shape) * 0.3).astype(np.float32)
    return jmodel, params


@pytest.mark.parametrize("lsd,hidden", [(8, 16), (32, 32)])
@pytest.mark.parametrize("fused", [False, True])
def test_cru_module_matches_jax(lsd, hidden, fused, monkeypatch):
    kw = dict(model="CRU", input_dim=3, input_len=10, pred_len=6, cru_lsd=lsd,
              cru_hidden_units=hidden)
    batch = _model_batch()
    jmodel, params = _jax_cru(kw, batch)
    want = np.asarray(jmodel.apply({"params": params}, *batch))  # the default route
    tmodel = get_model(TConfig(**kw)).eval()
    state, _ = params_from_jax({"model": params})
    tmodel.load_state_dict(state)  # strict: every name maps
    if fused:
        monkeypatch.setenv("IMM_TSF_CRU_FUSED", "1")
    before = kscan.launches, kexpm.launches
    with torch.inference_mode():
        got = tmodel(*(torch.from_numpy(x) for x in batch)).numpy()
    assert (kscan.launches, kexpm.launches) == before
    assert got.shape == want.shape == (4, 6, 3)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_convert_maps_flat_dense_pairs():
    kw = dict(model="CRU", input_dim=3, input_len=10, pred_len=6, cru_lsd=8,
              cru_hidden_units=16)
    _, params = _jax_cru(kw, _model_batch())
    state, _ = params_from_jax({"model": params})
    np.testing.assert_array_equal(state["enc_fc0.weight"].numpy(), params["enc_fc0_kernel"].T)
    np.testing.assert_array_equal(state["enc_fc0.bias"].numpy(), params["enc_fc0_bias"])
    np.testing.assert_array_equal(state["enc_ln0_bias"].numpy(), params["enc_ln0_bias"])
    np.testing.assert_array_equal(state["tm_12_basis"].numpy(), params["tm_12_basis"])
    assert "enc_ln0.bias" not in state and "enc_ln0_scale" in state
    assert set(state) == set(get_model(TConfig(**kw)).state_dict())


# ------------------------------------------------------------------ service
D_TXT = 16
SERVE_KW = dict(
    model="CRU", dataset="EPA-Air", history=7, pred_window=7, stride=7, time_unit="days",
    input_dim=3, input_len=16, pred_len=8, cru_lsd=8, cru_hidden_units=16,
    enable_text=True, use_text_embeddings=True, TTF_module="TTF_RecAvg",
    MMF_module="MMF_GR_Add", llm_model_fusion="GPT2", d_txt=D_TXT, recency_sigma=2.0,
)


@pytest.fixture(scope="module")
def cru_experiments(tmp_path_factory):
    """(jax_dir, port_dir): one CRU experiment in both formats."""
    from imm_tsf_tpu.fusion.fusion_model import FusionModel
    from imm_tsf_tpu.training.checkpoint import save_checkpoint
    from imm_tsf_tpu.training.trainer import init_state

    from imm_tsf_torch.config import load_saved_config
    from imm_tsf_torch.training.checkpoint import save_experiment

    cfg = JConfig(**SERVE_KW)
    root = tmp_path_factory.mktemp("cru_serve")
    jdir, tdir = str(root / "jax_exp"), str(root / "port_exp")
    chunk = JChunk("warm_chunk0", np.asarray([0.0, 1.0, 8.0], np.float32),
                   np.zeros((3, 3), np.float32), np.ones((3, 3), np.float32),
                   np.asarray([0.5], np.float32), [np.ones(D_TXT, np.float32)])
    batch = JC.add_multimodal(JC.cru_collate([chunk], 7.0, 14.0, cfg.input_len, cfg.pred_len),
                              [chunk], True, True, 1, D_TXT)
    params, stats = init_state(cfg, j_get_model(cfg), FusionModel(cfg), batch,
                               jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(4)
    for k in ("11", "12", "21", "22"):
        b = params["model"][f"tm_{k}_basis"]
        params["model"][f"tm_{k}_basis"] = (rng.standard_normal(b.shape) * 0.3).astype(np.float32)
    params["fusion"]["ttf"]["log_recency_sigma"] = np.float32(np.log(1.7))
    os.makedirs(jdir)
    with open(os.path.join(jdir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    save_checkpoint(os.path.join(jdir, "best"), params, stats, 0)
    mstate, fstate = params_from_jax(params)
    save_experiment(tdir, load_saved_config(os.path.join(jdir, "config.json")),
                    mstate, fstate, step=0)
    return jdir, tdir


def _requests(seed, k):
    """Ragged requests: 0-16 observations (some none) with NaN holes, 1-8
    forecast times, 0-6 notes, some with mean/std."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        n = 0 if i % 5 == 2 else int(rng.integers(1, 17))
        m = int(rng.integers(1, 9))
        tt = np.sort(rng.choice(np.linspace(0, 6.99, 60), n, replace=False))
        vals = rng.standard_normal((n, 3))
        vals[rng.random(vals.shape) < 0.2] = np.nan
        tp = np.sort(rng.choice(np.linspace(7.0, 14.0, 30), m, replace=False))
        inst = {"observed_tp": tt.tolist(), "observed_data": vals.tolist(),
                "tp_to_predict": tp.tolist(),
                "notes": [{"tau": float(rng.uniform(0, 7)),
                           "embedding": rng.standard_normal(D_TXT).tolist()}
                          for _ in range(0 if i % 4 == 1 else int(rng.integers(1, 7)))]}
        if i % 3 == 0:
            inst["mean"] = rng.standard_normal(3).tolist()
            inst["std"] = (0.5 + rng.random(3)).tolist()
        out.append(inst)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_cru_service_matches_jax_service(cru_experiments, fused, monkeypatch):
    from imm_tsf_tpu.serving import ForecastService as JForecastService

    from imm_tsf_torch.serving import ForecastService

    jdir, tdir = cru_experiments
    insts = _requests(0, 10)
    jsvc = JForecastService(jdir, max_batch=4, max_wait_ms=20.0)
    try:
        want = [f.result(timeout=300) for f in [jsvc.submit(i) for i in insts]]
    finally:
        jsvc.close()
    if fused:
        monkeypatch.setenv("IMM_TSF_CRU_FUSED", "1")
    tsvc = ForecastService(tdir, max_batch=4, max_wait_ms=20.0, device="cpu")
    try:
        got = [f.result(timeout=300) for f in [tsvc.submit(i) for i in insts]]
        assert tsvc.metrics()["model"] == "CRU"
    finally:
        tsvc.close()
    for inst, g, w in zip(insts, got, want):
        assert g["tp"] == w["tp"]
        ga = np.asarray(g["prediction"])
        assert ga.shape == (len(inst["tp_to_predict"]), 3) and np.isfinite(ga).all()
        np.testing.assert_allclose(ga, np.asarray(w["prediction"]), atol=1e-4, rtol=1e-4)
