"""The port's CRU gradients against the JAX package, on the CPU.

- `cru_scan_bwd_reference`, the plain version of kernel #7, against the
  TPU kernel `cru_scan_bwd_pallas` in interpret mode on the same inputs,
  residuals and cotangent: rtol 2e-4, atol 2e-5 of each cotangent's
  largest entry, as tests/test_cru_fused_scan.py:104 holds the JAX routes
  (the JAX kernel's gbigG is reduced to G11 - G22^T, the port's gA);
- the default route's gradients (autograd through the loop, the expm's
  Frechet backward) and the fused route's (the Function's backward)
  against `jax.grad` of `cru_scan_xla`, to the same tolerance;
- the recency average's hand VJP against `jax.vjp` of the JAX package's
  custom-VJP op (its forward pre-divides by sigma: 1e-5 relative);
- CRU + TTF_RecAvg + MMF_GR_Add parameter gradients of the masked-MSE
  loss against `jax.grad` through the flax modules, with weights carried
  by `params_from_jax` (which carries the gradient trees too), at lsd 8
  and 32, input_dim 8 and a spread `residual_head` bias (MMF_GR_Add's
  LayerNorm over C amplifies float32 rounding up to ~316x where channels
  coincide, ROADMAP.md Queue 3): 1e-4 relative plus 1e-5 of each
  tensor's largest entry, float32 through 20 Kalman steps. The initial
  covariances' gradients (log_icu, log_icl) are ill-conditioned in
  float32 (at the initial variance 10 the first gains q = cu / (cu + yv)
  sit near 1): the JAX package's own float32 gradient there strays 0.4-4 %
  of its largest entry from a float64 run of the same weights. Those two
  are held to a float64 run of the port instead: the port's gap at most
  twice the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.ops import cru_scan as jscan
from imm_tsf_tpu.ops.pallas.cru_scan_kernel import cru_scan_bwd_pallas, cru_scan_fwd_pallas
from imm_tsf_tpu.ops.pallas.fusion_kernels import recency_weighted_average as j_recavg
from imm_tsf_tpu.training.evaluation import masked_mse_loss as j_loss

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.fusion.fusion_model import FusionModel
from imm_tsf_torch.kernels import cru_scan as kscan
from imm_tsf_torch.kernels.recavg import recency_weighted_average
from imm_tsf_torch.models import get_model
from imm_tsf_torch.ops import cru_scan as tscan
from imm_tsf_torch.training.evaluation import masked_mse_loss

from test_torch_cru import ORDER, _scan_inputs

torch.set_num_threads(1)

DIFF = ("y_mean", "y_var", "coeff_w", "coeff_b", "dense_basis", "trans_var", "init_cu",
        "init_cl")


def _close(got, want, rtol=2e-4, atol_frac=2e-5, name=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_frac * max(float(np.abs(want).max()), 1e-30),
                               err_msg=name)


@pytest.mark.parametrize("case", ["pad_tail", "squaring_tier"])
def test_plain_backward_matches_pallas_kernel(case):
    a = (_scan_inputs(pad_tail=3) if case == "pad_tail"
         else _scan_inputs(seed=3, basis_scale=1.0))
    j = [jnp.asarray(a[k]) for k in ORDER]
    bigG, qb = jscan._build_bigG(j[6]), jscan._build_qb(j[7])
    out, res = cru_scan_fwd_pallas(*j[:6], bigG, qb, j[8], j[9], 7)
    g = np.random.default_rng(9).standard_normal(out.shape).astype(np.float32)
    want = cru_scan_bwd_pallas(*j[:6], bigG, qb, j[8], j[9], res, jnp.asarray(g), 7)
    lsd = a["coeff_w"].shape[0]
    gbigG = np.asarray(want[4])
    want = list(want)
    want[4] = gbigG[:, :lsd, :lsd] - np.swapaxes(gbigG[:, lsd:, lsd:], -1, -2)
    before = kscan.backward_launches
    got = kscan.fused_cru_scan_backward(*(torch.from_numpy(a[k]) for k in ORDER),
                                        [torch.from_numpy(np.array(r)) for r in res],
                                        torch.from_numpy(g))
    assert kscan.backward_launches == before  # CPU tensors take the plain version
    for name, x, w in zip(("gy", "gyv", "gW", "gb", "gA", "gq", "gicu", "gicl"), got, want):
        _close(x.numpy(), np.reshape(w, x.shape), name=name)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["pad_tail", "squaring_tier"])
def test_scan_gradients_match_jax_grad(fused, case, monkeypatch):
    monkeypatch.delenv("IMM_TSF_CRU_FUSED", raising=False)
    a = (_scan_inputs(pad_tail=3) if case == "pad_tail"
         else _scan_inputs(seed=3, basis_scale=1.0))
    g = np.random.default_rng(4).standard_normal((4, 12, 8)).astype(np.float32)
    idx = [ORDER.index(k) for k in DIFF]

    def jloss(*diff):
        args = [jnp.asarray(a[k]) for k in ORDER]
        for i, d in zip(idx, diff):
            args[i] = d
        return (jscan.cru_scan_xla(*args) * g).sum()

    want = jax.grad(jloss, argnums=tuple(range(len(DIFF))))(*(jnp.asarray(a[k]) for k in DIFF))
    t = {k: torch.from_numpy(a[k]).requires_grad_(k in DIFF) for k in ORDER}
    if fused:
        monkeypatch.setenv("IMM_TSF_CRU_FUSED", "1")
    out = tscan.cru_scan_auto(*(t[k] for k in ORDER))
    got = torch.autograd.grad((out * torch.from_numpy(g)).sum(), [t[k] for k in DIFF])
    for name, x, w in zip(DIFF, got, want):
        _close(x.numpy(), w, name=name)


def test_recency_average_vjp_matches_jax():
    rng = np.random.default_rng(5)
    B, N, T, d = 3, 6, 5, 7
    tau = rng.uniform(0, 7, (B, N)).astype(np.float32)
    t_hat = rng.uniform(0, 9, (B, T)).astype(np.float32)
    V = rng.standard_normal((B, N, d)).astype(np.float32)
    mask = (rng.random((B, N)) < 0.7).astype(np.float32)
    mask[-1] = 0.0  # a sample without notes
    sigma = np.float32(1.3)
    dE = rng.standard_normal((B, T, d)).astype(np.float32)
    want_E, vjp = jax.vjp(j_recavg, *(jnp.asarray(x) for x in (tau, t_hat, V, mask, sigma)))
    want = vjp(jnp.asarray(dE))
    ins = [torch.tensor(x, requires_grad=True) for x in (tau, t_hat, V, mask, sigma)]
    E = recency_weighted_average(*ins)
    got = torch.autograd.grad(E, [ins[i] for i in (0, 1, 2, 4)], torch.from_numpy(dE))
    _close(E.detach().numpy(), want_E, rtol=1e-5, atol_frac=1e-6)
    for name, x, w in zip(("tau", "t_hat", "V", "sigma"), got, [want[i] for i in (0, 1, 2, 4)]):
        _close(x.numpy(), w, rtol=1e-5, atol_frac=1e-6, name=name)


def _batch(B=4, L=10, Lp=10, C=8, N=3, d=16, seed=3):
    rng = np.random.default_rng(seed)
    tp = np.sort(rng.random((B, L)).astype(np.float32) * 7, axis=1)
    tpp = 7 + np.sort(rng.random((B, Lp)).astype(np.float32) * 7, axis=1)
    mask = (rng.random((B, L, C)) > 0.4).astype(np.float32)
    data = rng.standard_normal((B, L, C)).astype(np.float32) * mask
    notes = rng.standard_normal((B, N, d)).astype(np.float32)
    notes[-1, 1:] = 0.0  # padded notes
    return dict(tp_to_predict=tpp, observed_data=data, observed_tp=tp, observed_mask=mask,
                notes_embeddings=notes, tau=rng.uniform(0, 7, (B, N)).astype(np.float32),
                notes_mask=(np.abs(notes).sum(-1) > 0).astype(np.float32),
                data_to_predict=rng.standard_normal((B, Lp, C)).astype(np.float32),
                mask_predicted_data=(rng.random((B, Lp, C)) > 0.3).astype(np.float32))


@pytest.mark.parametrize("lsd,hidden", [(8, 16), (32, 32)])
def test_cru_and_fusion_gradients_match_jax(lsd, hidden):
    kw = dict(model="CRU", input_dim=8, input_len=10, pred_len=10, cru_lsd=lsd,
              cru_hidden_units=hidden, enable_text=True, use_text_embeddings=True,
              TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add", llm_model_fusion="GPT2",
              d_txt=16, dropout=0.0)
    b = _batch()
    model_in = [b[k] for k in ("tp_to_predict", "observed_data", "observed_tp", "observed_mask")]
    jcfg = JConfig(**kw)
    jmodel, jfusion = j_get_model(jcfg), JFusionModel(jcfg)
    params = {"model": jmodel.init({"params": jax.random.PRNGKey(0)}, *model_in)["params"],
              "fusion": jfusion.init({"params": jax.random.PRNGKey(1)}, b["notes_embeddings"],
                                     b["tau"], b["tp_to_predict"], b["data_to_predict"],
                                     b["notes_mask"])["params"]}
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(2)
    for k in ("11", "12", "21", "22"):  # nonzero bases: the expm is not trivial
        shape = params["model"][f"tm_{k}_basis"].shape
        params["model"][f"tm_{k}_basis"] = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    params["fusion"]["mmf"]["residual_head"]["bias"] = np.linspace(-2, 2, 8, dtype=np.float32)

    def jloss(p):
        pred = jmodel.apply({"params": p["model"]}, *model_in)
        pred = jfusion.apply({"params": p["fusion"]}, b["notes_embeddings"], b["tau"],
                             b["tp_to_predict"], pred, b["notes_mask"])
        return j_loss(pred, b["data_to_predict"], b["mask_predicted_data"])

    want_loss, want = jax.value_and_grad(jloss)(params)
    want_m, want_f = params_from_jax(jax.tree_util.tree_map(np.asarray, want))

    def port_grads(dtype):
        tcfg = TConfig(**kw)
        model, fusion = get_model(tcfg).train(), FusionModel(tcfg).train()
        mstate, fstate = params_from_jax(params)
        model.load_state_dict(mstate)
        fusion.load_state_dict(fstate)
        model.to(dtype), fusion.to(dtype)
        t = {k: torch.from_numpy(v).to(dtype) for k, v in b.items()}
        pred = model(t["tp_to_predict"], t["observed_data"], t["observed_tp"], t["observed_mask"])
        pred = fusion(t["notes_embeddings"], t["tau"], t["tp_to_predict"], pred, t["notes_mask"])
        loss = masked_mse_loss(pred, t["data_to_predict"], t["mask_predicted_data"])
        loss.backward()
        return float(loss.detach()), [{n: p.grad for n, p in m.named_parameters()}
                                      for m in (model, fusion)]

    loss, got = port_grads(torch.float32)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    witness = port_grads(torch.float64)[1]
    for grads, wants, refs in zip(got, (want_m, want_f), witness):
        assert set(grads) == set(wants)  # every parameter JAX differentiates gets a gradient
        for name, g in grads.items():
            assert g is not None, name
            w = wants[name].numpy()
            if name in ("log_icu", "log_icl"):
                r = refs[name].numpy()
                assert np.abs(g.numpy() - r).max() <= 2 * np.abs(w - r).max() + 1e-9, name
            else:
                _close(g.numpy(), w, rtol=1e-4, atol_frac=1e-5, name=name)
