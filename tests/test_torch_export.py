"""The port's deployment path on the CPU: the served-path kernels as
`torch.library` custom ops (imm_tsf_torch/kernels/ops.py), the
torch.export artifacts that record them (imm_tsf_torch/export.py) against
the JAX package's jax.export artifacts and the port's live service, and
`serve --artifact` over HTTP."""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from imm_tsf_torch.data.collate import pad_to_bucket
from imm_tsf_torch.export import ExportedForecaster, export_experiment, op_counts
from imm_tsf_torch.kernels import ops
from imm_tsf_torch.serving import ForecastService

from torch_port_parity import assert_answers_match, jax_and_port_experiments, mixed_requests
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

LIVE_TOL = dict(rtol=1e-5, atol=1e-6)  # artifact vs live service (tests/test_export.py:160-163)


# ------------------------------------------------------------------ ops
def _op_args(name: str):
    rng = np.random.default_rng(0)
    t = lambda *s, scale=1.0: torch.from_numpy((rng.standard_normal(s) * scale).astype(np.float32))
    pos = lambda *s: torch.from_numpy(rng.uniform(0.5, 1.5, s).astype(np.float32))
    if name == "recency_weighted_average":
        mask = torch.tensor([[1.0, 1.0, 0.0], [0.0, 0.0, 0.0]])
        return (pos(2, 3) * 3, pos(2, 4) * 4, t(2, 3, 5), mask, torch.tensor(1.7))
    if name == "fused_encoder_ffn_eval":
        return (t(6, 8), t(8, 16, scale=0.3), t(16), t(16, 8, scale=0.3), t(8), pos(8), t(8),
                None, 1.0, "gelu", False, False)
    if name == "fused_encoder_ffn_train":
        return (t(6, 8), t(8, 16, scale=0.3), t(16), t(16, 8, scale=0.3), t(8), pos(8), t(8),
                torch.tensor([[3, 5], [7, 11]]), 0.9, "relu", True, True)
    if name.startswith("fused_encoder_ffn_bf16w"):  # amp_bf16: f32 x, bf16 weights
        args = list(_op_args(name.replace("_bf16w", "")))
        return tuple([a.to(torch.bfloat16) if 1 <= i <= 6 else a for i, a in enumerate(args)])
    if name == "fused_causal_attention":
        pad = torch.ones(2, 5)
        pad[1, 3:] = 0
        return (t(2, 2, 5, 4), t(2, 2, 5, 4), t(2, 2, 5, 4), pad)
    if name == "batched_expm":
        return (t(3, 6, 6, scale=0.4), 7)
    assert name == "fused_cru_scan"
    B, T, lod, K = 2, 3, 2, 3
    valid = torch.tensor([[1.0, 0.0, 1.0], [1.0, 1.0, 0.0]])
    return (t(B, T, lod), pos(B, T, lod), valid, pos(B, T) * 0.3, t(2 * lod, K), t(K),
            t(4, K, lod, lod, scale=0.3), pos(2 * lod), pos(lod), pos(lod), 7)


@pytest.mark.parametrize("name", ["recency_weighted_average", "fused_encoder_ffn_eval",
                                  "fused_encoder_ffn_train", "fused_encoder_ffn_bf16w_eval",
                                  "fused_encoder_ffn_bf16w_train", "fused_causal_attention",
                                  "batched_expm", "fused_cru_scan"])
def test_op_passes_opcheck(name):
    """Schema, fake (shape and dtype) implementation and dispatch of each op,
    on the CPU, where it runs the kernel's plain version; #2 also in its
    bf16-weight form."""
    op = getattr(ops, name.replace("_eval", "").replace("_train", "").replace("_bf16w", ""))
    args = _op_args(name)
    torch.library.opcheck(op, args)


def test_ops_are_the_wrappers_plain_versions():
    """On CPU tensors an op gives exactly the plain version of its kernel."""
    from imm_tsf_torch.kernels import attn, ffn, recavg
    from imm_tsf_torch.ops.cru_scan import cru_scan_reference
    from imm_tsf_torch.ops.expm import expm_taylor12

    a = _op_args("recency_weighted_average")
    assert torch.equal(ops.recency_weighted_average(*a), recavg.recavg_reference(*a))
    a = _op_args("fused_encoder_ffn_train")
    got = ops.fused_encoder_ffn(*a)
    want = ffn.ffn_forward_reference(*a[:11], with_residuals=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    a = _op_args("fused_causal_attention")
    assert torch.equal(ops.fused_causal_attention(*a), attn.attention_reference(*a))
    a = _op_args("batched_expm")
    assert torch.equal(ops.batched_expm(*a), expm_taylor12(*a))
    a = _op_args("fused_cru_scan")
    out, residuals = cru_scan_reference(*a)
    assert all(torch.equal(g, w) for g, w in zip(ops.fused_cru_scan(*a), (out, *residuals)))


# ------------------------------------------------------------ graphs
PORT_KW = dict(dataset="EPA-Air", history=7, pred_window=7, stride=7, time_unit="days",
               enable_text=True, use_text_embeddings=True, llm_model_fusion="GPT2", d_txt=16,
               TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add", input_dim=3, input_len=16,
               pred_len=8, d_model=16, d_ff=32, n_heads=2)


def _port_experiment(exp_dir: str, **kw):
    from imm_tsf_torch.config import Config
    from imm_tsf_torch.fusion.fusion_model import FusionModel
    from imm_tsf_torch.models import get_model
    from imm_tsf_torch.training.checkpoint import save_experiment

    cfg = Config(**{**PORT_KW, **kw})
    torch.manual_seed(0)
    save_experiment(exp_dir, cfg, get_model(cfg).state_dict(), FusionModel(cfg).state_dict())
    return cfg


@pytest.mark.parametrize("e_layers", [1, 2])
def test_exported_graph_holds_one_op_node_a_kernel_call(tmp_path, e_layers):
    """PatchTST with --use_fused_ffn: one fused_encoder_ffn node an encoder
    layer and one recency_weighted_average, and no inlined plain version
    (the plain FFN's E[r^2] - mu^2 LayerNorm takes rsqrt, the plain
    average its einsum); the plain route exports the plain versions and no
    op."""
    graphs = {}
    for route, kw in (("kernel", dict(use_pallas=True, use_fused_ffn=True)),
                      ("plain", dict(use_pallas=False, use_fused_ffn=False))):
        exp = str(tmp_path / route)
        _port_experiment(exp, model="PatchTST", e_layers=e_layers, **kw)
        meta = export_experiment(exp, exp + "_art", batch_sizes=(2,), device="cpu")
        ep = torch.export.load(os.path.join(exp + "_art", "forecast_b2.pt2"))
        assert meta["ops"]["2"] == op_counts(ep)
        graphs[route] = [(str(n.target), n.args) for n in ep.graph.nodes]
        graphs[route + "_ops"] = op_counts(ep)
    assert graphs["kernel_ops"] == {"fused_encoder_ffn": e_layers, "recency_weighted_average": 1}
    assert graphs["plain_ops"] == {}
    plain_average = lambda g: any(t == "aten.einsum.default" and a[0] == "bnt,bnd->btd"
                                  for t, a in g)
    plain_ffn_norm = lambda g: sum(t == "aten.rsqrt.default" for t, _ in g)
    assert plain_average(graphs["plain"]) and not plain_average(graphs["kernel"])
    assert plain_ffn_norm(graphs["plain"]) == e_layers and plain_ffn_norm(graphs["kernel"]) == 0


# --------------------------------------------------------- artifacts
CASES = {
    "DLinear_default_pair": dict(model="DLinear", TTF_module="TTF_T2V_XAttn",
                                 MMF_module="MMF_XAttn_Add"),
    "PatchTST_fused_ffn": dict(model="PatchTST", d_model=16, d_ff=32, n_heads=2, e_layers=1,
                               use_fused_ffn=True),
    "CRU_default": dict(model="CRU", cru_lsd=8, cru_hidden_units=16),
    "CRU_fused": dict(model="CRU", cru_lsd=8, cru_hidden_units=16),
    "tPatchGNN": dict(model="tPatchGNN", hid_dim=8, te_dim=4, node_dim=5, n_heads=2,
                      patch_size=2, patch_stride=2, npatch=4),
    "LatentODE": dict(model="LatentODE", ode_rec_dims=8, ode_units=16, ode_gru_units=8,
                      ode_latents=6, ode_rec_layers=1, ode_gen_layers=1),
    "TimesNet": dict(model="TimesNet", d_model=8, d_ff=16, e_layers=2, top_k=3, num_kernels=2),
}
EXPECTED_OPS = {
    "DLinear_default_pair": {},
    "PatchTST_fused_ffn": {"fused_encoder_ffn": 1, "recency_weighted_average": 1},
    "CRU_default": {"batched_expm": 24, "recency_weighted_average": 1},  # T = 16 + 8
    "CRU_fused": {"fused_cru_scan": 1, "recency_weighted_average": 1},
    "tPatchGNN": {"recency_weighted_average": 1},
    "LatentODE": {"recency_weighted_average": 1},
    "TimesNet": {"recency_weighted_average": 1},
}


def _forecast_in_fours(fc, insts):
    return [a for i in range(0, len(insts), 4) for a in fc.forecast(insts[i:i + 4])]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """case -> (cfg, jdir, tdir, insts, j_meta, the JAX artifact's answers):
    each experiment and its JAX artifact made once for the module, so the
    two CRU cases (the same config, the port on either route) share one."""
    from imm_tsf_tpu.export import ExportedForecaster as JExportedForecaster
    from imm_tsf_tpu.export import export_experiment as j_export_experiment

    made: dict = {}

    def get(case: str):
        key = json.dumps(CASES[case], sort_keys=True)
        if key not in made:
            tmp = tmp_path_factory.mktemp(case)
            cfg, jdir, tdir = jax_and_port_experiments(
                tmp, dict(CASES[case], input_dim=3, input_len=16, pred_len=8))
            insts = mixed_requests(cfg, 10)
            jart = str(tmp / "jax_art")
            j_meta = j_export_experiment(jdir, jart, batch_sizes=(4,))
            made[key] = (cfg, jdir, tdir, insts, j_meta,
                         _forecast_in_fours(JExportedForecaster(jart), insts))
        return made[key]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_artifact_matches_jax_artifact_and_live_service(jax_side, tmp_path, monkeypatch, case):
    """One experiment (the JAX init, converted) exported by both packages
    on the CPU: the port's artifact answers 10 mixed requests as the JAX
    artifact does (1e-4 + 1e-4|ref|, the tolerance of the live services'
    comparison) and as the port's live service does (rtol 1e-5, atol
    1e-6); its graph holds the expected ops. CRU_fused exports the port on
    the fused route (IMM_TSF_CRU_FUSED=1) against the JAX default route
    (CRU_default's experiment and JAX artifact, `jax_side`)."""
    cfg, jdir, tdir, insts, j_meta, want = jax_side(case)
    tart = str(tmp_path / "port_art")

    if case == "CRU_fused":
        monkeypatch.setenv("IMM_TSF_CRU_FUSED", "1")
    meta = export_experiment(tdir, tart, batch_sizes=(4,), device="cpu")
    assert meta["ops"]["4"] == EXPECTED_OPS[case]
    assert meta["kernel_route"]["IMM_TSF_CRU_FUSED"] == (case == "CRU_fused")
    for key in ("notes_cap", "patch_cap", "ode_caps", "d_txt", "batch_sizes"):
        assert meta[key] == j_meta[key], key
    fc = ExportedForecaster(tart, device="cpu")
    got = _forecast_in_fours(fc, insts)
    assert_answers_match(insts, got, want, cfg.input_dim)
    assert fc.metrics()["artifact"] is True

    svc = ForecastService(tdir, max_batch=4, max_wait_ms=20.0, device="cpu")
    try:
        live = [f.result(timeout=300) for f in [svc.submit(i) for i in insts]]
    finally:
        svc.close()
    assert_answers_match(insts, got, live, cfg.input_dim, **LIVE_TOL)
    if case == "LatentODE":  # one dispatch a request, as the live service
        assert fc.metrics()["dispatches_total"] == len(insts)


@pytest.fixture(scope="module")
def dlinear_artifact(tmp_path_factory):
    """A text DLinear (TTF_RecAvg + MMF_GR_Add) experiment and its
    artifact at batch sizes 2 and 4, notes capped at 3 (to its bucket)."""
    root = tmp_path_factory.mktemp("export")
    exp = str(root / "exp")
    cfg = _port_experiment(exp, model="DLinear")
    art = str(root / "art")
    meta = export_experiment(exp, art, batch_sizes=(4, 2, 4), device="cpu", max_notes=3)
    return cfg, exp, art, meta


def test_artifact_layout_and_config_overrides(dlinear_artifact, tmp_path):
    from imm_tsf_torch.config import load_saved_config

    cfg, exp, art, meta = dlinear_artifact
    assert meta["batch_sizes"] == [2, 4] and meta["notes_cap"] == pad_to_bucket(3)
    assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
    assert json.load(open(os.path.join(art, "meta.json"))) == meta
    assert sorted(os.listdir(art)) == ["config.json", "forecast_b2.pt2", "forecast_b4.pt2",
                                       "meta.json"]
    # config.json is the config the programs were exported with; the
    # machine-local platform never travels with the artifact
    over = load_saved_config(os.path.join(exp, "config.json")).replace(lr=0.12345,
                                                                      platform="cpu")
    art2 = str(tmp_path / "art_over")
    export_experiment(exp, art2, cfg=over, batch_sizes=(2,), device="cpu")
    raw = json.load(open(os.path.join(art2, "config.json")))
    assert raw["lr"] == 0.12345 and raw["platform"] == "auto"
    assert ExportedForecaster(art2, device="cpu").forecast([]) == []


def test_artifact_refuses_what_it_cannot_serve(dlinear_artifact, tmp_path):
    cfg, exp, art, _ = dlinear_artifact
    fc = ExportedForecaster(art, device="cpu")
    insts = mixed_requests(cfg, 5, max_notes=3)
    assert len(fc.forecast(insts[:3])) == 3  # the B 4 program
    with pytest.raises(ValueError, match="exceed the largest exported batch size 4"):
        fc.forecast(insts)
    cap = pad_to_bucket(3)
    over = dict(insts[0], notes=[{"tau": 0.5, "embedding": [0.0] * 16}] * (cap + 1))
    with pytest.raises(ValueError, match=f"{cap + 1} notes exceed the artifact's notes_cap {cap}"):
        fc.forecast([over])
    with pytest.raises(ValueError, match="positive"):
        export_experiment(exp, str(tmp_path / "a"), batch_sizes=(0,), device="cpu")
    if not torch.cuda.is_available():  # cuda unless the caller asks for the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ExportedForecaster(art)


def test_timesnet_artifact_equals_live_service_bit_for_bit(tmp_path):
    """TimesNet (e_layers 2, input_len 16 + pred_len 8: 7 candidate
    periods in 4 canvases, two of them masked) exported on the CPU: its
    static period canvas traces, and the artifact answers 12 requests in
    dispatches of 4 exactly as the live service's dispatches of the same
    requests do. Each dispatch picks its own periods (the batch's mean
    amplitudes), so the groups are the same on both sides; every request
    has 3 notes, so both pad the notes axis to the same bucket."""
    from imm_tsf_torch.serving import _build_chunk

    exp = str(tmp_path / "exp")
    cfg = _port_experiment(exp, model="TimesNet", d_model=8, d_ff=16, e_layers=2, top_k=3,
                           num_kernels=2)
    art = str(tmp_path / "art")
    meta = export_experiment(exp, art, batch_sizes=(4,), device="cpu", max_notes=3)
    assert meta["ops"]["4"] == {"recency_weighted_average": 1}
    insts = [dict(i, notes=(i["notes"] * 3)[:3]) for i in mixed_requests(cfg, 16, max_notes=3)
             if i["notes"]]
    fc = ExportedForecaster(art, device="cpu")
    got = _forecast_in_fours(fc, insts)
    svc = ForecastService(exp, max_batch=4, device="cpu")
    try:
        live = [a for i in range(0, len(insts), 4)
                for a in svc._infer([_build_chunk(r, svc.cfg, svc.d_txt)
                                     for r in insts[i:i + 4]])]
    finally:
        svc.close()
    assert len(got) == len(live) == 12
    for g, w in zip(got, live):
        assert g["tp"] == w["tp"]
        assert np.array_equal(np.asarray(g["prediction"]), np.asarray(w["prediction"]))


def test_collate_caps_raise_past_the_static_axes():
    """The exported programs' static axes: a request whose union axis or
    per-patch axis exceeds the artifact's cap is a clear error (the JAX
    package's texts), not a truncation."""
    from imm_tsf_torch.config import Config
    from imm_tsf_torch.data.dataset import Chunk
    from imm_tsf_torch.serving import collate_chunks

    tt = np.asarray([0.5, 1.0, 2.0, 3.0, 8.0, 9.0], np.float32)
    chunk = Chunk("c_chunk0", tt, np.ones((6, 3), np.float32), np.ones((6, 3), np.float32),
                  np.zeros(0, np.float32), [])
    ode = Config(**dict(PORT_KW, enable_text=False, model="LatentODE"))
    out = collate_chunks(ode, [chunk], 0, 14.0, 2, ode_caps=(8, 4))
    assert out["observed_tp"].shape[-1] == 8
    with pytest.raises(ValueError, match="static cap"):
        collate_chunks(ode, [chunk], 0, 14.0, 2, ode_caps=(2, 4))
    with pytest.raises(ValueError, match="static cap"):
        collate_chunks(ode, [chunk], 0, 14.0, 2, ode_caps=(8, 1))
    patch = Config(**dict(PORT_KW, enable_text=False, model="tPatchGNN", patch_size=2,
                          patch_stride=2, npatch=4))
    pinned = collate_chunks(patch, [chunk], 0, 14.0, 2, max_patch_len=16)["observed_tp"]
    assert pinned.shape == (2, 4, 16, 3)  # [B, npatch, the pinned patch length, D]
    with pytest.raises(ValueError, match="static cap"):
        collate_chunks(patch, [chunk], 0, 14.0, 2, max_patch_len=1)


def test_serve_artifact_over_http(dlinear_artifact):
    """`python -m imm_tsf_torch.serve --artifact` serves the programs:
    /healthz, /v1/forecast (an oversized batch is a 400) and /metrics."""
    from http.server import ThreadingHTTPServer

    from imm_tsf_torch.serve import build_service, make_handler, parse_args

    cfg, _, art, _ = dlinear_artifact
    svc = build_service(parse_args(["--artifact", art, "--device", "cpu"]))
    assert isinstance(svc, ExportedForecaster)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    post = lambda insts: urllib.request.Request(
        f"{url}/v1/forecast", data=json.dumps({"instances": insts}).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["model"] == "DLinear" and health["device"] == "cpu"
        insts = mixed_requests(cfg, 5, max_notes=3)
        with urllib.request.urlopen(post(insts[:2]), timeout=120) as r:
            body = json.loads(r.read())
        assert_answers_match(insts[:2], body["predictions"], svc.forecast(insts[:2]),
                             cfg.input_dim, rtol=0, atol=0)
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(post(insts), timeout=30)
        assert err.value.code == 400
        with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
            m = json.loads(r.read())
        assert m["artifact"] is True and m["requests_total"] == 4
        assert m["request_errors_total"] == 0 and m["dispatch_latency_ms"]["p50"] > 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
