"""The port's serving path against the JAX package's, on the CPU.

One PatchTST + TTF_RecAvg + MMF_GR_Add experiment is initialised by the
JAX package and saved as an orbax checkpoint + config.json; its weights
are carried into a port experiment directory with convert.params_from_jax.
Both ForecastServices then answer the same micro-batched requests to 1e-4
(float32; the request path adds de-normalisation by `std`, which scales
the 2e-5 module gap). Also: validation errors match, the port's HTTP
server answers, the default device is cuda, and no port module imports
JAX or the JAX package."""

import ast
import json
import os
import pathlib
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig

from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.serving import ForecastService
from imm_tsf_torch.training.checkpoint import save_experiment
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

D_TXT = 16
CFG_KW = dict(
    model="PatchTST", dataset="EPA-Air", history=7, pred_window=7, stride=7,
    time_unit="days", e_layers=2, d_model=32, d_ff=64, n_heads=2,
    input_dim=3, input_len=16, pred_len=8, enable_text=True,
    use_text_embeddings=True, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
    llm_model_fusion="GPT2", d_txt=D_TXT, recency_sigma=2.0, use_fused_ffn=True,
)


@pytest.fixture(scope="module")
def experiments(tmp_path_factory):
    """(jax_dir, port_dir): the same random weights in both formats."""
    from imm_tsf_tpu.data import collate as C
    from imm_tsf_tpu.data.dataset import Chunk
    from imm_tsf_tpu.fusion.fusion_model import FusionModel
    from imm_tsf_tpu.models import get_model
    from imm_tsf_tpu.training.checkpoint import save_checkpoint
    from imm_tsf_tpu.training.trainer import init_state

    cfg = JConfig(**CFG_KW)
    root = tmp_path_factory.mktemp("serve_parity")
    jdir, tdir = str(root / "jax_exp"), str(root / "port_exp")
    chunk = Chunk("warm_chunk0", np.asarray([0.0, 1.0, 8.0], np.float32),
                  np.zeros((3, 3), np.float32), np.ones((3, 3), np.float32),
                  np.asarray([0.5], np.float32), [np.ones(D_TXT, np.float32)])
    batch = C.add_multimodal(
        C.standard_collate([chunk], 7.0, 14.0, cfg.input_len, cfg.pred_len),
        [chunk], True, True, 1, D_TXT)
    params, stats = init_state(cfg, get_model(cfg), FusionModel(cfg), batch,
                               jax.random.PRNGKey(3))
    # a non-default sigma so the recency weights are not all near 0 or 1
    params["fusion"]["ttf"]["log_recency_sigma"] = np.float32(np.log(1.7))
    os.makedirs(jdir)
    with open(os.path.join(jdir, "config.json"), "w") as f:
        f.write(cfg.to_json())
    save_checkpoint(os.path.join(jdir, "best"), params, stats, 0)
    mstate, fstate = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    from imm_tsf_torch.config import load_saved_config

    save_experiment(tdir, load_saved_config(os.path.join(jdir, "config.json")),
                    mstate, fstate, step=0)
    return jdir, tdir


def _requests(seed, k):
    """Ragged requests: 0-16 observations with NaN holes, 1-8 forecast
    times, 0-6 notes (some none), some with mean/std."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        n = int(rng.integers(0, 17))
        m = int(rng.integers(1, 9))
        tt = np.sort(rng.choice(np.linspace(0, 6.99, 60), n, replace=False))
        vals = rng.standard_normal((n, 3))
        vals[rng.random(vals.shape) < 0.2] = np.nan
        tp = np.sort(rng.choice(np.linspace(7.0, 14.0, 30), m, replace=False))
        inst = {"observed_tp": tt.tolist(), "observed_data": vals.tolist(),
                "tp_to_predict": tp.tolist()}
        n_notes = 0 if i % 4 == 1 else int(rng.integers(1, 7))
        inst["notes"] = [{"tau": float(rng.uniform(0, 7)),
                          "embedding": rng.standard_normal(D_TXT).tolist()}
                         for _ in range(n_notes)]
        if i % 3 == 0:
            inst["mean"] = rng.standard_normal(3).tolist()
            inst["std"] = (0.5 + rng.random(3)).tolist()
        out.append(inst)
    return out


def _submit_all(svc, insts):
    futs = [svc.submit(i) for i in insts]
    return [f.result(timeout=300) for f in futs]


def test_port_service_matches_jax_service(experiments):
    from imm_tsf_tpu.serving import ForecastService as JForecastService

    jdir, tdir = experiments
    insts = _requests(0, 10)
    jsvc = JForecastService(jdir, max_batch=4, max_wait_ms=20.0)
    try:
        want = _submit_all(jsvc, insts)
    finally:
        jsvc.close()
    tsvc = ForecastService(tdir, max_batch=4, max_wait_ms=20.0, device="cpu")
    try:
        got = _submit_all(tsvc, insts)
        serial = [tsvc.forecast([i])[0] for i in insts[:3]]
        assert tsvc.metrics()["dispatches_total"] < len(insts) + 3
    finally:
        tsvc.close()
    for inst, g, w in zip(insts, got, want):
        assert g["tp"] == w["tp"] == sorted(np.float32(inst["tp_to_predict"]).tolist())
        ga, wa = np.asarray(g["prediction"]), np.asarray(w["prediction"])
        assert ga.shape == (len(inst["tp_to_predict"]), 3)
        assert np.isfinite(ga).all()
        np.testing.assert_allclose(ga, wa, atol=1e-4, rtol=1e-4)
    # a request's answer does not depend on its batch neighbours
    for g, s in zip(got[:3], serial):
        np.testing.assert_allclose(g["prediction"], s["prediction"], atol=1e-5, rtol=1e-5)


_DEFECTS = [
    lambda i: i.update(tp_to_predict=[]),
    lambda i: i.update(observed_data=[[0.0, 0.0]] * len(i["observed_tp"])),
    lambda i: i.pop("observed_tp"),
    lambda i: i.update(tp_to_predict=[7.5, 7.5]),
    lambda i: i.update(observed_tp=[1.0, 1.0], observed_data=[[0.0] * 3] * 2),
    lambda i: i.update(tp_to_predict=[700.0]),
    lambda i: i.update(tp_to_predict=[3.0]),
    lambda i: i.update(observed_tp=1.5),
    lambda i: i.update(observed_data="garbage"),
    lambda i: i.update(observed_mask=[[1.0]]),
    lambda i: i.update(observed_tp=[8.0], observed_data=[[0.0] * 3]),
    lambda i: i.update(observed_tp=list(np.linspace(0, 6.9, 17)),
                       observed_data=[[0.0] * 3] * 17),
    lambda i: i.update(tp_to_predict=list(np.linspace(7, 14, 9))),
    lambda i: i.update(notes=[{"no_tau": 1}]),
    lambda i: i.update(notes=[{"tau": 0.0}]),
    lambda i: i.update(notes=[{"tau": 0.0, "text": "raw"}]),
    lambda i: i.update(notes=[{"tau": 0.0, "embedding": [0.0] * (D_TXT + 1)}]),
    lambda i: i.update(mean=[0.0]),
]


def test_validation_errors_match_jax(experiments):
    from imm_tsf_tpu.serving import _build_chunk as j_build_chunk
    from imm_tsf_tpu.config import load_saved_config as j_load

    from imm_tsf_torch.config import load_saved_config as t_load
    from imm_tsf_torch.serving import _build_chunk as t_build_chunk

    jdir, tdir = experiments
    jcfg = j_load(os.path.join(jdir, "config.json"))
    tcfg = t_load(os.path.join(tdir, "config.json"))
    for k, mutate in enumerate(_DEFECTS):
        inst = _requests(100 + k, 1)[0]
        inst["observed_tp"] = [0.5, 1.5]
        inst["observed_data"] = [[0.1, 0.2, 0.3]] * 2
        mutate(inst)
        with pytest.raises(ValueError) as je:
            j_build_chunk(json.loads(json.dumps(inst)), jcfg, D_TXT)
        with pytest.raises(ValueError) as te:
            t_build_chunk(json.loads(json.dumps(inst)), tcfg, D_TXT)
        assert str(te.value) == str(je.value), k


def test_port_service_rejects_defects_and_keeps_serving(experiments):
    _, tdir = experiments
    svc = ForecastService(tdir, max_batch=2, max_wait_ms=1.0, device="cpu")
    try:
        good = _requests(7, 1)[0]
        fut = svc.submit(good)
        with pytest.raises(ValueError, match="empty"):
            svc.forecast([good, dict(good, tp_to_predict=[])])
        assert np.isfinite(np.asarray(fut.result(timeout=60)["prediction"])).all()
        assert np.isfinite(np.asarray(svc.forecast([good])[0]["prediction"])).all()
    finally:
        svc.close()
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(good)


def test_port_http_server_round_trip(experiments):
    from http.server import ThreadingHTTPServer

    from imm_tsf_torch.serve import make_handler

    _, tdir = experiments
    svc = ForecastService(tdir, max_batch=4, max_wait_ms=5.0, device="cpu")
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(svc))
    port = httpd.server_address[1]
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"] and health["model"] == "PatchTST"
        assert health["device"] == "cpu"
        insts = _requests(11, 3)
        req = urllib.request.Request(
            f"{base}/v1/forecast", data=json.dumps({"instances": insts}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert len(body["predictions"]) == 3
        for inst, p in zip(insts, body["predictions"]):
            arr = np.asarray(p["prediction"])
            assert arr.shape == (len(inst["tp_to_predict"]), 3)
            assert np.isfinite(arr).all()
        bad = urllib.request.Request(
            f"{base}/v1/forecast", data=json.dumps({"instances": [{"tp_to_predict": [7.0]}]}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as r:
            m = json.loads(r.read())
        assert m["requests_total"] >= 3 and m["dispatch_latency_ms"]["p50"] > 0
    finally:
        httpd.shutdown()
        httpd.server_close()
        svc.close()
    t.join(timeout=30)
    assert not t.is_alive()


def test_entry_points_default_to_cuda(experiments):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    from imm_tsf_torch import serve

    _, tdir = experiments
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ForecastService(tdir)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--load", tdir, "--port", "0"])


def test_raw_text_experiments_are_refused(experiments):
    """A raw-text experiment (use_text_embeddings=false) refuses
    precomputed embeddings and takes {"tau", "text"} notes, as the JAX
    package's service does; serving it end to end is
    tests/test_torch_llm.py::test_raw_text_service_matches_jax."""
    from imm_tsf_tpu.serving import _build_chunk as j_build_chunk

    from imm_tsf_torch.config import Config
    from imm_tsf_torch.serving import _build_chunk as t_build_chunk

    tcfg = Config(**{**CFG_KW, "use_text_embeddings": False})
    jcfg = JConfig(**{**CFG_KW, "use_text_embeddings": False})
    inst = _requests(5, 1)[0]
    inst["notes"] = [{"tau": 0.5, "embedding": [0.0] * D_TXT}]
    with pytest.raises(ValueError) as je:
        j_build_chunk(inst, jcfg, D_TXT)
    with pytest.raises(ValueError, match="embeds raw text") as te:
        t_build_chunk(inst, tcfg, D_TXT)
    assert str(te.value) == str(je.value)
    inst["notes"] = [{"tau": 0.5, "text": "ozone rising"}, {"tau": 1.0, "text": ""}]
    chunk, _, _ = t_build_chunk(inst, tcfg, D_TXT)
    assert chunk.note_payloads == ["ozone rising", ""]
    assert chunk.note_payloads == j_build_chunk(inst, jcfg, D_TXT)[0].note_payloads


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "imm_tsf_tpu", "pandas", "sklearn")


def test_port_never_imports_jax_or_the_jax_package():
    repo = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((repo / "imm_tsf_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in _FORBIDDEN, f"{path}: imports {name}"
