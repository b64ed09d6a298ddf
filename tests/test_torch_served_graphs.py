"""The served forward's runner (training/graphs.ForwardGraphs) on the CPU.

On cuda a live service's dispatch, an exported program's and a streaming
predict batch replay one CUDA graph a key (the batch's array names,
shapes and dtypes, and the service's kernel route); on the CPU the same
static buffers feed the eager forward. These tests hold that path: each
dispatch's answer equals the direct eager forward on the same batch bit
for bit (stale staging buffers would show), keys split where a collate's
bucket or the route changes and are reused by a smaller padded batch, the
artifact and streaming predict go through their runners, and small
PatchTST, CRU and LatentODE services still answer as the JAX package's
ForecastService does (1e-4 + 1e-4|ref|, tests/torch_port_parity.py). The
cuda side (replay against eager, one capture a key, launch counts, a route
flip, the pool freed) is in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from imm_tsf_torch.config import Config
from imm_tsf_torch.export import ExportedForecaster, export_experiment
from imm_tsf_torch.fusion.fusion_model import FusionModel
from imm_tsf_torch.models import get_model
from imm_tsf_torch.serving import ForecastService, _build_chunk
from imm_tsf_torch.training import graphs
from imm_tsf_torch.training.checkpoint import save_experiment

from torch_port_parity import D_TXT, EXPERIMENT, service_matches_jax
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

SMALL = dict(input_dim=3, input_len=16, pred_len=8)
MODELS = {
    "PatchTST": dict(model="PatchTST", d_model=16, d_ff=32, n_heads=2, e_layers=1,
                     use_pallas=True, use_fused_ffn=True),
    "CRU": dict(model="CRU", cru_lsd=8, cru_hidden_units=16),
    "tPatchGNN": dict(model="tPatchGNN", hid_dim=8, te_dim=4, node_dim=5, n_heads=2,
                      patch_size=2, patch_stride=2, npatch=4),
    "LatentODE": dict(model="LatentODE", ode_rec_dims=8, ode_units=16, ode_gru_units=8,
                      ode_latents=4),
}
LIVE_TOL = dict(rtol=1e-5, atol=1e-6)  # artifact vs live service (tests/test_torch_export.py)


def _experiment(exp_dir: str, model: str, **kw):
    cfg = Config(**{**EXPERIMENT, **SMALL, **MODELS[model], **kw})
    torch.manual_seed(0)
    save_experiment(exp_dir, cfg, get_model(cfg).state_dict(), FusionModel(cfg).state_dict())
    return cfg


def _request(rng, n_obs: int, n_pred: int, n_notes: int, early: bool = False) -> dict:
    """n_obs observed times in [0, 7) (in the first two days when `early`),
    n_pred forecast times in [7, 14], n_notes note embeddings."""
    span = 1.99 if early else 6.99
    return {"observed_tp": np.sort(rng.choice(np.linspace(0, span, 64), n_obs,
                                              replace=False)).tolist(),
            "observed_data": rng.standard_normal((n_obs, 3)).tolist(),
            "tp_to_predict": np.sort(rng.choice(np.linspace(7.0, 14.0, 32), n_pred,
                                                replace=False)).tolist(),
            "notes": [{"tau": float(rng.uniform(0, 7)),
                       "embedding": rng.standard_normal(D_TXT).tolist()}
                      for _ in range(n_notes)]}


def _signature(out: dict) -> tuple:
    return tuple(sorted((k, v.shape) for k, v in out.items() if isinstance(v, np.ndarray)))


def _dispatch(svc, insts) -> tuple:
    """One dispatch of `insts` through the service's runner, and the eager
    forward on the same host batch: (the batch's signature, its answer,
    the eager answer)."""
    out = svc._collate([_build_chunk(i, svc.cfg, svc.d_txt)[0] for i in insts])
    got = svc._predict(out)
    with torch.inference_mode():
        want = svc._forward(svc.to_device(out)).numpy()
    return _signature(out), got, want


def test_runner_keys_buffers_and_outputs():
    """Keys are the arrays' names, shapes and dtypes and the tag; other
    values are dropped; outputs may be a tuple or a dict; read-only
    (broadcast) arrays are copied in; each call reads its own values."""
    runner = graphs.ForwardGraphs(lambda b: (b["x"] * 2, {"s": b["y"].sum()}), "cpu")
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    y = np.broadcast_to(np.arange(3, dtype=np.int64), (2, 3))
    a, sums = runner({"x": x, "y": y, "n_real": 2, "notes_text": [["a"]]})
    assert a.dtype == torch.float32 and torch.equal(a, torch.from_numpy(x) * 2)
    assert int(sums["s"]) == 6 and runner.stats()["keys"] == 1
    b, _ = runner({"x": x + 1, "y": np.ascontiguousarray(y)})
    assert torch.equal(b, torch.from_numpy(x + 1) * 2) and not torch.equal(a, b)
    assert runner.stats()["keys"] == 1
    runner({"x": x[:1], "y": y[:1]})
    runner({"x": x, "y": y}, tag=(False,))
    runner({"x": x.astype(np.float64), "y": y})
    st = runner.stats()
    assert (st["keys"], st["graphs"], st["replays"], st["eager_calls"]) == (4, 0, 0, 5)
    runner.clear()
    assert runner.stats()["keys"] == 0


def test_dispatches_of_one_key_get_their_own_answers(tmp_path):
    """Two dispatches of one key (the warm-up's) with different requests:
    each answer equals the eager forward on its own batch bit for bit, and
    the two differ."""
    _experiment(str(tmp_path / "exp"), "PatchTST")
    svc = ForecastService(str(tmp_path / "exp"), max_batch=4, device="cpu")
    try:
        rng = np.random.default_rng(0)
        answers = []
        for _ in range(2):
            _, got, want = _dispatch(svc, [_request(rng, 9, 5, 3) for _ in range(3)])
            assert np.array_equal(got, want)
            answers.append(got)
        assert not np.array_equal(*answers)
        st = svc._graphs.stats()
        assert (st["keys"], st["eager_calls"], st["graphs"]) == (1, 3, 0)
        metrics = svc.metrics()
        assert metrics["graphs_captured"] == 0 and metrics["capture_s_total"] == 0
    finally:
        svc.close()
    assert svc._graphs.stats()["keys"] == 0


# model -> (its dispatches, each a list of requests (n_obs, n_pred, n_notes,
# early), the distinct batch shapes they make with the warm-up's)
SPLITS = {
    # the notes axis: <= 8 notes a bucket of 8, 10 notes one of 16
    "PatchTST": ([[(9, 5, 2, False)] * 3, [(9, 5, 10, False)] * 2, [(4, 3, 3, False)]], 2),
    # the per-patch axis: 12 points of a feature in one 2-day patch need 16
    "tPatchGNN": ([[(6, 5, 2, False)] * 3, [(12, 5, 2, True), (6, 5, 2, False)],
                   [(5, 3, 1, False)]], 2),
    # the union axes (observed, forecast): (8, 8), (16, 8), (8, 16), a request a
    # dispatch (pred_len 16 here)
    "LatentODE": ([[(5, 3, 2, False)], [(12, 3, 2, False)], [(4, 12, 2, False)],
                   [(6, 2, 1, False)]], 3),
}


@pytest.mark.parametrize("model", list(SPLITS))
def test_keys_split_by_bucket_and_a_padded_batch_reuses_its_key(tmp_path, model):
    """A new bucket of the notes axis, tPatchGNN's per-patch axis or the
    LatentODE's union axes is a new key; a smaller batch padded to
    max_batch with the same buckets replays its key; every dispatch equals
    the eager forward bit for bit."""
    _experiment(str(tmp_path / "exp"), model, **(dict(pred_len=16) if model == "LatentODE"
                                                 else {}))
    svc = ForecastService(str(tmp_path / "exp"), max_batch=4, device="cpu")
    try:
        rng = np.random.default_rng(1)
        dispatches, distinct = SPLITS[model]
        seen = {_signature(svc._collate([svc._dummy_chunk()]))}  # the warm-up's key
        assert svc._graphs.stats()["keys"] == 1
        for spec in dispatches:
            keys = svc._graphs.stats()["keys"]
            sig, got, want = _dispatch(svc, [_request(rng, *s) for s in spec])
            assert np.array_equal(got, want)
            assert svc._graphs.stats()["keys"] - keys == (sig not in seen)
            seen.add(sig)
        assert len(seen) == distinct == svc._graphs.stats()["keys"]
    finally:
        svc.close()


def test_a_route_flip_is_its_own_key(tmp_path, monkeypatch):
    """The kernel-route flags of the served modules and IMM_TSF_CRU_FUSED
    are in the key: a flipped route never replays the other route's graph,
    and flipping back reuses the first key."""
    _experiment(str(tmp_path / "exp"), "PatchTST")
    svc = ForecastService(str(tmp_path / "exp"), max_batch=4, device="cpu")
    try:
        flags = {flag for _, flag in svc._route_sites}
        assert flags == {"use_pallas", "use_fused_ffn"}
        insts = [_request(np.random.default_rng(2), 9, 5, 2)]
        _dispatch(svc, insts)
        assert svc._graphs.stats()["keys"] == 1
        (layer,) = [m for m, flag in svc._route_sites if flag == "use_fused_ffn"]
        layer.use_fused_ffn = False
        _, got, want = _dispatch(svc, insts)
        assert np.array_equal(got, want) and svc._graphs.stats()["keys"] == 2
        layer.use_fused_ffn = True
        _dispatch(svc, insts)
        assert svc._graphs.stats()["keys"] == 2
        monkeypatch.setenv("IMM_TSF_CRU_FUSED", "1")
        _dispatch(svc, insts)
        assert svc._graphs.stats()["keys"] == 3
    finally:
        svc.close()


def test_artifact_replays_through_its_runner(tmp_path):
    """An artifact at batch sizes 1 and 4: one key a batch size used, its
    answers the live service's (LIVE_TOL); close() drops the keys."""
    exp, art = str(tmp_path / "exp"), str(tmp_path / "art")
    _experiment(exp, "PatchTST")
    export_experiment(exp, art, batch_sizes=(1, 4), device="cpu")
    fc = ExportedForecaster(art, device="cpu")
    rng = np.random.default_rng(3)
    insts = [_request(rng, 9, 5, 2) for _ in range(3)]
    got = fc.forecast(insts) + fc.forecast(insts[:1]) + fc.forecast(insts[1:])
    assert fc._graphs.stats()["keys"] == 2 and fc.metrics()["graphs_captured"] == 0
    svc = ForecastService(exp, max_batch=4, device="cpu")
    try:
        live = svc.forecast(insts)
    finally:
        svc.close()
    for g, w in zip(got, live + live[:1] + live[1:]):
        assert g["tp"] == w["tp"]
        np.testing.assert_allclose(g["prediction"], w["prediction"], **LIVE_TOL)
    fc.close()
    assert fc._graphs.stats()["keys"] == 0


def test_streaming_predict_runs_through_the_runner(synth_root, tmp_path, monkeypatch):
    """`predict --device_loop false` runs each batch through one runner:
    one key (the loader pads the last batch), the warm-up and every batch
    eager on the CPU, the metrics the resident path's."""
    from imm_tsf_torch import main as train_main
    from imm_tsf_torch import predict

    runners = []

    class Recorded(graphs.ForwardGraphs):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            runners.append(self)

    save = tmp_path / "save"
    flags = ["--dataset", "EPA-Air", "--model", "DLinear", "--batch_size", "8",
             "--data_root", synth_root, "--save", str(save), "--device", "cpu"]
    train_main.main(flags + ["--epoch", "1", "--seed", "7"])
    exp = next(save.iterdir()).name.split("experiment_")[1]
    monkeypatch.setattr(graphs, "ForwardGraphs", Recorded)
    resident = predict.main(flags + ["--load", exp])
    streaming = predict.main(flags + ["--load", exp, "--device_loop", "false"])
    assert (resident["path"], streaming["path"]) == ("resident", "streaming")
    (runner,) = runners
    n_batches = -(-streaming["n_windows"] // 8)
    st = runner.stats()
    assert (st["keys"], st["eager_calls"], st["graphs"]) == (1, n_batches + 1, 0)
    for k in ("test_mse", "test_mae"):
        assert abs(resident[k] - streaming[k]) <= 1e-9 * abs(resident[k])


@pytest.mark.parametrize("model", ["PatchTST", "CRU", "LatentODE"])
def test_service_matches_jax_service(tmp_path, model):
    """The port's service (its dispatches through the runner) against the
    JAX package's ForecastService on the CPU, 1e-4 + 1e-4|ref|."""
    kw = {k: v for k, v in MODELS[model].items() if k not in ("use_pallas", "use_fused_ffn")}
    metrics = service_matches_jax(tmp_path, dict(kw, **SMALL), n_requests=6)
    assert metrics["graphs_captured"] == 0 and metrics["capture_s_total"] == 0
