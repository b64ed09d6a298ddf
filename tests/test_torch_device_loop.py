"""The port's device-resident and epoch-staged epoch loops
(imm_tsf_torch/training/device_loop.py, training/graphs.py) on the CPU,
where every step runs eagerly through the same buffers a captured step
reads (the store, the row table, the salt table, the loss buffer):

- resident against streaming, bit for bit on per-step losses and test
  metrics: DLinear, CRU on both routes, PatchTST with hash dropout 0.1;
  tPatchGNN (Lp zero-padded to the split's largest) and the staged
  LatentODE to 2e-4 relative, the JAX package's own tolerance
  (tests/test_device_loop.py:34-75). The LatentODE runs without dropout:
  a hash mask is a function of the padded shape it covers, so the staged
  epoch's longer union axes draw other masks (in both packages);
- the port's resident run against the JAX package's (device_loop on both,
  dropout 0, the JAX init through params_from_jax): losses to 1e-5
  relative, metrics to 1e-4;
- try_build_resident's arrays equal the JAX ones, its remainder batch and
  its size cap; epoch_perm, eval_perm and stage_epoch equal the JAX ones;
  reduce_eval_sums; make_predict_runner against the JAX run_predict to
  2e-5; _unwrap shares the embedding cache; a raw-text fusion run."""

import numpy as np
import pytest
import torch

import imm_tsf_tpu.training.device_loop as jdl
import imm_tsf_tpu.training.trainer as jtrainer
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.models import get_model as j_get_model

from imm_tsf_torch.config import Config
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.data.loader import BatchIterator, PrefetchIterator, parse_datasets
from imm_tsf_torch.data.synthetic import make_synthetic_dataset
from imm_tsf_torch.fusion.fusion_model import FusionModel
from imm_tsf_torch.models import get_model
from imm_tsf_torch.training import device_loop as DL
from imm_tsf_torch.training.graphs import StepLoop
from imm_tsf_torch.training.trainer import (_EmbedNotesLoader, _find_shuffler, make_forward,
                                            trainable)
from torch_port_parity import EXPERIMENT, np_tree
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

KW = dict(EXPERIMENT, batch_size=8, epoch=2, patience=3, seed=3, lr=1e-3, w_decay=0.01,
          host_prefetch=0)
SMALL = {"DLinear": {}, "CRU": dict(cru_lsd=8, cru_hidden_units=16),
         "PatchTST": dict(d_model=16, d_ff=32, n_heads=2, e_layers=1, dropout=0.1),
         "tPatchGNN": dict(hid_dim=8, te_dim=4, node_dim=4, nlayer=1),
         "LatentODE": dict(ode_rec_dims=8, ode_units=8, ode_gru_units=8, ode_latents=4,
                           ode_substeps=1, dropout=0.0)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("device_loop"))
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=3, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=16, seed=0)
    return root


def _losses(res):
    return [x for h in res["history"] for x in h["step_losses"]]


def _both_loops(root, model, **over):
    kw = dict(KW, model=model, data_root=root, **SMALL[model], **over)
    return [trainable(Config(**kw, device_loop=dl), device="cpu") for dl in (True, False)]


@pytest.mark.parametrize("model, fused", [("DLinear", False), ("CRU", False), ("CRU", True),
                                          ("PatchTST", False)],
                         ids=["DLinear", "CRU_default", "CRU_fused", "PatchTST_dropout"])
def test_resident_equals_streaming_bit_for_bit(root, monkeypatch, model, fused):
    if fused:
        monkeypatch.setenv("IMM_TSF_CRU_FUSED", "1")
    loop, stream = _both_loops(root, model)
    assert len(_losses(loop)) >= 8 and _losses(loop) == _losses(stream)
    assert loop["best_iter"] == stream["best_iter"]
    for k in ("mse", "mae", "rmse", "mape"):
        assert loop[k] == stream[k], k
    assert [h["val"] for h in loop["history"]] == [h["val"] for h in stream["history"]]


@pytest.mark.parametrize("model", ["tPatchGNN", "LatentODE"])
def test_padded_loops_match_streaming(root, model):
    loop, stream = _both_loops(root, model)
    np.testing.assert_allclose(_losses(loop), _losses(stream), rtol=2e-4)
    for k in ("mse", "mae"):
        np.testing.assert_allclose(loop[k], stream[k], rtol=2e-4, err_msg=k)


def test_resident_build_refuses_the_ode_collate_and_stages(root):
    data = parse_datasets(Config(**dict(KW, model="LatentODE", data_root=root)), verbose=False)
    assert DL.try_build_resident(data["train_dataloader"]) is None
    staged = DL.stage_epoch(data["val_dataloader"])
    assert staged["observed_tp"].ndim == 2  # [n_batches, T]: a union axis a batch
    assert staged["observed_tp"].shape[0] == len(data["val_dataloader"])


def test_resident_run_matches_jax_resident_run(root, monkeypatch):
    """Both packages' default loop (resident; the JAX one a lax.scan an
    epoch), dropout 0, from the JAX init."""
    kw = dict(KW, model="DLinear", data_root=root, dropout=0.0, device_loop=True)
    cfg = JConfig(**kw)
    data = j_parse_datasets(cfg, verbose=False)
    import jax

    rng = jax.random.key(cfg.seed, impl=cfg.rng_impl)
    rng, init_rng = jax.random.split(rng)
    jcfg = data["cfg"]
    params, stats = jtrainer.init_state(jcfg, j_get_model(jcfg), JFusionModel(jcfg),
                                        next(iter(data["train_dataloader"])), init_rng)
    losses = []
    make_runners = jdl.make_epoch_runners

    def recording(*a, **k):
        run_train, run_eval = make_runners(*a, **k)

        def run(*args):
            out = run_train(*args)
            losses.extend(np.asarray(out[-1]).tolist())
            return out

        return run, run_eval

    monkeypatch.setattr(jdl, "make_epoch_runners", recording)
    want = jtrainer.trainable(cfg)
    got = trainable(Config(**kw), device="cpu",
                    initial_state=params_from_jax(np_tree(params), np_tree(stats)))
    assert len(losses) >= 8
    np.testing.assert_allclose(_losses(got), losses, rtol=1e-5)
    assert got["best_iter"] == want["best_iter"]
    for k in ("mse", "mae", "rmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def _loaders(root, model="DLinear", batch_size=8, seed=0):
    kw = dict(KW, model=model, data_root=root, batch_size=batch_size, seed=seed, **SMALL[model])
    return (parse_datasets(Config(**kw), verbose=False),
            j_parse_datasets(JConfig(**kw), verbose=False))


def test_resident_arrays_and_tables_equal_jax(root):
    port, jax_ = _loaders(root)
    for split in ("train_dataloader", "val_dataloader", "test_dataloader"):
        (got, rows), (want, jrows) = (DL.try_build_resident(port[split]),
                                      jdl.try_build_resident(jax_[split]))
        assert got.keys() == want.keys() and np.array_equal(rows, jrows)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    bit, jbit = _find_shuffler(port["train_dataloader"]), jtrainer._find_shuffler(
        jax_["train_dataloader"])
    res, row_of = DL.try_build_resident(port["train_dataloader"])
    n_rows = next(iter(res.values())).shape[0]
    assert not any(v[-1].any() for v in res.values())  # the all-zero pad window
    for _ in range(2):  # two epochs: the same shuffle calls
        perm = DL.epoch_perm(bit, row_of, n_rows)
        assert np.array_equal(perm, jdl.epoch_perm(jbit, row_of, n_rows))
        assert (np.bincount(perm.ravel(), minlength=n_rows)[:-1] == 1).all()
    assert np.array_equal(DL.eval_perm(bit, row_of, n_rows),
                          jdl.eval_perm(jbit, row_of, n_rows))


def test_resident_remainder_batch_and_size_cap(root):
    port, _ = _loaders(root, batch_size=5)
    bit = _find_shuffler(port["train_dataloader"])
    n = len(bit.indices)
    assert n % 5 != 0
    res, _ = DL.try_build_resident(PrefetchIterator(port["train_dataloader"]))
    assert all(v.shape[0] == n + 1 for v in res.values())
    assert DL.try_build_resident(port["train_dataloader"], max_bytes=1000) is None


def test_stage_epoch_equals_jax(root):
    port, jax_ = _loaders(root, model="LatentODE")
    for split in ("val_dataloader", "train_dataloader"):
        got, want = DL.stage_epoch(port[split]), jdl.stage_epoch(jax_[split])
        assert got.keys() == want.keys()
        for k in want:
            assert np.array_equal(got[k], want[k]), (split, k)


def test_reduce_eval_sums_is_the_sequential_float64_sum():
    rng = np.random.default_rng(0)
    stack = {k: rng.standard_normal((7, 5)).astype(np.float32) * 10.0 ** rng.integers(-3, 4)
             for k in ("se", "ae", "ape", "cnt", "cnt_mape")}
    got = DL.reduce_eval_sums({k: torch.from_numpy(v) for k, v in stack.items()})
    want = jdl.reduce_eval_sums(stack)
    for k in stack:
        acc = stack[k][0].astype(np.float64)
        for row in stack[k][1:]:
            acc = acc + row
        assert np.array_equal(got[k], want[k]) and np.array_equal(got[k], acc)


def test_predict_runner_matches_jax_run_predict(root):
    port, jax_ = _loaders(root)
    jcfg = jax_["cfg"]
    jm, jf = j_get_model(jcfg), JFusionModel(jcfg)
    import jax

    params, stats = jtrainer.init_state(jcfg, jm, jf, next(iter(jax_["val_dataloader"])),
                                        jax.random.PRNGKey(5))
    jres, jrows = jdl.try_build_resident(jax_["val_dataloader"])
    jbit = jtrainer._find_shuffler(jax_["val_dataloader"])
    n_rows = next(iter(jres.values())).shape[0]
    want_pred, want_sums = jdl.make_predict_runner(jcfg, jm, jf, None)(
        params, stats, jres, jdl.eval_perm(jbit, jrows, n_rows))

    cfg = port["cfg"]
    model, fusion = get_model(cfg), FusionModel(cfg, d_notes=16)
    mstate, fstate = params_from_jax(np_tree(params), np_tree(stats))
    model.load_state_dict(mstate)
    fusion.load_state_dict(fstate)
    model.eval(), fusion.eval()
    res = DL.Resident("val", DL.try_build_resident(port["val_dataloader"]),
                      _find_shuffler(port["val_dataloader"]), "cpu")
    pred, sums = DL.make_predict_runner(make_forward(cfg, model, fusion), StepLoop("cpu"))(res)
    np.testing.assert_allclose(pred.numpy(), np.asarray(want_pred), atol=2e-5, rtol=0)
    for k, v in want_sums.items():
        np.testing.assert_allclose(sums[k].numpy(), np.asarray(v), atol=2e-5, rtol=2e-5,
                                   err_msg=k)


def test_unwrap_rebuilds_the_stages_around_a_shared_cache():
    base = BatchIterator(list(range(10)), list(range(10)), 4, lambda b: {}, shuffle=False)
    stage = _EmbedNotesLoader(base, llm=None, tokenizer=None, max_length=16)
    stage._cache["a note"] = np.ones(3, np.float32)
    bit, rebuild = DL._unwrap(PrefetchIterator(stage))
    assert bit is base
    probe = BatchIterator(base.chunks, base.indices, 4, base.collate_fn, shuffle=False)
    rebuilt = rebuild(probe)
    assert isinstance(rebuilt, _EmbedNotesLoader) and rebuilt.base is probe
    assert rebuilt._cache is stage._cache
    assert DL._unwrap(base) == (base, None)


def test_raw_text_fusion_on_the_resident_loop(root):
    """Notes embedded by a 1-layer GPT-2 in the loader stage: the resident
    build embeds each window once through the rebuilt stage (its cache the
    stage's own) and trains as the streaming loop does."""
    over = dict(use_text_embeddings=False, llm_layers_fusion=1, epoch=1)
    loop, stream = _both_loops(root, "DLinear", **over)
    np.testing.assert_allclose(_losses(loop), _losses(stream), rtol=2e-4)
    for k in ("mse", "mae"):
        np.testing.assert_allclose(loop[k], stream[k], rtol=2e-4, err_msg=k)
