"""Data parallelism over torch.distributed (parallel/mesh.py, multiproc.py,
the trainer's data mesh) against the single-process port and the JAX
package's ("data",) mesh, on the CPU.

One world of 2 gloo ranks (spawned processes, one thread each) is started
once for the module and runs every rank-side case (tests/torch_dp_cases.
py); the single-process and JAX references run here meanwhile. The JAX
side uses the conftest's 8 virtual CPU devices.

Tolerances, stated beside each check:
- the hash masks, the Dropout output and gradient, and #2's masks: bit for
  bit (the same uint32 index arithmetic);
- #2's plain forward rows at row_base against the JAX `ffn_reference` on the
  global batch: 2e-5 absolute (tests/test_torch_ffn_train.py's float32
  forward tolerance); its backward: dx rows 1e-4 absolute + 1e-4 relative,
  the ranks' summed weight gradients the same;
- the flagship DP step against JAX `run_dp_steps` on a 2-device mesh: rtol
  1e-5, atol 1e-7 (tests/test_multiprocess_dp.py:32);
- trainable over 2 ranks against the port's single-process run: per-epoch
  losses, best_iter and test metrics to rtol 2e-4 (tests/test_sharding.py:
  108; Informer's per-step losses against a single-process run that sums
  BatchNorm's statistics in the ranks' order, 1e-5, its metrics 1e-4);
  PatchTST from the JAX init against JAX trainable(mesh_shape=(2,)):
  per-step losses rtol 1e-5 and metrics 1e-4 (torch_port_parity.
  trainable_matches_jax's tolerances);
- the DP epoch loop against the DP streaming loop and a `--load` resume
  under 2 ranks against the uninterrupted run: bit for bit;
- the padded last batch: the DP loss equals the single-process loss to
  1e-6 relative, while the mean of the ranks' means is off by more than
  10 %;
- the sweep over the mesh (training/vmap_sweep.py): replica-sharded (S 2 at
  world 2, one replica a rank) bit for bit with the single-process
  train_seed_sweep of the same seeds, replica for replica, and the arrays
  of its train states and best weights equal to that sweep's; the
  data-parallel sweep (S 1 at world 2) within 1e-5 relative of it. The
  single-process sweep is held to the JAX package's by
  tests/test_torch_sweep.py (the port's form of tests/test_vmap_sweep.py:
  87-102); every process here runs one thread, so equality carries over.
"""

import os
import types

import jax
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.data.synthetic import make_synthetic_dataset
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.layers import fast_dropout as jdropout
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.ops.pallas import ffn_kernel as jffn

import imm_tsf_tpu.training.trainer as jtrainer
import torch_dp_cases as cases
from torch_port_parity import jitted_init_state, jitted_jax_init  # noqa: F401 -- autouse
from imm_tsf_torch import main as tmain
from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.kernels import ffn as tffn
from imm_tsf_torch.layers.fast_dropout import _keep_mask, draw_salts
from imm_tsf_torch.parallel import mesh as pmesh
from imm_tsf_torch.parallel import multiproc
from imm_tsf_torch.training.trainer import check_trainable

torch.set_num_threads(1)

WORLD = 2
EXP_ID = "dp_resume"
# the experiment of the trainable cases: EPA-Air's weekly windows with the
# fusion pair, dropout 0.1 (the hash masks at the ranks' offsets)
BASE = dict(dataset="EPA-Air", history=7, pred_window=7, stride=7, time_unit="days",
            enable_text=True, use_text_embeddings=True, llm_model_fusion="GPT2", d_txt=16,
            TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add", batch_size=8, epoch=2,
            patience=3, dropout=0.1, seed=3, lr=1e-3, w_decay=0.01, host_prefetch=0,
            d_model=16, d_ff=32, n_heads=2)
MODELS = {
    "PatchTST": dict(model="PatchTST", e_layers=1, use_pallas=True, use_fused_ffn=True),
    "Informer": dict(model="Informer", e_layers=2, d_layers=1, factor=3, distil=True),
    "TimesNet": dict(model="TimesNet", e_layers=1, d_ff=16, num_kernels=2, top_k=3),
}
# the sweeps over the mesh: PatchTST with #2 and hash dropout on the epoch loop
SWEEP = dict(BASE, **MODELS["PatchTST"])
# PatchTST from the JAX init against the JAX trainable (dropout 0: the two
# packages' salt streams differ), as tests/test_torch_patchtst_training.py
JAX_SLICE = dict(BASE, **MODELS["PatchTST"], dropout=0.0, device_loop=False)


def argv(kw: dict) -> list:
    out = []
    for k, v in kw.items():
        out += [f"--{k}", str(v)]
    return out + ["--device", "cpu"]


def jax_init(jcfg, batch, key):
    return jitted_init_state(jcfg, j_get_model(jcfg), JFusionModel(jcfg), batch, key)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The module's 2-rank world, started with every rank-side case; its
    results come with `world.results()`."""
    root = str(tmp_path_factory.mktemp("dp"))
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=3, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=16, seed=0)
    save = os.path.join(root, "exp") + "/"
    kw = {name: dict(BASE, data_root=root, save=save, **m) for name, m in MODELS.items()}

    # the flagship step's JAX init and two pinned salt pairs (its two sites)
    jcfg, jbatch = _jax_flagship()
    params, stats = jax_init(jcfg, jbatch, jax.random.PRNGKey(0))
    flag_state = params_from_jax(_np(params), _np(stats))
    gen = torch.Generator().manual_seed(11)
    salts = [draw_salts(gen) for _ in range(2)]

    # the JAX trainable's init for the PatchTST slice
    jslice = JConfig(data_root=root, **JAX_SLICE)
    data = j_parse_datasets(jslice, verbose=False)
    rng = jax.random.key(data["cfg"].seed, impl=data["cfg"].rng_impl)
    _, init_rng = jax.random.split(rng)
    jparams, _ = jax_init(data["cfg"], next(iter(data["train_dataloader"])), init_rng)
    patch_state = params_from_jax(_np(jparams))

    run = [
        ("keep_masks", "keep_masks", dict(shape=(6, 5, 7), salts=salts[0], keep_prob=0.8)),
        ("flagship", "flagship", dict(salts=salts, initial_state=flag_state, n_steps=2)),
        ("padded", "padded_step", {}),
        ("jax_slice", "train", dict(cfg_kw=dict(JAX_SLICE, data_root=root, mesh_shape=(WORLD,)),
                                    initial_state=patch_state)),
        ("resume_start", "cli", dict(argv=argv(dict(kw["PatchTST"], epoch=1,
                                                    mesh_shape=WORLD)),
                                     experiment_id=EXP_ID)),
        ("PatchTST_stream", "cli", dict(argv=argv(dict(kw["PatchTST"], device_loop=False,
                                                       mesh_shape=WORLD)),
                                        experiment_id="dp_stream")),
        ("sweep_split", "sweep", dict(cfg_kw=dict(SWEEP, data_root=root, mesh_shape=(WORLD,)),
                                      seeds=[3, 4], checkpoint_dir=os.path.join(root, "split"))),
        ("sweep_dp", "sweep", dict(cfg_kw=dict(SWEEP, data_root=root, mesh_shape=(WORLD,)),
                                   seeds=[3], lrs=[1e-3])),
    ] + [(name, "cli", dict(argv=argv(dict(k, mesh_shape=WORLD)), experiment_id=f"dp_{name}"))
         for name, k in kw.items()]
    w = multiproc.World(cases.run, WORLD, (run,), device="cpu", threads=1, timeout=900).start()
    box = {}

    def results() -> dict:
        if "out" not in box:
            out = w.join()
            assert out[0]["pid"] != out[1]["pid"]
            box["out"] = out
        return box["out"]

    yield types.SimpleNamespace(root=root, save=save, kw=kw, salts=salts, jcfg=jcfg,
                                jbatch=jbatch, jparams=jparams, results=results)
    w._stop()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_flagship():
    from imm_tsf_tpu.parallel.multiproc import flagship_case

    return flagship_case(WORLD)


# ------------------------------------------------------------ mesh rules
def test_shard_batch_rules_and_refusals(monkeypatch):
    batch = {"x": np.arange(24.0).reshape(4, 3, 2), "t": np.arange(5.0), "m": np.ones((4, 2)),
             "n_real": 3, "notes_text": [["a"]] * 4}
    for r in range(2):
        got = pmesh.shard_batch(batch, pmesh.DataMesh(2, r, "cpu"))
        assert sorted(got) == ["m", "t", "x"]  # non-arrays dropped
        np.testing.assert_array_equal(got["x"], batch["x"][2 * r:2 * r + 2])  # split on axis 0
        np.testing.assert_array_equal(got["t"], batch["t"])  # 1-D time axes whole
    assert sorted(pmesh.shard_batch(batch, None)) == ["m", "t", "x"]
    assert pmesh.make_mesh((), "cpu") is None
    assert pmesh.check_mesh_shape((4, 1)) == 4
    with pytest.raises(NotImplementedError, match="item 16, the TP half"):
        pmesh.check_mesh_shape((2, 2))
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        pmesh.DataMesh(2, 0, "cpu").rows(7)
    with pytest.raises(ValueError, match="batch_size 7 does not split"):
        check_trainable(TConfig(model="DLinear", batch_size=7, mesh_shape=(2,)))
    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        pmesh.make_mesh((2,), "cpu")
    # more cuda ranks than cards is refused unless the card is shared
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share one card"):
        pmesh.rank_device("cuda", 1, world=2)
    assert pmesh.rank_device("cuda", 1, world=2, share_card=True) == torch.device("cuda", 0)
    assert pmesh.rank_device("cuda", 0, world=1) == torch.device("cuda", 0)
    assert pmesh.rank_device("cpu", 1, world=2) == torch.device("cpu")


@pytest.mark.parametrize("device,backend,captured", [
    ("cuda", "gloo", False), ("cuda", "nccl", True), ("cpu", "gloo", True), ("cuda", None, True)])
def test_a_gloo_mesh_on_cuda_takes_eager_steps(monkeypatch, device, backend, captured):
    """gloo stages CUDA tensors through host memory, which a CUDA graph
    cannot hold: the epoch loop's steps run eagerly there (the CPU has no
    graphs in any case); NCCL's all-reduce is captured."""
    from imm_tsf_torch.training.graphs import eager_reason

    monkeypatch.setattr(pmesh.DataMesh, "backend", property(lambda self: backend))
    reason = eager_reason(TConfig(), pmesh.DataMesh(2, 0, device))
    assert (reason is None) == captured
    assert eager_reason(TConfig(), None) is None


def test_sweep_over_a_mesh_is_refused(world):
    """A sweep over a data mesh of 2 in a process with no process group of
    2 ranks is refused (main --mesh_shape 2 starts them)."""
    from imm_tsf_torch.training.vmap_sweep import train_seed_sweep

    with pytest.raises(RuntimeError, match="needs 2 ranks"):
        train_seed_sweep(TConfig(**dict(world.kw["PatchTST"], mesh_shape=(2,))), seeds=[1, 2],
                         device="cpu")


# ------------------------------------------------------------ hash masks
@pytest.mark.parametrize("shape", [(8, 5, 7), (6, 33), (4, 3, 2, 5)])
def test_keep_mask_ranks_are_rows_of_the_jax_global_mask(shape):
    """Each rank's mask at its offset (DataMesh.offset of its local element
    count), concatenated, is the JAX `_keep_mask` of the global shape, bit
    for bit."""
    s0, s1 = 0x9E3779B9, 0x12345678
    want = np.asarray(jdropout._keep_mask(np.uint32(s0), np.uint32(s1), 0.8, shape))
    local = (shape[0] // WORLD,) + shape[1:]
    parts = [_keep_mask(s0, s1, 0.8, local, offset=pmesh.DataMesh(WORLD, r, "cpu").offset(
        int(np.prod(local)))).numpy() for r in range(WORLD)]
    np.testing.assert_array_equal(np.concatenate(parts), want)
    assert 0 < want.mean() < 1


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_ffn_plain_version_at_row_base_matches_jax_global_rows(act):
    """Kernel #2's plain version on each half of a batch at row_base = M/2
    x rank: `_masks`, the eval form, the training form and the hand
    backward, against the JAX `ffn_reference` (and its jax.vjp) on the
    global batch, and the JAX `_keep_mask` of the global [M, F] and [M, D]."""
    M, D, F, kp = 64, 32, 96, 0.9
    rng = np.random.default_rng(3)
    args = [rng.standard_normal((M, D)), rng.standard_normal((D, F)) * 0.05,
            rng.standard_normal(F) * 0.1, rng.standard_normal((F, D)) * 0.05,
            rng.standard_normal(D) * 0.1, 1.0 + 0.1 * rng.standard_normal(D),
            0.1 * rng.standard_normal(D)]
    args = [a.astype(np.float32) for a in args]
    salts = rng.integers(0, 2**32, (2, 2)).astype(np.uint32)
    g = rng.standard_normal((M, D)).astype(np.float32)
    jargs = list(map(jax.numpy.asarray, args))
    want, vjp = jax.vjp(jax.jit(lambda *p: jffn.ffn_reference(*p, jax.numpy.asarray(salts),
                                                              kp, act, True)), *jargs)
    wgrads = vjp(jax.numpy.asarray(g))
    keep_a = np.asarray(jdropout._keep_mask(salts[0, 0], salts[0, 1], kp, (M, F)))
    keep_b = np.asarray(jdropout._keep_mask(salts[1, 0], salts[1, 1], kp, (M, D)))
    ts = torch.from_numpy(salts.astype(np.int64))
    w = [torch.from_numpy(a) for a in args[1:]]
    summed = None
    for r in range(WORLD):
        rows = slice(r * M // WORLD, (r + 1) * M // WORLD)
        base = rows.start
        x = torch.from_numpy(args[0][rows])
        ka, kb = tffn._masks(ts, kp, M // WORLD, D, F, "cpu", base)
        np.testing.assert_array_equal(ka.numpy(), keep_a[rows])
        np.testing.assert_array_equal(kb.numpy(), keep_b[rows])
        out = tffn.ffn_reference(x, *w, ts, kp, act, True, base)
        np.testing.assert_allclose(out.numpy(), np.asarray(want)[rows], atol=2e-5, rtol=0)
        out2, a1, res = tffn.ffn_forward_reference(x, *w, ts, kp, act, True,
                                                   with_residuals=True, row_base=base)
        assert torch.equal(out2, out)
        grads = tffn.ffn_backward_reference(x, w[0], w[2], w[4], ts, a1, res,
                                            torch.from_numpy(g[rows]), kp, act, True,
                                            row_base=base)
        np.testing.assert_allclose(grads[0].numpy(), np.asarray(wgrads[0])[rows], atol=1e-4,
                                   rtol=1e-4)
        summed = list(grads[1:]) if summed is None else [a + b for a, b in
                                                          zip(summed, grads[1:])]
        # the op (the kernel's CPU implementation) takes row_base too
        assert torch.equal(tffn.fused_encoder_ffn(x, *w, ts, kp, act, True, base), out)
    for name, gt, gj in zip(("w1", "b1", "w2", "b2", "gamma", "beta"), summed, wgrads[1:]):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


# ------------------------------------------------------------ DP steps
def test_flagship_dp_step_matches_jax_two_device_mesh(world, monkeypatch):
    """The flagship DLinear + fusion step over 2 gloo ranks from the JAX
    init, under the JAX run's salts, against JAX `run_dp_steps` on a
    2-device mesh: rtol 1e-5, atol 1e-7."""
    from jax.sharding import Mesh

    from imm_tsf_tpu.parallel.multiproc import run_dp_steps

    import itertools

    cycle = itertools.cycle(world.salts)
    monkeypatch.setattr(jdropout, "_key_salts",
                        lambda rng: tuple(jax.numpy.uint32(s) for s in next(cycle)))
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(WORLD), ("data",))
    want = run_dp_steps(world.jcfg, world.jbatch, mesh, n_steps=2)
    got = [r["flagship"] for r in world.results()]
    assert got[0] == got[1]  # the loss is all-reduced: every rank reports it
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-7)
    # the port's own batch builder draws the JAX package's bench batch
    cfg, batch = multiproc.flagship_case(WORLD)
    assert sorted(batch) == sorted(world.jbatch)
    for k in batch:
        np.testing.assert_array_equal(batch[k], world.jbatch[k])


def test_padded_last_batch_takes_the_global_count(world):
    """A padded last batch whose second rank holds 1 observation against the
    first rank's many: the DP loss (eval-mode and two train steps) equals
    the single-process loss of the whole batch, 1e-6 relative; a mean of
    the ranks' own masked means would be off by more than 10 %."""
    cfg, batch = cases.padded_batch(WORLD)
    single = cfg.replace(mesh_shape=())
    want_eval, _ = cases.eval_losses(single, batch, torch.device("cpu"), None)
    want = multiproc.run_dp_steps(single, batch, torch.device("cpu"), 2)
    got = [r["padded"] for r in world.results()]
    assert got[0]["counts"] > 10 * got[1]["counts"] > 0
    for g in got:
        np.testing.assert_allclose(g["shared"], want_eval, rtol=1e-6)
        np.testing.assert_allclose(g["losses"], want, rtol=1e-6)
    mean_of_means = np.mean([g["local"] for g in got])
    assert abs(mean_of_means - want_eval) > 0.1 * want_eval


# ------------------------------------------------------------ trainable
def _rank_order_stats(self, x):
    """BatchNorm's train statistics with its sums taken as the ranks take
    them (each rank's rows summed, then the ranks' sums added), in one
    process."""
    b, n = x.shape[0] // WORLD, x.shape[0] * x.shape[2]
    parts = [x[r * b:(r + 1) * b] for r in range(WORLD)]
    s1 = sum(p.sum(dim=(0, 2)) for p in parts)
    s2 = sum((p * p).sum(dim=(0, 2)) for p in parts)
    mean = s1 / n
    return mean, s2 / n - mean * mean


@pytest.mark.parametrize("model", sorted(MODELS))
def test_trainable_over_two_ranks_matches_single_process(world, model, monkeypatch):
    """`main --mesh_shape 2` (each rank's main._rank_main) against the
    single-process `main`: per-epoch losses, best_iter and the test mse,
    mae and rmse to rtol 2e-4 (tests/test_sharding.py's metrics; MAPE
    divides by truths near 0), per-step losses too. Informer's ProbSparse
    top-u choice turns a rounding-level change of its BatchNorm statistics
    into a 1e-3 step (a single-process run whose BatchNorm sums its rows in
    the ranks' order shows the same step), so its per-step losses are held
    to that run instead, rtol 1e-5, and its mse, mae and rmse, rtol 1e-4
    (torch_port_parity.trainable_matches_jax's metric tolerance); its MAPE
    moves 2.3e-4 between the two runs."""
    want = cases.summary(tmain.main(argv(world.kw[model])))
    got = world.results()[0][model]
    assert world.results()[1][model] is None  # rank 0 alone reports
    assert len(got["step_losses"]) == len(want["step_losses"]) >= 8
    np.testing.assert_allclose(got["train_losses"], want["train_losses"], rtol=2e-4)
    assert got["best_iter"] == want["best_iter"]
    for k in ("loss", "mse", "mae", "rmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, err_msg=k)
    if model == "Informer":
        from imm_tsf_torch.layers.transformer import BatchNorm

        monkeypatch.setattr(BatchNorm, "_stats", _rank_order_stats)
        want = cases.summary(tmain.main(argv(world.kw[model])))
        np.testing.assert_allclose(got["step_losses"], want["step_losses"], rtol=1e-5)
        for k in ("loss", "mse", "mae", "rmse"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    else:
        np.testing.assert_allclose(got["step_losses"], want["step_losses"], rtol=2e-4)
        np.testing.assert_allclose(got["mape"], want["mape"], rtol=2e-4)


def test_trainable_over_two_ranks_matches_jax_mesh(world):
    """PatchTST + TTF_RecAvg + MMF_GR_Add from the JAX init over 2 ranks
    against the JAX trainable(mesh_shape=(2,)): per-step losses rtol 1e-5,
    best_iter equal, test metrics rtol 1e-4."""
    losses = []
    build_steps = jtrainer.build_steps

    def recording_build_steps(*a, **k):
        train_step, eval_step = build_steps(*a, **k)

        def step(*args):
            out = train_step(*args)
            losses.append(float(out[-1]))
            return out

        return step, eval_step

    jtrainer.build_steps = recording_build_steps
    try:
        want = jtrainer.trainable(JConfig(data_root=world.root,
                                          **dict(JAX_SLICE, mesh_shape=(WORLD,))))
    finally:
        jtrainer.build_steps = build_steps
    got = world.results()[0]["jax_slice"]
    assert got == world.results()[1]["jax_slice"]
    assert len(got["step_losses"]) == len(losses) >= 8
    np.testing.assert_allclose(got["step_losses"], losses, rtol=1e-5)
    assert got["best_iter"] == want["best_iter"]
    for k in ("loss", "mse", "mae", "rmse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_dp_epoch_loop_equals_dp_streaming(world):
    """PatchTST over 2 ranks on the resident epoch loop (each rank's
    columns of the row table) and on the streaming loop (each rank's rows
    of the host batch): bit for bit."""
    got = world.results()[0]
    assert got["PatchTST_stream"] == got["PatchTST"]


def test_load_resumes_under_two_ranks(world):
    """`main --mesh_shape 2 --load <id>` (two spawned ranks) resumes the
    first epoch that the world's ranks trained and saved (rank 0 wrote it)
    and ends bit for bit where the uninterrupted 2-epoch run ended."""
    start = world.results()[0]["resume_start"]
    exp = os.path.join(world.save, f"experiment_{EXP_ID}")
    assert sorted(os.listdir(exp)) == ["best", "config.json", "train_state_0.pt"]
    res = tmain.main(argv(dict(world.kw["PatchTST"], mesh_shape=WORLD, load=EXP_ID)))
    got, want = cases.summary(res), world.results()[0]["PatchTST"]
    assert got["step_losses"][:4] == start["step_losses"] == want["step_losses"][:4]
    assert got == want


def test_dropout_on_two_ranks_matches_the_jax_global_dropout(world):
    """A train-mode Dropout on each rank of the world (its data mesh set):
    outputs and gradients are the rows of the JAX `_hash_dropout` over the
    global tensor, bit for bit."""
    shape, keep = (6, 5, 7), 0.8
    s0, s1 = world.salts[0]
    x = jax.numpy.arange(float(np.prod(shape)), dtype=jax.numpy.float32).reshape(shape)
    out, vjp = jax.vjp(jax.jit(lambda a: jdropout._hash_dropout(a, np.uint32(s0),
                                                                np.uint32(s1), keep, shape)), x)
    (grad,) = vjp(jax.numpy.ones(shape, jax.numpy.float32))
    got = [r["keep_masks"] for r in world.results()]
    np.testing.assert_array_equal(np.concatenate([g["out"] for g in got]), np.asarray(out))
    np.testing.assert_array_equal(np.concatenate([g["grad"] for g in got]), np.asarray(grad))


# ------------------------------------------------------------ sweeps
def _single_sweep(world, tmp_path, **kw):
    from imm_tsf_torch.training.vmap_sweep import train_seed_sweep

    res = train_seed_sweep(TConfig(**dict(SWEEP, data_root=world.root)), device="cpu", **kw)
    return [dict(cases.summary(r), seed=r["seed"], lr=r.get("lr")) for r in res]


def _assert_same_arrays(a, b, path=""):
    """Two saved states equal: tensors bit for bit, other values equal (wall
    seconds and rates aside)."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), path
    elif isinstance(a, dict):
        assert sorted(map(str, a)) == sorted(map(str, b)), path
        for k in a:
            _assert_same_arrays(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_arrays(x, y, f"{path}[{i}]")
    elif not path.endswith(("secs", "windows_per_sec")):
        assert a == b or (a != a and b != b), (path, a, b)


def test_replica_sharded_sweep_equals_the_single_process_sweep(world, tmp_path):
    """S 2 over 2 ranks, one replica a rank (no collective in a step): each
    replica's per-step losses, best epoch and test metrics, and the train
    states and best weights rank 0 saved, equal the single-process sweep's
    bit for bit; every rank returns every replica's results and holds the
    modules of its own."""
    from imm_tsf_torch.training.checkpoint import load_train_state, load_weights

    single = str(tmp_path / "single")
    want = _single_sweep(world, tmp_path, seeds=[3, 4], checkpoint_dir=single)
    got = [r["sweep_split"] for r in world.results()]
    for rank, res in enumerate(got):
        assert [r.pop("held") for r in res] == [i == rank for i in range(WORLD)]
        assert res == want
    split = os.path.join(world.root, "split")
    assert sorted(os.listdir(split)) == sorted(os.listdir(single))
    _assert_same_arrays(load_train_state(split), load_train_state(single))
    _assert_same_arrays(load_weights(os.path.join(split, "best")),
                        load_weights(os.path.join(single, "best")))
    with open(os.path.join(split, "best", "replicas.json")) as f, \
            open(os.path.join(single, "best", "replicas.json")) as g:
        assert f.read() == g.read()


def test_data_parallel_sweep_matches_the_single_process_sweep(world, tmp_path):
    """S 1 over 2 ranks (the grid does not split): the replica's batches
    split over the ranks, within 1e-5 relative of the single-process sweep
    (per-step losses and test metrics), the same best epoch; both ranks
    hold it."""
    (want,) = _single_sweep(world, tmp_path, seeds=[3], lrs=[1e-3])
    got = [r["sweep_dp"] for r in world.results()]
    assert got[0] == got[1]
    (res,) = got[0]
    assert res.pop("held") and res["best_iter"] == want["best_iter"]
    assert (res["seed"], res["lr"]) == (3, 1e-3)
    assert len(res["step_losses"]) == len(want["step_losses"]) >= 8
    np.testing.assert_allclose(res["step_losses"], want["step_losses"], rtol=1e-5)
    for k in ("loss", "mse", "mae", "rmse"):
        np.testing.assert_allclose(res[k], want[k], rtol=1e-5, err_msg=k)
