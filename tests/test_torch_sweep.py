"""The port's stacked-replica sweep (imm_tsf_torch/training/vmap_sweep.py),
on the CPU.

- Each replica (s, l) of a 2-seed x 2-lr sweep equals the port's serial
  trainable(seed=s, lr=l, data_seed=base) bit for bit, on the resident
  loop (eager StepLoop steps) and streaming: per-step losses, val metrics
  each epoch, test metrics, best epoch, with hash dropout 0.1 so that
  every replica's salt stream is its serial run's.
- The sweep from each replica's JAX init (key(s) -> split -> init_state,
  through params_from_jax) against the JAX package's train_seed_sweep, at
  dropout 0: per-epoch train loss within 1e-5 relative, val and test
  metrics within 1e-4 (float32 sums in another order, carried through a
  few Adam steps), the same best epoch and divergence.
- Resume equals the uninterrupted sweep bit for bit; best/ holds each
  replica's best-epoch weights (equal to its serial run's best/) and
  replicas.json; without a test split each replica reports its best
  epoch's val metrics; a replica driven to NaN is frozen and marked
  diverged while the rest finish, and all diverged raises; a grid that
  does not match the checkpoint on --load raises the JAX message.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import imm_tsf_tpu.training.trainer as jtrainer
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.models import get_model as j_get_model
from imm_tsf_tpu.training.vmap_sweep import train_seed_sweep as j_train_seed_sweep

from imm_tsf_torch import main as train_main
from imm_tsf_torch.config import Config
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.data.loader import parse_datasets
from imm_tsf_torch.data.synthetic import make_synthetic_dataset
from imm_tsf_torch.training.checkpoint import load_weights
from imm_tsf_torch.training.trainer import trainable
from imm_tsf_torch.training.vmap_sweep import train_seed_sweep
from torch_port_parity import D_TXT, EXPERIMENT, np_tree
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)

SEEDS, LRS = [1, 2], [1e-3, 1e-2]
KW = dict(EXPERIMENT, model="PatchTST", d_model=16, d_ff=32, n_heads=2, e_layers=1,
          dropout=0.1, batch_size=8, epoch=4, patience=1, seed=1, lr=1e-3, w_decay=0.01,
          host_prefetch=0)  # patience 1: replica (1, 1e-2) stops an epoch before the rest
METRICS = ("loss", "mse", "mae", "rmse", "mape")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sweep"))
    make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=3, n_days=100,
                           obs_per_day=1.2, notes_per_day=0.7, d_txt=D_TXT, seed=0)
    return root


def _cfg(root, **kw) -> Config:
    return Config(data_root=root, **dict(KW, **kw))


@pytest.fixture(scope="module")
def serial(root, tmp_path_factory):
    """(seed, lr) -> the port's serial trainable run and its experiment dir."""
    out = {}
    for lr in LRS:
        for s in SEEDS:
            exp = str(tmp_path_factory.mktemp(f"serial_{s}_{lr}"))
            out[(s, lr)] = (trainable(_cfg(root, seed=s, lr=lr, data_seed=KW["seed"]),
                                      device="cpu", checkpoint_dir=exp), exp)
    return out


@pytest.fixture(scope="module")
def sweeps(root, tmp_path_factory):
    """mode -> (the sweep's results, its checkpoint dir)."""
    out = {}
    for mode, loop in (("resident", True), ("streaming", False)):
        exp = str(tmp_path_factory.mktemp(f"sweep_{mode}"))
        timings: dict = {}
        res = train_seed_sweep(_cfg(root, device_loop=loop), seeds=SEEDS, lrs=LRS,
                               checkpoint_dir=exp, device="cpu", timings=timings)
        assert timings["epoch_loop"]["mode"] == mode
        out[mode] = (res, exp)
    return out


def _assert_same_run(got: dict, want: dict, what: str):
    assert got["best_iter"] == want["best_iter"], what
    for k in METRICS:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), (what, k)
    assert len(got["history"]) == len(want["history"]), what
    for hg, hw in zip(got["history"], want["history"]):
        assert hg["step_losses"] == hw["step_losses"], (what, hg["epoch"])
        assert hg["val"] == hw["val"], (what, hg["epoch"])


@pytest.mark.parametrize("mode", ["resident", "streaming"])
def test_each_replica_equals_its_serial_run(sweeps, serial, mode):
    res, _ = sweeps[mode]
    assert [(r["seed"], r["lr"]) for r in res] == [(s, lr) for lr in LRS for s in SEEDS]
    for r in res:
        assert "diverged" not in r
        _assert_same_run(r, serial[(r["seed"], r["lr"])][0], f"{mode} {r['seed']} {r['lr']}")
    # the replicas are distinct experiments; one stopped early, then stepped on locked
    assert len({r["history"][0]["train_loss"] for r in res}) == len(res)
    assert sorted(len(r["history"]) for r in res) == [3, 4, 4, 4]


def test_best_dir_holds_each_replicas_best_weights(sweeps, serial):
    res, exp = sweeps["resident"]
    best = load_weights(os.path.join(exp, "best"))
    with open(os.path.join(exp, "best", "replicas.json")) as f:
        meta = json.load(f)
    grid = [(s, lr) for lr in LRS for s in SEEDS]
    assert meta == {"seeds": [s for s, _ in grid], "lrs": [lr for _, lr in grid],
                    "best_iter": [r["best_iter"] for r in res]}
    assert os.path.exists(os.path.join(exp, "config.json"))
    for i, key in enumerate(grid):
        want = load_weights(os.path.join(serial[key][1], "best"))
        assert want["step"] == res[i]["best_iter"]
        for part in ("model", "fusion"):
            assert best[part][i].keys() == want[part].keys()
            for name, v in want[part].items():
                assert torch.equal(best[part][i][name], v), (key, part, name)


def test_resume_equals_uninterrupted(root, sweeps, tmp_path):
    full, _ = sweeps["resident"]
    exp = str(tmp_path / "resumed")
    train_seed_sweep(_cfg(root, epoch=1), seeds=SEEDS, lrs=LRS, checkpoint_dir=exp,
                     device="cpu")
    resumed = train_seed_sweep(_cfg(root, load="resumed"), seeds=SEEDS, lrs=LRS,
                               checkpoint_dir=exp, device="cpu")
    for rr, rf in zip(resumed, full):
        _assert_same_run(rr, rf, f"resumed {rr['seed']} {rr['lr']}")
        assert [h["epoch"] for h in rr["history"]] == list(range(len(rf["history"])))


@pytest.mark.parametrize("seeds,lrs", [([1, 2, 3], LRS), (SEEDS, [1e-3, 3e-3])])
def test_a_mismatched_grid_on_load_raises(root, tmp_path, seeds, lrs):
    exp = str(tmp_path / "grid")
    train_seed_sweep(_cfg(root, epoch=1), seeds=SEEDS, lrs=LRS, checkpoint_dir=exp,
                     device="cpu")
    with pytest.raises(RuntimeError, match="does not match the current replica grid"):
        train_seed_sweep(_cfg(root, load="grid"), seeds=seeds, lrs=lrs, checkpoint_dir=exp,
                         device="cpu")


def test_no_test_split_reports_the_best_epochs_val(root):
    cfg = _cfg(root, dropout=0.0, epoch=4, patience=4)
    data_obj = parse_datasets(cfg, verbose=False)
    data_obj["test_dataloader"] = None
    for r in train_seed_sweep(cfg, seeds=SEEDS, data_obj=data_obj, device="cpu"):
        vals = [h["val"]["mse"] for h in r["history"]]
        assert r["mse"] == min(vals) == r["history"][r["best_iter"]]["val"]["mse"]


def test_a_diverged_replica_is_frozen_and_all_diverged_raises(root):
    cfg = _cfg(root, dropout=0.0, epoch=3)
    res = train_seed_sweep(cfg, seeds=[1], lrs=[1e-3, float("inf")], device="cpu")
    ok, bad = res
    assert "diverged" not in ok and bad["diverged"] is True
    # NaN in its first epoch, before any improvement: NaN metrics, no history
    assert bad["best_iter"] == -1 and np.isnan(bad["mse"]) and bad["history"] == []
    # the frozen replica leaves the other as it trains alone
    alone, = train_seed_sweep(cfg, seeds=[1], lrs=[1e-3], device="cpu")
    _assert_same_run(ok, alone, "beside a diverged replica")
    with pytest.raises(FloatingPointError, match="all replicas diverged"):
        train_seed_sweep(cfg, seeds=SEEDS, lrs=[float("inf")], device="cpu")


def test_main_prints_a_line_per_replica(root, tmp_path, capsys):
    argv = ["--dataset", "EPA-Air", "--data_root", root, "--model", "DLinear",
            "--batch_size", "8", "--epoch", "1", "--seed", "0", "--device", "cpu", "--save",
            str(tmp_path), "--vmap_seeds", "2", "--vmap_lrs", "1e-3", "1e-2"]
    res = train_main.main(argv)
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [(x["seed"], x["lr"]) for x in lines] == [(0, 1e-3), (1, 1e-3), (0, 1e-2),
                                                      (1, 1e-2)]
    assert len(res) == 4 and all(np.isfinite(x["mse"]) for x in lines)


# ------------------------------------------------------------ against JAX
JAX_KW = dict(KW, dropout=0.0, device_loop=False, epoch=3, patience=3)


@pytest.fixture(scope="module")
def jax_sweep(root):
    """(each replica's JAX init as the port's state, the JAX sweep's results)."""
    cfg = JConfig(data_root=root, **JAX_KW)
    data = j_parse_datasets(cfg, verbose=False)
    jcfg = data["cfg"]
    sample = next(iter(data["train_dataloader"]))
    inits = []
    for lr in LRS:
        for s in SEEDS:
            rng = jax.random.key(s, impl="threefry2x32")
            _, init_rng = jax.random.split(rng)
            params, stats = jtrainer.init_state(jcfg, j_get_model(jcfg), JFusionModel(jcfg),
                                                sample, init_rng)
            inits.append(params_from_jax(np_tree(params), np_tree(stats)))
    return inits, j_train_seed_sweep(cfg, seeds=SEEDS, lrs=LRS)


def test_sweep_from_the_jax_inits_matches_jax_train_seed_sweep(root, jax_sweep):
    inits, want = jax_sweep
    got = train_seed_sweep(Config(data_root=root, **dict(JAX_KW, device_loop=True)),
                           seeds=SEEDS, lrs=LRS, device="cpu", initial_states=inits)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        what = f"{g['seed']} {g['lr']}"
        assert (g["seed"], g["lr"]) == (w["seed"], w["lr"])
        assert g["best_iter"] == w["best_iter"], what
        assert g.get("diverged", False) == w.get("diverged", False), what
        assert len(g["history"]) == len(w["history"]) == JAX_KW["epoch"], what
        np.testing.assert_allclose([h["train_loss"] for h in g["history"]],
                                   [h["train_loss"] for h in w["history"]], rtol=1e-5,
                                   err_msg=what)
        for hg, hw in zip(g["history"], w["history"]):
            for k in ("mse", "mae", "rmse"):
                np.testing.assert_allclose(hg["val"][k], hw["val"][k], rtol=1e-4,
                                           err_msg=f"{what} val {k}")
        for k in ("loss", "mse", "mae", "rmse"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"{what} test {k}")
