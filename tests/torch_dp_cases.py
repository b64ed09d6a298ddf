"""The cases that tests/test_torch_parallel.py runs on each rank of one
data-parallel world (parallel/multiproc.World over gloo on the CPU). It
imports the port only: the ranks are spawned processes, which import this
module by name and never JAX."""

import os

import numpy as np
import torch


def summary(res: dict) -> dict:
    """What a trainable() result is compared by: per-step and per-epoch
    losses, best_iter and the best epoch's test metrics."""
    return dict(step_losses=[x for h in res["history"] for x in h["step_losses"]],
                train_losses=[h["train_loss"] for h in res["history"]],
                best_iter=res["best_iter"],
                **{k: res[k] for k in ("loss", "mse", "mae", "rmse", "mape")})


def pinned_salts(salts):
    """Make the port's draw_salts cycle `salts` (as torch_port_parity.
    pinned_salts does for both packages); returns the undo."""
    import itertools

    from imm_tsf_torch.layers import fast_dropout

    saved, cycle = fast_dropout.draw_salts, itertools.cycle(salts)
    fast_dropout.draw_salts = lambda generator=None: next(cycle)
    return lambda: setattr(fast_dropout, "draw_salts", saved)


def flagship(device, salts, initial_state, n_steps):
    """The flagship DP steps (parallel/multiproc) under pinned salts."""
    import torch.distributed as dist

    from imm_tsf_torch.parallel import multiproc

    undo = pinned_salts(salts)
    try:
        cfg, batch = multiproc.flagship_case(dist.get_world_size())
        return multiproc.run_dp_steps(cfg, batch, device, n_steps, initial_state)
    finally:
        undo()


def padded_batch(world: int):
    """The flagship batch as the padded last batch of a split: the last
    3 of its 8 rows are all-zero pad rows and row 4 keeps one observation,
    so the second rank of two holds far fewer mask counts than the first."""
    from imm_tsf_torch.parallel import multiproc

    cfg, batch = multiproc.flagship_case(world)
    batch = {k: v.copy() for k, v in batch.items()}
    for k, v in batch.items():
        if v.ndim >= 2:
            v[5:] = 0
    batch["mask_predicted_data"][4] = 0
    batch["mask_predicted_data"][4, 0, 0] = 1
    batch["data_to_predict"] *= batch["mask_predicted_data"]
    return cfg, batch


def eval_losses(cfg, batch, device, mesh):
    """The eval-mode loss of the run's fresh modules on `batch` (the rank's
    rows under a mesh): (the global loss, this rank's own masked mean)."""
    from imm_tsf_torch.training.evaluation import masked_mse_loss
    from imm_tsf_torch.training.trainer import build_run, make_forward, to_device

    model, fusion, _, _, _ = build_run(cfg, batch, device, None, mesh)
    for m in (model, fusion):
        m.eval()
    dev = to_device(batch, device, mesh)
    with torch.no_grad():
        pred = make_forward(cfg, model, fusion)(dev)
        args = (pred, dev["data_to_predict"], dev["mask_predicted_data"])
        share = masked_mse_loss(*args, mesh)
        if mesh is not None:
            mesh.all_reduce_(share)
        return float(share), float(masked_mse_loss(*args))


def padded_step(device):
    """On the padded batch: two DP train steps, the eval-mode global loss
    and this rank's own masked mean (what a mean of rank means averages)."""
    import torch.distributed as dist

    from imm_tsf_torch.parallel import multiproc
    from imm_tsf_torch.parallel.mesh import make_mesh

    cfg, batch = padded_batch(dist.get_world_size())
    mesh = make_mesh(cfg.mesh_shape, device)
    shared, local = eval_losses(cfg, batch, device, mesh)
    counts = float(batch["mask_predicted_data"][mesh.rows(cfg.batch_size)].sum())
    return dict(losses=multiproc.run_dp_steps(cfg, batch, device, 2), shared=shared,
                local=local, counts=counts)


def train(device, cfg_kw, initial_state=None, checkpoint_dir=None):
    from imm_tsf_torch.config import Config
    from imm_tsf_torch.training.trainer import trainable

    return summary(trainable(Config(**cfg_kw), device=device, initial_state=initial_state,
                             checkpoint_dir=checkpoint_dir))


def cli(device, argv, experiment_id):
    """What `python -m imm_tsf_torch.main <argv>` runs on each rank of a
    data mesh (main._rank_main): rank 0's summary, None elsewhere."""
    from imm_tsf_torch import main

    out = main._rank_main(device, argv, experiment_id, False)
    return None if out is None else summary(out[0])


def keep_masks(device, shape, salts, keep_prob):
    """This rank's block of a hash-dropout mask and of a training-mode
    Dropout's output and gradient, through the rank's data mesh."""
    import torch.distributed as dist

    from imm_tsf_torch.layers.fast_dropout import Dropout
    from imm_tsf_torch.parallel.mesh import make_mesh

    mesh = make_mesh((dist.get_world_size(),), device)
    undo = pinned_salts([salts])
    try:
        layer = Dropout(1.0 - keep_prob).train()
        layer.data_mesh = mesh
        rows = mesh.rows(shape[0])
        x = torch.arange(float(np.prod(shape))).reshape(shape)[rows].requires_grad_()
        out = layer(x)
        (g,) = torch.autograd.grad(out, x, torch.ones_like(out))
        return dict(out=out.detach().numpy(), grad=g.numpy())
    finally:
        undo()


def sweep(device, cfg_kw, seeds=None, lrs=None, checkpoint_dir=None):
    """train_seed_sweep over this rank's data mesh: each replica's summary
    (with its seed and lr), in grid order, on every rank."""
    from imm_tsf_torch.config import Config
    from imm_tsf_torch.training.vmap_sweep import train_seed_sweep

    res = train_seed_sweep(Config(**cfg_kw), seeds=seeds, lrs=lrs, device=device,
                           checkpoint_dir=checkpoint_dir)
    return [dict(summary(r), seed=r["seed"], lr=r.get("lr"), held=r["model"] is not None)
            for r in res]


CASES = dict(flagship=flagship, padded_step=padded_step, train=train, cli=cli,
             keep_masks=keep_masks, sweep=sweep)


def run(device, cases):
    """Each (name, kind, kwargs) of `cases` on this rank, in order: a
    World's fn. -> {name: result}."""
    import time

    torch.manual_seed(0)
    out, seconds = {}, {}
    for name, kind, kw in cases:
        t0 = time.perf_counter()
        out[name] = CASES[kind](device, **kw)
        seconds[name] = time.perf_counter() - t0
    out["pid"], out["seconds"] = os.getpid(), seconds
    return out
