"""Data-parallel dryrun (after imm_tsf_tpu/parallel/dryrun.py): the full
training step over a data mesh of N ranks, one step on tiny shapes, for
the framework's distinct compute paths, then the device-resident epoch
loop and the production trainable() over the mesh:

  1. DLinear + TTF_RecAvg + MMF_GR_Add  - fusion stack, standard collate
  2. CRU                                 - the Kalman recursion with
                                           batched Van Loan expm
  3. tPatchGNN                           - 4-D patched inputs, adaptive
                                           adjacency einsums
  4. the resident epoch loop             - each rank gathers its rows of
                                           every batch from the replicated
                                           windows, the pad row included
  5. the Llama note embedding over a     - each rank drives its own LLM
     ("data", "model") mesh                  mesh: 2 data groups x 4
                                           model shards of its device
  6. trainable() for 2 epochs            - the data pipeline, fusion, eval
                                           and early stopping under DP,
                                           against the run without a mesh

Each step's loss is the global batch's, so every rank reports the same
value; the step is also run without a mesh on the whole batch, and the
two must agree (rtol 1e-5). The Llama case holds the sharded embedding
to the unsharded one (rtol 2e-5, atol 2e-6) and its gate projection to
I / tp rows a shard, as the JAX module's case does.

    python -m imm_tsf_torch.parallel.dryrun --device cpu --world 2
    python -m imm_tsf_torch.parallel.dryrun --world 2            # N cards, NCCL
    python -m imm_tsf_torch.parallel.dryrun --world 2 --share_card   # one card, gloo
"""

from __future__ import annotations

import argparse
import shutil
import sys
import tempfile

import numpy as np
import torch

from .multiproc import build_batch, launch


def _flagship(n: int):
    """DLinear + fusion over the data mesh (standard collate shapes)."""
    from .multiproc import flagship_case

    return flagship_case(n)


def _cru(n: int):
    """CRU: the Kalman scan with its per-step batched expm."""
    from ..config import Config

    B = max(n * 2, 8)
    cfg = Config(model="CRU", input_dim=3, input_len=12, pred_len=6, batch_size=B,
                 cru_lsd=8, cru_hidden_units=16, mesh_shape=(n,))
    return cfg, build_batch(B=B, L=12, Lp=6, C=3, N=2, d_txt=8, seed=1)


def _tpatchgnn(n: int):
    """tPatchGNN: 4-D patched inputs [B, M, L, N] split on the batch."""
    from ..config import MODEL_PRESETS, Config

    B = max(n * 2, 8)
    M, L, N, Lp = 4, 6, 3, 6
    cfg = Config(model="tPatchGNN", input_dim=N, input_len=L, pred_len=Lp, batch_size=B,
                 npatch=M, mesh_shape=(n,))
    cfg = cfg.replace(**MODEL_PRESETS["tPatchGNN"]).replace(hid_dim=16)
    rng = np.random.default_rng(0)
    mask = np.zeros((B, M, L, N), np.float32)
    lens = rng.integers(1, L + 1, size=(B, M, N))
    for b in range(B):
        for m in range(M):
            for c in range(N):
                mask[b, m, : lens[b, m, c], c] = 1.0
    tp = np.sort(rng.random((B, M, L, N)).astype(np.float32) * 0.5, axis=2) * mask
    data = rng.standard_normal((B, M, L, N)).astype(np.float32) * mask
    t_hat = np.sort(0.5 + rng.random((B, Lp)).astype(np.float32) * 0.5, axis=1)
    pmask = (rng.random((B, Lp, N)) > 0.3).astype(np.float32)
    pmask[:, 0, 0] = 1.0
    batch = {
        "observed_data": data, "observed_tp": tp, "observed_mask": mask,
        "tp_to_predict": t_hat,
        "data_to_predict": (rng.standard_normal((B, Lp, N)) * pmask).astype(np.float32),
        "mask_predicted_data": pmask,
    }
    return cfg, batch


def _step_and_eval(cfg, batch, device):
    """One train step and one eval batch of `cfg` over its mesh (or none):
    (loss, the finalized eval metrics)."""
    from ..training.evaluation import batch_error_sums, finalize_metrics
    from ..training.trainer import (build_run, make_forward, make_grad_step, make_loss_fn,
                                    to_device)
    from .mesh import make_mesh

    mesh = make_mesh(cfg.mesh_shape, device)
    model, fusion, _, params, optimizer = build_run(cfg, batch, device, None, mesh)
    forward = make_forward(cfg, model, fusion)
    dev = to_device(batch, device, mesh)
    loss = float(make_grad_step(make_loss_fn(forward, mesh), optimizer, params, 1.0,
                                mesh=mesh)(dev))
    for m in (model, fusion):
        if m is not None:
            m.eval()
    with torch.inference_mode():
        sums = batch_error_sums(forward(dev), dev["data_to_predict"], dev["mask_predicted_data"])
    acc = {k: v.double().cpu().numpy() for k, v in sums.items()}
    return loss, finalize_metrics(acc if mesh is None else mesh.all_reduce_sums(acc))


def _dryrun_one(cfg, batch, device, tag: str) -> float:
    import torch.distributed as dist

    loss, metrics = _step_and_eval(cfg, batch, device)
    if not np.isfinite(loss) or not all(np.isfinite(v) for v in metrics.values()):
        raise FloatingPointError(f"{tag}: dryrun loss or metrics not finite")
    want, want_metrics = _step_and_eval(cfg.replace(mesh_shape=()), batch, device)
    np.testing.assert_allclose(loss, want, rtol=1e-5, err_msg=f"{tag}: loss vs no mesh")
    np.testing.assert_allclose(metrics["mse"], want_metrics["mse"], rtol=1e-5,
                               err_msg=f"{tag}: eval mse vs no mesh")
    _say(f"  dryrun[{tag}]({dist.get_world_size()} ranks): loss={loss:.5f} == no mesh OK")
    return loss


def _device_epoch_dp(n: int, device) -> list:
    """The resident epoch loop (training/device_loop.py) over the data mesh:
    a 3-batch epoch of resident windows plus the all-zero pad row, each
    rank gathering its columns of the row table."""
    from ..training import device_loop as DL
    from ..training.graphs import StepLoop, eager_reason
    from ..training.trainer import build_run, make_forward, make_grad_step, make_loss_fn
    from .mesh import make_mesh

    cfg, batch = _flagship(n)
    mesh = make_mesh(cfg.mesh_shape, device)
    B = cfg.batch_size
    model, fusion, gens, params, optimizer = build_run(cfg, batch, device, None, mesh)
    forward = make_forward(cfg, model, fusion)
    loop = StepLoop(device, [gens["sample"], gens["z0"]], eager=eager_reason(cfg, mesh))
    grad_step = make_grad_step(make_loss_fn(forward, mesh), optimizer, params, 1.0, mesh=mesh)
    run_train, run_eval = DL.make_epoch_runners(forward, grad_step, loop)
    arrays = {k: np.concatenate([v, v, v, np.zeros_like(v[:1])]) for k, v in batch.items()}
    n_rows = 3 * B + 1
    bit = type("Split", (), dict(indices=list(range(3 * B)), batch_size=B, shuffle=False))()
    res = DL.Resident("train", (arrays, np.arange(3 * B)), bit, device, mesh)
    perm = np.arange(3 * B, dtype=np.int32).reshape(3, B)
    perm[-1, -1] = n_rows - 1  # the pad row
    losses, _ = run_train(res, perm)
    losses = losses.tolist()
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError("device-epoch dryrun: non-finite loss")
    metrics = mesh.all_reduce_sums(DL.reduce_eval_sums(run_eval(res)))
    if not all(np.isfinite(v).all() for v in metrics.values()):
        raise FloatingPointError("device-epoch dryrun: non-finite eval sums")
    _say(f"  dryrun[device-epoch-DP]({n} ranks): losses={np.round(losses, 4).tolist()} OK")
    return losses


def _llama_tensor_parallel(device) -> float:
    """The JAX module's tensor-sharded Llama note embedding through the
    production embed_notes over a ("data", "model") mesh of dp x tp
    copies of this rank's device (one process drives an LLM mesh; a rank
    of a data mesh drives its own): the gate projection genuinely split
    (I / tp rows a shard), the embedding within rtol 2e-5, atol 2e-6 of
    the unsharded one. -> the largest gap."""
    from ..llm.llama import LlamaConfig, LlamaModel
    from ..llm.loader import (HashTokenizer, _llama_init_, embed_notes, make_llm_mesh,
                              shard_llm_params)

    tp, dp = 4, 2
    cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4)
    with torch.device("meta"):
        model = LlamaModel(cfg)
    model = model.to_empty(device=device)
    _llama_init_(model, torch.Generator(device).manual_seed(0))
    model.eval().requires_grad_(False)
    mesh = make_llm_mesh(tp, devices=[device] * (dp * tp))
    shards = shard_llm_params(model, mesh)[0].layers[0][2]
    widths = [s["gate_proj"].shape[0] for s in shards]
    if widths != [cfg.intermediate_size // tp] * tp:
        raise AssertionError(f"the gate projection's shards hold {widths} rows")
    notes = [["alpha beta", "gamma"], [], ["delta epsilon zeta eta"]]
    emb, mask = embed_notes(notes, model, HashTokenizer(256), max_length=32, mesh=mesh)
    ref, _ = embed_notes(notes, model, HashTokenizer(256), max_length=32)
    if not (np.isfinite(emb).all() and mask.sum() == 3):
        raise AssertionError("the sharded embedding is not finite, or its mask is wrong")
    np.testing.assert_allclose(emb, ref, rtol=2e-5, atol=2e-6)
    _say(f"  dryrun[Llama-TP-embed]({dp}x{tp} mesh of {device}): emb={emb.shape}, gate rows "
         f"{widths} OK")
    return float(np.abs(emb - ref).max())


def _trainable_e2e(n: int, device) -> float:
    """The production trainable() for 2 epochs over the mesh, against the
    same run without a mesh: best_iter equal, test mse to rtol 2e-4."""
    import torch.distributed as dist

    from ..config import Config
    from ..data.synthetic import make_synthetic_dataset
    from ..training.trainer import trainable

    box = [tempfile.mkdtemp(prefix="dryrun_") if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    root = box[0]
    if dist.get_rank() == 0:
        make_synthetic_dataset(f"{root}/EPA-Air", n_entities=4, n_features=2, n_days=120,
                               seed=0)
    dist.barrier()
    base = dict(dataset="EPA-Air", data_root=root, model="DLinear", batch_size=8, epoch=2,
                patience=2, seed=1, host_prefetch=0)
    try:
        res = trainable(Config(**base, mesh_shape=(n,)), device=device)
        ref = trainable(Config(**base, mesh_shape=()), device=device)
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(root, ignore_errors=True)
    if res["best_iter"] != ref["best_iter"]:
        raise AssertionError(f"best_iter {res['best_iter']} vs {ref['best_iter']} without mesh")
    np.testing.assert_allclose(res["mse"], ref["mse"], rtol=2e-4)
    _say(f"  dryrun[trainable-e2e]({n} ranks): 2 epochs, mse={res['mse']:.5f} == no mesh OK")
    return res["mse"]


def _say(line: str) -> None:
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(line, flush=True)


def run_rank(device) -> dict:
    """Every case on this rank (a World's fn); the losses by case."""
    import torch.distributed as dist

    n = dist.get_world_size()
    out = {}
    for build in (_flagship, _cru, _tpatchgnn):
        cfg, batch = build(n)
        out[cfg.model] = _dryrun_one(cfg, batch, device, cfg.model)
    out["device-epoch"] = _device_epoch_dp(n, device)
    out["Llama-TP-embed"] = _llama_tensor_parallel(device)
    out["trainable-e2e"] = _trainable_e2e(n, device)
    _say(f"dryrun({n} ranks): OK")
    return out


def run(world: int, device="cuda", **kw) -> list:
    """The dryrun over `world` ranks; each rank's losses by case (equal)."""
    out = launch(run_rank, world, device=device, **kw)
    if any(o != out[0] for o in out[1:]):
        raise AssertionError(f"the ranks disagree: {out}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("imm_tsf_torch.parallel.dryrun")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--share_card", action="store_true")
    args = ap.parse_args(argv)
    threads = max(1, torch.get_num_threads() // args.world) if args.device == "cpu" else None
    run(args.world, args.device, share_card=args.share_card, threads=threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
