"""Data-parallel ranks as OS processes (after imm_tsf_tpu/parallel/multiproc.py).

The JAX package joins processes through jax.distributed's coordination
service with gloo collectives on the CPU. The port starts one process a
rank with torch.multiprocessing (spawn) and joins them in a
torch.distributed group on a localhost TCP store: gloo on the CPU, NCCL
on cuda, or gloo with CUDA tensors when the ranks share one card. Every
rank runs the same function; its return values come back to the caller,
by rank.

    results = launch(fn, world=2, device="cpu", args=(...,))

runs fn(device, *args) on each rank (device: the rank's own,
parallel/mesh.rank_device) inside the initialised group. A rank that
raises ends the world: the others are terminated and the caller gets
the rank's traceback. `World(...).start()` returns at once, so the
caller can work while the ranks run, and `.join()` collects.

The flagship DP step (`flagship_case`, `run_dp_steps`, `worker_main`,
`launch_multiprocess_dp`) is the JAX module's: DLinear + TTF_RecAvg +
MMF_GR_Add on the synthetic batch of the JAX package's root bench.py
(`build_batch`, the same numpy draws), a few train steps over the data
mesh.

    python -m imm_tsf_torch.parallel.multiproc [--world 2] [--steps 2] [--device cpu]

prints each rank's losses, which are equal (the loss is all-reduced).
"""

from __future__ import annotations

import argparse
import json
import queue as queue_mod
import sys
import time
import traceback

import numpy as np
import torch

from .mesh import free_port, init_distributed, rank_device


def _entry(fn, rank: int, world: int, port: int, device, gpu: int, share_card: bool, threads,
           results, args) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        import torch.distributed as dist

        dev = rank_device(device, rank, gpu, share_card, world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        init_distributed(world, rank, port, "gloo" if share_card else None, dev)
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 -- reported to the caller
        results.put((rank, False, traceback.format_exc()))


class World:
    """`world` ranks running fn(device, *args) in one process group."""

    def __init__(self, fn, world: int, args=(), device="cpu", gpu: int = 0,
                 share_card: bool = False, threads: int | None = None, timeout: float = 1800.0):
        self.fn, self.world, self.args = fn, int(world), tuple(args)
        self.device, self.gpu, self.share_card = device, gpu, share_card
        self.threads, self.timeout = threads, timeout
        self.procs: list = []

    def start(self) -> "World":
        ctx = torch.multiprocessing.get_context("spawn")
        self.results = ctx.Queue()
        port = free_port()
        self.procs = [ctx.Process(target=_entry, daemon=False, args=(
            self.fn, r, self.world, port, self.device, self.gpu, self.share_card, self.threads,
            self.results, self.args)) for r in range(self.world)]
        for p in self.procs:
            p.start()
        return self

    def _stop(self) -> None:
        for p in self.procs:
            if p.is_alive():
                p.terminate()
        for p in self.procs:
            p.join(10)

    def join(self) -> list:
        """Each rank's return value, by rank; raises RuntimeError with the
        traceback of a rank that failed (the others are stopped)."""
        out: dict = {}
        deadline = time.monotonic() + self.timeout
        try:
            while len(out) < self.world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"data-parallel world of {self.world}: timed out")
                try:
                    rank, ok, value = self.results.get(timeout=min(left, 5.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(self.procs)
                            if p.exitcode not in (None, 0) and r not in out]
                    if dead:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{self.procs[dead[0]].exitcode}") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of a data-parallel world of "
                                       f"{self.world} failed:\n{value}")
                out[rank] = value
            for p in self.procs:
                p.join(60)
        finally:
            self._stop()
        return [out[r] for r in range(self.world)]


def launch(fn, world: int, args=(), **kw) -> list:
    """World(fn, world, args, **kw) started and joined."""
    return World(fn, world, args, **kw).start().join()


def build_batch(B=64, L=48, Lp=24, C=8, N=8, d_txt=768, seed=0) -> dict:
    """The synthetic model batch of the JAX package's root bench.py
    (`build_batch`), the same numpy draws in the same order."""
    rng = np.random.default_rng(seed)
    mask = (rng.random((B, L, C)) > 0.3).astype(np.float32)
    pmask = (rng.random((B, Lp, C)) > 0.3).astype(np.float32)
    pmask[:, 0, 0] = 1.0
    return {
        "observed_tp": np.sort(rng.random((B, L)).astype(np.float32) * 0.5, axis=1),
        "observed_data": (rng.standard_normal((B, L, C)) * mask).astype(np.float32),
        "observed_mask": mask,
        "tp_to_predict": np.sort(0.5 + rng.random((B, Lp)).astype(np.float32) * 0.5, axis=1),
        "data_to_predict": (rng.standard_normal((B, Lp, C)) * pmask).astype(np.float32),
        "mask_predicted_data": pmask,
        "tau": np.sort(rng.random((B, N)).astype(np.float32) * 0.5, axis=1),
        "notes_mask": np.ones((B, N), np.float32),
        "notes_embeddings": rng.standard_normal((B, N, d_txt)).astype(np.float32),
    }


def flagship_case(n_global: int):
    """(cfg, numpy batch) of the flagship DLinear + fusion DP step, the JAX
    module's (:30-45): the same config fields and the same batch."""
    from ..config import Config

    B = max(n_global * 2, 8)
    cfg = Config(
        model="DLinear", enable_text=True, use_text_embeddings=True,
        llm_model_fusion="GPT2", TTF_module="TTF_RecAvg",
        MMF_module="MMF_GR_Add", d_txt=32, input_dim=4, input_len=24,
        pred_len=12, batch_size=B, mesh_shape=(n_global,),
    )
    return cfg, build_batch(B=B, L=24, Lp=12, C=4, N=4, d_txt=32, seed=0)


def run_dp_steps(cfg, batch, device, n_steps: int = 2, initial_state=None) -> list[float]:
    """The flagship run's modules (from `initial_state`, else the port's
    init under cfg.seed) and `n_steps` train steps over cfg.mesh_shape's
    data mesh on this rank; returns the per-step losses of the global
    batch (the same on every rank). Without a mesh it is the
    single-process run."""
    from ..training.trainer import (build_run, make_forward, make_grad_step, make_loss_fn,
                                    to_device)
    from .mesh import make_mesh

    mesh = make_mesh(cfg.mesh_shape, device)
    model, fusion, _, params, optimizer = build_run(cfg, batch, device, initial_state, mesh)
    grad_step = make_grad_step(make_loss_fn(make_forward(cfg, model, fusion), mesh), optimizer,
                               params, 1.0, mesh=mesh)
    dev = to_device(batch, device, mesh)
    return [float(grad_step(dev)) for _ in range(n_steps)]


def worker_main(device, n_steps: int = 2, initial_state=None) -> list[float]:
    """One rank of the flagship DP run (a World's fn)."""
    import torch.distributed as dist

    cfg, batch = flagship_case(dist.get_world_size())
    losses = run_dp_steps(cfg, batch, device, n_steps, initial_state)
    if not all(np.isfinite(x) for x in losses):
        raise FloatingPointError(f"non-finite flagship losses {losses}")
    return losses


def launch_multiprocess_dp(num_processes: int = 2, n_steps: int = 2, device="cpu",
                           initial_state=None, **kw) -> dict:
    """{rank: per-step losses} of the flagship DP run over num_processes
    ranks (kw: World's share_card, threads, timeout)."""
    out = launch(worker_main, num_processes, (n_steps, initial_state), device=device, **kw)
    return dict(enumerate(out))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("imm_tsf_torch.parallel.multiproc")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--share_card", action="store_true")
    args = ap.parse_args(argv)
    res = launch_multiprocess_dp(args.world, args.steps, args.device, share_card=args.share_card)
    print(json.dumps({str(r): v for r, v in res.items()}), flush=True)
    return 0 if all(v == res[0] for v in res.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
