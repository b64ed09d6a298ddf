"""The data axis: ranks over torch.distributed (after imm_tsf_tpu/parallel/mesh.py).

The JAX package scales by batch-dim data parallelism over a one-axis
`jax.sharding.Mesh` ("data"): parameters replicated, each batch split on
axis 0, the gradient all-reduce inserted by the partitioner. Under pjit
that mesh is ONE program over the GLOBAL batch, so a sharded run equals
the single-device run on the same batch (tests/test_sharding.py). The port
keeps that contract with N OS processes (ranks), one card each over NCCL,
or the CPU over gloo:

- every rank runs the same loader with the same shuffle stream, collates
  the global batch and keeps its own rows (`shard_batch`: arrays of rank
  >= 2 split on axis 0, 1-D shared time axes whole, other values dropped);
- the training loss is the global two-stage masked mean: each rank divides
  its error sums by the all-reduced counts (training/evaluation.py), and
  one all-reduce of a flat buffer sums the ranks' gradients after the
  backward (`DataMesh.sum_gradients`), so the clip and Adam see the global
  gradient on every rank; the eval sums are all-reduced too;
- what couples the rows of a batch is made global where the modules hold
  a `data_mesh` (set by the trainer): BatchNorm's train statistics
  (layers/transformer.py), TimesNet's period choice (models/timesnet.py),
  the hash-dropout masks' flat index (each rank starts at its first global
  element, `offset`; kernel #2 at its first global row), the per-sample
  z0 noise (drawn at the global shape, the rank's rows kept, `local_draw`).
  Draws shared by the whole batch (the salts, ProbSparse's train sample)
  come from generators seeded alike on every rank.

At world size 1 those couplings take the single-process code, and the
trainer's collectives (counts, gradients, eval sums) sum over one rank:
such a run equals the run without a mesh bit for bit.

`launch` (parallel/multiproc.py) and `python -m imm_tsf_torch.main
--mesh_shape N` start the ranks; under torchrun (RANK and WORLD_SIZE set)
`init_distributed` reads the environment. Rank r runs on cuda:(gpu +
local rank), or every rank on cuda:gpu when the caller asks to share one
card (`share_card`, over gloo). There is no CPU fallback.

The frozen LLM's ("data", "model") mesh (`LlmMesh`, built by llm/loader.
make_llm_mesh) is another thing: the JAX package builds it inside one
process over `jax.devices()` and shards the embedding forward over it, so
the port drives its grid of devices from one process too, with no
collective: each data group computes its rows, each model shard its part
of a Llama block (llm/llama.LlamaShards).
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist

ROADMAP_DP = "ROADMAP.md, Queue 1, item 16"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(world: int, rank: int, port: int | None = None,
                     backend: str | None = None, device="cuda") -> None:
    """torch.distributed.init_process_group over a localhost TCP store (the
    JAX package's jax.distributed.initialize): NCCL on cuda, gloo on the
    CPU unless `backend` says otherwise. A no-op when the group exists.
    `port` None reads MASTER_PORT (torchrun)."""
    if dist.is_initialized():
        return
    if port is None:
        port = int(os.environ["MASTER_PORT"])
    addr = os.environ.get("MASTER_ADDR", "localhost")
    dist.init_process_group(backend or default_backend(device),
                            init_method=f"tcp://{addr}:{port}", world_size=world, rank=rank)


def rank_device(device, local_rank: int, gpu: int = 0, share_card: bool = False,
                world: int = 1) -> torch.device:
    """The device of a rank: the CPU, or cuda:(gpu + local_rank), or
    cuda:gpu for every rank under `share_card`. More cuda ranks than cards
    are refused unless the caller shares one card explicitly."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run on the CPU")
    first = dev.index if dev.index is not None else gpu
    if share_card:
        return torch.device("cuda", first)
    n = torch.cuda.device_count()
    if first + world > n:
        raise ValueError(
            f"mesh_shape ({world},) needs {world} cards from cuda:{first}, this process "
            f"sees {n}: ask to share one card (share_card, over gloo) or run fewer ranks "
            f"({ROADMAP_DP})")
    return torch.device("cuda", first + local_rank)


def check_mesh_shape(mesh_shape) -> int:
    """The data axis's size of `mesh_shape`; a second axis of size > 1 (a
    ("data", "model") training mesh, which the JAX package replicates over
    "model") is refused. The frozen LLM's mesh is LlmMesh, from llm_tp."""
    shape = tuple(int(n) for n in mesh_shape)
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh_shape {shape}: every axis needs at least one device")
    if any(n > 1 for n in shape[1:]):
        raise NotImplementedError(
            f"mesh_shape {shape}: only the data axis of a training mesh is ported; its "
            f"replicated 'model' axis is not ({ROADMAP_DP}, the TP half; the frozen LLM's "
            f"mesh is llm_tp)")
    return shape[0] if shape else 1


class DataMesh:
    """The data axis of `world` ranks (the default process group), seen
    from `rank`, whose tensors live on `device`. Without a process group
    (`DataMesh(2, r, "cpu")` in a test) every collective is the identity."""

    def __init__(self, world: int, rank: int, device):
        self.world, self.rank = int(world), int(rank)
        self.device = torch.device(device)

    def __repr__(self):
        return f"DataMesh(world={self.world}, rank={self.rank}, device={self.device})"

    @property
    def couples(self) -> bool:
        """Whether the batch-coupling layers take their global forms (world
        > 1); at world 1 they run the single-process code."""
        return self.world > 1

    def rows(self, n: int) -> slice:
        """The rank's rows of a global batch of n."""
        if n % self.world:
            raise ValueError(f"a global batch of {n} does not split over {self.world} ranks "
                             f"({ROADMAP_DP})")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def offset(self, local_numel: int) -> int:
        """The first global flat index of the rank's block of a tensor whose
        outermost axis is the batch: rank x its local element count."""
        return self.rank * int(local_numel)

    def _live(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def backend(self) -> str | None:
        """The process group's backend ("nccl", "gloo"), None without one."""
        return dist.get_backend() if self._live() else None

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks in place (no gradient)."""
        if self._live():
            dist.all_reduce(t)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, differentiable: its backward sums
        the ranks' gradients (torch.distributed.nn)."""
        if not self._live():
            return t
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(t)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        if self._live():
            dist.broadcast(t, src)
        return t

    def barrier(self) -> None:
        if self._live():
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index or 0])
            else:
                dist.barrier()

    def sum_gradients(self, params, loss: torch.Tensor) -> torch.Tensor:
        """One all-reduce of a flat buffer holding every gradient of
        `params` (in their order; those without one skipped, the same on
        every rank) and the loss: the gradients are summed in place and
        the summed loss is returned. One collective a step, in the same
        order every step, so a captured step holds it."""
        grads = [p.grad for p in params if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        self.all_reduce_(flat)
        start = 0
        for g in grads:
            g.copy_(flat[start:start + g.numel()].view_as(g))
            start += g.numel()
        return flat[-1]

    def broadcast_module_(self, *modules) -> None:
        """Every parameter and buffer of `modules` from rank 0."""
        with torch.no_grad():
            for m in modules:
                if m is None:
                    continue
                for t in list(m.parameters()) + list(m.buffers()):
                    self.broadcast_(t.data)

    def all_reduce_sums(self, acc: dict) -> dict:
        """The float64 eval sums {name: array} summed over the ranks, in one
        all-reduce on the mesh's device."""
        keys = sorted(acc)
        sizes = [np.asarray(acc[k]).size for k in keys]
        flat = torch.from_numpy(np.concatenate([np.asarray(acc[k], np.float64).reshape(-1)
                                                for k in keys])).to(self.device)
        self.all_reduce_(flat)
        flat = flat.cpu().numpy()
        out, start = {}, 0
        for k, n in zip(keys, sizes):
            out[k] = flat[start:start + n].reshape(np.shape(acc[k]))
            start += n
        return out

    def local_draw(self, draw, shape) -> torch.Tensor:
        """draw(global_shape) at the global batch (axis 0 times the world),
        the rank's rows kept: a per-sample draw equals the single-process
        one's rows."""
        shape = tuple(shape)
        out = draw((shape[0] * self.world,) + shape[1:])
        return out[self.rank * shape[0]:(self.rank + 1) * shape[0]]


class LlmMesh:
    """The frozen LLM's ("data", "model") mesh over `devices`, driven by
    one process: `shape` {"data": dp, "model": tp} and `grid`, dp data
    groups of tp devices each (group g holds devices g·tp .. g·tp + tp - 1).
    A device may appear more than once (copies of the CPU in the tests,
    one card standing in for several)."""

    def __init__(self, devices, tp: int):
        devices = [torch.device(d) for d in devices]
        if tp < 1 or len(devices) % tp:
            raise ValueError(f"tp={tp} must divide the device count {len(devices)}")
        dp = len(devices) // tp
        self.grid = [devices[g * tp:(g + 1) * tp] for g in range(dp)]
        self.shape = {"data": dp, "model": tp}

    def __repr__(self):
        return f"LlmMesh({self.shape}, {self.grid})"


def make_mesh(mesh_shape=(), device="cpu") -> DataMesh | None:
    """mesh_shape () -> None (one device, no collectives); (N,) or (N, 1)
    -> the data axis of N ranks on `device`. It needs a process group of N
    ranks (init_distributed); at N = 1 without one it initialises a group
    of one rank on a free localhost port (NCCL on cuda), so that the run
    goes through the same collectives."""
    if not mesh_shape:
        return None
    n = check_mesh_shape(mesh_shape)
    device = torch.device(device)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(
                f"mesh_shape ({n},) needs {n} ranks: start them with `python -m "
                f"imm_tsf_torch.main --mesh_shape {n} ...` or parallel.multiproc.launch")
        init_distributed(1, 0, free_port(), device=device)
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh_shape ({n},) in a process group of "
                           f"{dist.get_world_size()} ranks")
    return DataMesh(n, dist.get_rank(), device)


def shard_batch(batch: dict, mesh: DataMesh | None) -> dict:
    """The rank's part of a numpy batch: arrays of rank >= 2 split on the
    batch axis, 1-D shared time axes whole, non-arrays dropped (host-only
    values such as n_real or notes_text). Without a mesh every array."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, np.ndarray):
            continue
        out[k] = v[mesh.rows(v.shape[0])] if mesh is not None and v.ndim >= 2 else v
    return out
