"""The epoch loop's steps, run eagerly or captured in CUDA graphs.

The JAX package runs a device-resident epoch as one `lax.scan` under
`jax.jit` (imm_tsf_tpu/training/device_loop.py:189-230). Its CUDA
counterpart here captures one step in a CUDA graph and replays it over
the resident windows, one replay a batch, with nothing read back until
the epoch ends:

- static inputs: the stacked store of the split, the epoch's [n_batches,
  B] table of store rows, a one-element `pos` (the running batch, filled
  before each step), the epoch's [n_batches, n_sites, 2] table of
  hash-dropout salts (layers/fast_dropout.SaltTape; under
  dropout_impl="flax" the step keys of the run's KeyChain) and the [n_batches]
  loss buffer, or the eval outputs' [n_batches, ...] error sums;
- the step gathers its batch by `pos` and writes its loss (or its error
  sums) at `pos`, so the host reads an epoch's losses once;
- a training step is `zero_grad(set_to_none=True)`, forward, backward,
  clip and Adam (`capturable=True` on cuda, training/optim.py), all
  captured; the device generators (ProbSparse's samples, the z0 noise)
  are registered with the graph, so each replay draws afresh as an eager
  step would;
- the first call of a step (a key: its kind and input shapes) runs
  eagerly on the capture stream: a real step of the run, which also
  records the dropout sites, loads the kernel libraries, plans the
  cluster kernels' launches and creates Adam's state; the second call
  captures and replays; every later call replays. Nothing is thrown away
  and nothing falls back: a capture that fails raises;
- one graph per key; the training graphs share one memory pool and the
  eval graphs another;
- a loop runs every step on its own stream, which waits for the current
  stream at an epoch's start (its row table) and makes the current stream
  wait at the end: several loops (the replicas of a sweep, training/
  vmap_sweep.py) step in turn through `interleave`, each replay on its own
  stream and in its own pools, so their kernels may overlap;
- the kernel wrappers' launch counters count Python calls, which a replay
  does not make: the counters' change during a capture is taken back and
  added once a replay.

`StepLoop(device, generators, eager=reason)` runs every step eagerly when
the device is not cuda, or when `reason` names why a step cannot be
captured (autograd's anomaly mode); the trainer logs the reason. Eager steps read the same buffers
through the same code.

`ForwardGraphs` is the inference counterpart, the JAX package's jitted
served forward (imm_tsf_tpu/serving.py:342-344, export.py:89,
predict.py:164-169): a live service's dispatch (serving.py), an exported
program's (export.py) and a streaming predict batch (predict.py) replay
one graph a collated input shape. Its key is the sorted (name, shape,
dtype) of the batch's arrays and a tag (the service's kernel route,
`route_of`, so that a flipped route is its own key and never replays the
other route's graph); each key holds pinned host staging buffers, static
device inputs and the outputs of its graph, all the runner's graphs in
one memory pool. A key's first call runs eagerly on the runner's stream
and returns that answer (a real dispatch, which loads the kernel
libraries and fills the host caches: `_cluster.cluster_plan`,
ProbAttention's eval sample, the ODE models' eval noise, `embed.pe_table`),
then captures; every later call copies the batch into the staging
buffers, then into the static inputs, and replays. A failed capture
raises. The capture is thread-local (`capture_error_mode`): a service
captures on its worker thread, an artifact on an HTTP handler thread,
while other threads of the process (another service, a client) may make
CUDA calls that the global mode would refuse during the capture. On the
CPU every call runs eagerly through the same buffers. `clear()` drops the
graphs, buffers and pool (a closed service frees its device memory).
"""

from __future__ import annotations

import contextlib
import ctypes
import time

import numpy as np
import torch

from ..kernels import attn, cru_scan, dropout, expm, ffn, recavg
from ..layers.fast_dropout import SaltTape, salt_tape
from ..ops import cru_scan as cru_scan_ops
from .evaluation import batch_error_sums

# every kernel wrapper's launch counter: (module, attribute)
COUNTERS = ((recavg, "launches"), (ffn, "launches"), (ffn, "train_launches"),
            (ffn, "bf16w_launches"), (expm, "launches"), (expm, "frechet_launches"),
            (cru_scan, "launches"), (cru_scan, "backward_launches"), (attn, "launches"),
            (attn, "backward_calls"), (recavg, "one_pass_launches"),
            (ffn, "one_pass_launches"), (attn, "one_pass_launches"),
            (dropout, "launches"), (dropout, "backward_launches"))
WARMUP_CALLS = 1  # eager calls of a key before its capture


def launch_counts() -> dict:
    """Every launch counter by "<module>.<counter>" (e.g. "ffn.launches")."""
    return {f"{m.__name__.rsplit('.', 1)[-1]}.{a}": getattr(m, a) for m, a in COUNTERS}


def _counts() -> tuple[list, dict]:
    return [getattr(m, a) for m, a in COUNTERS], dict(attn.launches_by_shape)


def _since(before: tuple[list, dict]) -> tuple[list, dict]:
    after = _counts()
    return ([a - b for a, b in zip(after[0], before[0])],
            {k: v - before[1].get(k, 0) for k, v in after[1].items()
             if v != before[1].get(k, 0)})


def _advance(delta: tuple[list, dict], sign: int) -> None:
    for (m, a), d in zip(COUNTERS, delta[0]):
        setattr(m, a, getattr(m, a) + sign * d)
    for shape, d in delta[1].items():
        attn.launches_by_shape[shape] = attn.launches_by_shape.get(shape, 0) + sign * d


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """The node count of a graph captured with keep_graph=True
    (cuGraphGetNodes of libcuda)."""
    lib = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed (CUresult {rc})")
    return int(n.value)


class Captured:
    """fn() captured on `stream` into a CUDA graph in `pool`, with the
    device `generators` registered; replay() runs it and advances the
    launch counters by what the capture launched."""

    def __init__(self, fn, stream, pool, generators, capture_error_mode: str = "global"):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in generators:
            graph.register_generator_state(gen)
        before = _counts()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode=capture_error_mode):
                fn()
        except BaseException:
            _advance(_since(before), -1)
            raise
        graph.instantiate()
        torch.cuda.synchronize(stream.device)
        self.capture_s = time.perf_counter() - t0
        self.delta = _since(before)
        _advance(self.delta, -1)  # the capture launched nothing
        self.nodes = graph_nodes(graph)
        self.graph = graph

    def replay(self) -> None:
        self.graph.replay()
        _advance(self.delta, 1)


class StepLoop:
    """The epoch loop's step runner for one training run: eager, or each
    key's step captured after WARMUP_CALLS eager calls (see the module
    docstring). `timer`, a list on cuda, gets the (start, end) CUDA events
    around each eager training step or replay (warm-up calls untimed)."""

    def __init__(self, device, generators=(), eager: str | None = None, timer=None):
        self.device = torch.device(device)
        self.eager = eager
        self.capture = self.device.type == "cuda" and eager is None
        self.generators = [g for g in generators if g.device.type == "cuda"]
        self.tape = SaltTape()
        self.pos = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.timer = timer
        self.calls: dict = {}  # key -> calls so far
        self.graphs: dict = {}  # key -> Captured
        self.buffers: dict = {}  # key -> the step's static outputs
        self.replays = 0
        self.eager_calls = 0  # training steps and eval batches run eagerly
        if self.capture:
            self.stream = torch.cuda.Stream(self.device)
            self.pools = {"train": torch.cuda.graph_pool_handle(),
                          "eval": torch.cuda.graph_pool_handle()}

    def stats(self) -> dict:
        """Capture seconds and node counts by key, replays and eager calls."""
        return {"captured": self.capture, "eager_reason": self.eager,
                "capture_s": {str(k): g.capture_s for k, g in self.graphs.items()},
                "graph_nodes": {str(k): g.nodes for k, g in self.graphs.items()},
                "replays": self.replays, "eager_calls": self.eager_calls}

    def _on_stream(self):
        """The block on the loop's own stream (cuda), where every step, its
        `pos` and its salts go: replicas of a sweep (training/vmap_sweep.py)
        replay on their own streams, so their kernels may overlap."""
        return torch.cuda.stream(self.stream) if self.capture else contextlib.nullcontext()

    def _join(self, begin: bool) -> None:
        """At an epoch's start the loop's stream waits for the current
        stream (a row table just loaded), at its end the current stream
        for the loop's."""
        if self.capture:
            current = torch.cuda.current_stream(self.device)
            if begin:
                self.stream.wait_stream(current)
            else:
                current.wait_stream(self.stream)

    def _call(self, key, kind: str, fn) -> None:
        """fn() as the key's next call, on the loop's stream: eager while
        warming up, then captured once and replayed."""
        n = self.calls.get(key, 0)
        self.calls[key] = n + 1
        if not self.capture:
            self._timed(kind, fn)
            self.eager_calls += 1
        elif n < WARMUP_CALLS:
            fn()
            self.eager_calls += 1
        else:
            if key not in self.graphs:
                self.graphs[key] = Captured(fn, self.stream, self.pools[kind], self.generators)
            self._timed(kind, self.graphs[key].replay)
            self.replays += 1

    def _timed(self, kind: str, fn) -> None:
        """fn(), between two CUDA events when it is a training step and
        the loop has a timer (a capture's own call is not timed)."""
        if self.timer is None or kind != "train":
            fn()
            return
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        self.timer.append((start, end))

    def train_epoch(self, grad_step, key, store: dict, select, n: int,
                    on_oom=None) -> tuple[torch.Tensor, list]:
        """n training steps over `store`, batch i = select(store, pos) at
        pos = i; returns the [n] loss buffer (device) and the steps an
        eager out-of-memory skipped (on_oom(step, error) decides: it raises,
        or returns to skip). The epoch's salts are drawn here, on the host,
        before its first step, except a recording step's own."""
        return interleave([self.train_steps(grad_step, key, store, select, n, on_oom)])[0]

    def train_steps(self, grad_step, key, store: dict, select, n: int, on_oom=None):
        """train_epoch as a generator that yields after each step, so that
        other loops' steps can go in between (interleave); it returns what
        train_epoch returns."""
        tape = self.tape
        key = ("train",) + key
        if key not in self.buffers:
            self.buffers[key] = {"losses": torch.zeros(n, device=self.device)}
        buf = self.buffers[key]
        losses = buf["losses"]

        def step():
            batch = select(store, self.pos)
            if tape.generators is not None:
                tape.row = buf["salts"].index_select(0, self.pos)[0]
            tape.begin()
            with salt_tape(tape):
                loss = grad_step(batch)
            tape.end()
            losses.index_copy_(0, self.pos, loss.detach().reshape(1).to(losses.dtype))

        skipped: list = []
        drawn = False
        self._join(begin=True)
        for i in range(n):
            with self._on_stream():
                # the run's first step records the sites; the rest of the
                # epoch's salts are drawn once they are known
                if not drawn and tape.generators is not None:
                    if "salts" not in buf:
                        buf["salts"] = torch.zeros((n, tape.n_sites, 2), dtype=torch.int64,
                                                   device=self.device)
                    buf["salts"][i:].copy_(tape.draw(n - i))
                    drawn = True
                self._train_call(key, step, i, on_oom, skipped)
            yield
        self._join(begin=False)
        return losses, skipped

    def _train_call(self, key, step, i: int, on_oom, skipped: list) -> None:
        """Training step i; an eager step's out-of-memory goes to on_oom."""
        self.pos.fill_(i)
        try:
            self._call(key, "train", step)
        except torch.cuda.OutOfMemoryError as e:
            if on_oom is None or self.capture:
                raise
            on_oom(i, e)
            skipped.append(i)

    def eval_epoch(self, forward, key, store: dict, select, n: int,
                   keep_pred: bool = False) -> dict:
        """n eval batches over `store` under torch.no_grad() (the modules in
        eval mode are the caller's); returns each batch's error sums as
        [n, ...] device tensors ("pred" too, the stacked predictions, when
        keep_pred)."""
        key = ("eval",) + key
        out = self.buffers.setdefault(key, {})

        def step():
            batch = select(store, self.pos)
            pred = forward(batch)
            sums = batch_error_sums(pred, batch["data_to_predict"],
                                    batch["mask_predicted_data"])
            if keep_pred:
                sums["pred"] = pred
            for k, v in sums.items():
                if k not in out:
                    out[k] = torch.zeros((n,) + tuple(v.shape), dtype=v.dtype,
                                         device=self.device)
                out[k].index_copy_(0, self.pos, v[None])

        self._join(begin=True)
        with torch.no_grad(), self._on_stream():
            for i in range(n):
                self.pos.fill_(i)
                self._call(key, "eval", step)
        self._join(begin=False)
        return out


def interleave(step_iters: list) -> list:
    """Advance each of `step_iters` (StepLoop.train_steps) a step in turn
    until all are done; returns what each returned. Loops on cuda replay on
    their own streams, so one batch's steps of several loops may run on the
    device at once."""
    results: list = [None] * len(step_iters)
    live = list(enumerate(step_iters))
    while live:
        for entry in list(live):
            try:
                next(entry[1])
            except StopIteration as done:
                results[entry[0]] = done.value
                live.remove(entry)
    return results


def eager_reason(cfg, mesh=None) -> str | None:
    """Why this run's steps cannot be captured, or None: the config's
    `debug_nans` (autograd's anomaly mode reads every backward's output on
    the host), or a data mesh on cuda whose collectives run over gloo
    (ranks that share one card: gloo stages CUDA tensors through host
    memory, which a graph cannot hold; NCCL's are captured). No backbone reads a value back
    to the host inside a step."""
    if cfg.debug_nans:
        return "debug_nans: autograd's anomaly mode checks each backward on the host"
    if mesh is not None and mesh.device.type == "cuda" and mesh.backend == "gloo":
        return "gloo collectives (ranks sharing a card) stage through host memory"
    return None


ROUTE_FLAGS = ("use_pallas", "use_fused_ffn", "use_fused_attn")


def route_sites(*modules) -> list:
    """(module, flag) for every kernel-route flag of `modules` and their
    submodules, in module order (None entries are skipped)."""
    return [(m, flag) for root in modules if root is not None for m in root.modules()
            for flag in ROUTE_FLAGS if hasattr(m, flag)]


def route_of(sites: list) -> tuple:
    """The route a forward takes now: each site's flag, and the CRU route
    that ops/cru_scan reads from IMM_TSF_CRU_FUSED at each call. The
    precision needs no field: trainer.make_forward reads compute_dtype
    once, so a forward (and the runner a service, a sweep or an artifact
    builds around it) keeps one precision for its life, and two
    precisions never share a runner's keys."""
    return tuple(bool(getattr(m, flag)) for m, flag in sites) + (cru_scan_ops._use_fused(),)


class _Key:
    """One input signature's buffers: `host` (pinned staging on cuda; the
    static inputs themselves on the CPU), `static` (the inputs the forward
    reads), the graph and its outputs once captured, and the event after
    which the last call's copies have read `host`."""

    def __init__(self, arrays: dict, device: torch.device):
        cuda = device.type == "cuda"
        with torch.inference_mode(False):  # normal tensors: writable in any mode
            self.host = {k: torch.empty(v.shape, dtype=torch.from_numpy(np.empty(0, v.dtype)).dtype,
                                        pin_memory=cuda) for k, v in arrays.items()}
            self.static = ({k: torch.empty_like(t, device=device) for k, t in self.host.items()}
                           if cuda else self.host)
        self.graph: Captured | None = None
        self.outputs = None
        self.copied: torch.cuda.Event | None = None


class ForwardGraphs:
    """The served forward `fn(batch) -> tensor, or a tuple / dict of
    tensors` on `device`, one CUDA graph a key (module docstring).

    runner(host, tag) takes the host batch (its NumPy arrays; other values
    are dropped, as trainer.to_device drops them) and returns fn's outputs
    for it. On cuda a replay's outputs are the graph's static tensors,
    valid until the runner's next call: the caller copies them out (the
    current stream waits for the runner's before the call returns)."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self.keys: dict = {}
        self.replays = 0
        self.eager_calls = 0
        if self.capture:
            self.stream = torch.cuda.Stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    def __call__(self, host: dict, tag=()):
        arrays = {k: v for k, v in host.items() if isinstance(v, np.ndarray)}
        key = (tag, tuple(sorted((k, v.shape, v.dtype.str) for k, v in arrays.items())))
        entry = self.keys.get(key)
        if entry is None:
            entry = self.keys[key] = _Key(arrays, self.device)
        if not self.capture:
            self._fill(entry, arrays)
            self.eager_calls += 1
            return self.fn(entry.static)
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            if entry.copied is not None:
                entry.copied.synchronize()  # the last call's copies have read `host`
            self._fill(entry, arrays)
            entry.copied = torch.cuda.Event()
            entry.copied.record(self.stream)
            if entry.graph is None:
                out = self.fn(entry.static)
                self.eager_calls += 1
                held = []
                entry.graph = Captured(lambda: held.append(self.fn(entry.static)), self.stream,
                                       self.pool, (), capture_error_mode="thread_local")
                entry.outputs = held[0]
            else:
                entry.graph.replay()
                self.replays += 1
                out = entry.outputs
        current.wait_stream(self.stream)
        return out

    @staticmethod
    def _fill(entry: _Key, arrays: dict) -> None:
        for k, v in arrays.items():
            entry.host[k].numpy()[...] = v
            if entry.static is not entry.host:
                entry.static[k].copy_(entry.host[k], non_blocking=True)

    def pool_bytes(self) -> int:
        """The device bytes the graphs' pool holds (cuda; 0 on the CPU)."""
        if not self.capture:
            return 0
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def stats(self) -> dict:
        """Keys seen, graphs captured, their capture seconds and node
        counts, replays and eager calls."""
        graphs = [e.graph for e in self.keys.values() if e.graph is not None]
        return {"captured": self.capture, "keys": len(self.keys), "graphs": len(graphs),
                "capture_s": sum(g.capture_s for g in graphs),
                "graph_nodes": [g.nodes for g in graphs],
                "replays": self.replays, "eager_calls": self.eager_calls}

    def clear(self) -> None:
        """Drop every key's graph and buffers; the pool's memory returns to
        the device. A later call captures anew."""
        graphs = [e.graph for e in self.keys.values() if e.graph is not None]
        self.keys.clear()  # every buffer and graph output: no name may keep one alive
        for graph in graphs:
            graph.graph.reset()
        if self.capture:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
