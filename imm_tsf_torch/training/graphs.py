"""The epoch loop's steps, run eagerly or captured in CUDA graphs.

The JAX package runs a device-resident epoch as one `lax.scan` under
`jax.jit` (imm_tsf_tpu/training/device_loop.py:189-230). Its CUDA
counterpart here captures one step in a CUDA graph and replays it over
the resident windows, one replay a batch, with nothing read back until
the epoch ends:

- static inputs: the stacked store of the split, the epoch's [n_batches,
  B] table of store rows, a one-element `pos` (the running batch, filled
  before each step), the epoch's [n_batches, n_sites, 2] table of
  hash-dropout salts (layers/fast_dropout.SaltTape) and the [n_batches]
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
captured (a model that reads a value back to the host, autograd's anomaly
mode); the trainer logs the reason. Eager steps read the same buffers
through the same code.
"""

from __future__ import annotations

import contextlib
import ctypes
import time

import torch

from ..kernels import attn, cru_scan, expm, ffn, recavg
from ..layers.fast_dropout import SaltTape, salt_tape
from .evaluation import batch_error_sums

# every kernel wrapper's launch counter: (module, attribute)
COUNTERS = ((recavg, "launches"), (ffn, "launches"), (ffn, "train_launches"),
            (expm, "launches"), (expm, "frechet_launches"), (cru_scan, "launches"),
            (cru_scan, "backward_launches"), (attn, "launches"), (attn, "backward_calls"))
WARMUP_CALLS = 1  # eager calls of a key before its capture


def _counts() -> tuple[list, dict]:
    return [getattr(m, a) for m, a in COUNTERS], dict(attn.launches_by_shape)


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

    def __init__(self, fn, stream, pool, generators):
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in generators:
            graph.register_generator_state(gen)
        before = _counts()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            fn()
        graph.instantiate()
        torch.cuda.synchronize(stream.device)
        self.capture_s = time.perf_counter() - t0
        after = _counts()
        self.delta = ([a - b for a, b in zip(after[0], before[0])],
                      {k: v - before[1].get(k, 0) for k, v in after[1].items()
                       if v != before[1].get(k, 0)})
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


def eager_reason(cfg, model) -> str | None:
    """Why this run's steps cannot be captured, or None: the config's
    `debug_nans` (autograd's anomaly mode reads every backward's output on
    the host), or the model class's `eager_steps` (a value read back to the
    host inside the step)."""
    if cfg.debug_nans:
        return "debug_nans: autograd's anomaly mode checks each backward on the host"
    why = getattr(type(model), "eager_steps", None)
    return f"{type(model).__name__}.eager_steps: {why}" if why else None
