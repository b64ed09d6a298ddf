"""Device-resident epoch execution (after imm_tsf_tpu/training/device_loop.py).

The streaming loop moves one host batch to the device a step. Here every
collated window of a split stays in device memory, and each step gathers
its batch by index: on cuda one CUDA graph replay a step
(training/graphs.py), the counterpart of the JAX package's `lax.scan`
over the epoch.

Exactness contract (the JAX file's, :14-31; tests/test_torch_device_loop.py):
  - batch composition and order equal the streaming BatchIterator's: the
    same numpy Generator calls produce the epoch permutation, so the
    shuffle stream and the checkpoints' data_rng_state are unchanged;
  - the hash-dropout salts come from the same generator calls, in the
    same site order (layers/fast_dropout.SaltTape), so the masks equal the
    streaming loop's bit for bit;
  - evaluation returns the per-batch error sums and the host reduces them
    in float64, in the streaming evaluation's order.

Collates that are per-window independent (standard, CRU, patch) are
collated once and stacked (`try_build_resident`); the patch path's
per-batch `Lp` is zero-padded to the split's largest, that path's own pad
value. The ODE collate's union time axis depends on the batch: its
1-D time axes fail the resident build, and those runs take the
epoch-staged mode (`stage_epoch`), which collates each epoch's batches on
the host as the streaming loop would and stacks them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.loader import BatchIterator, PrefetchIterator


def _unwrap(loader):
    """(BatchIterator, rebuild) under the loader stages and prefetch (JAX
    :44-70): a stage exposing `rebuild_around(base)` (trainer.
    _EmbedNotesLoader, _TimeLLMPromptLoader) is re-applied around a probe
    iterator by rebuild(probe); PrefetchIterator is transparent; any other
    wrapper stops the unwrap (the resident build then refuses)."""
    wrappers = []
    while True:
        if hasattr(loader, "rebuild_around"):
            wrappers.append(loader.rebuild_around)
            loader = loader.base
        elif isinstance(loader, PrefetchIterator):
            loader = loader.base
        else:
            break

    def rebuild(probe):
        for wrap in reversed(wrappers):
            probe = wrap(probe)
        return probe

    return loader, (rebuild if wrappers else None)


def try_build_resident(loader, max_bytes: int = 4 << 30):
    """Every window of the split collated once and stacked: (arrays
    [n_windows + 1, ...], row_of: chunk index -> row), the last row the
    all-zero pad window of remainder batches. None when the split is
    batch-dependent (a 1-D or non-array value: the ODE collate), the keys
    differ between batches, or the arrays exceed max_bytes (JAX :73-141)."""
    if loader is None:
        return None
    bit, rebuild = _unwrap(loader)
    if not isinstance(bit, BatchIterator):
        return None
    probe = BatchIterator(bit.chunks, bit.indices, bit.batch_size, bit.collate_fn,
                          shuffle=False, pad_to_batch=False)
    it = probe if rebuild is None else rebuild(probe)
    stacks, probe_bytes = [], 0
    for out in it:
        out.pop("n_real", None)
        out.pop("notes_text", None)
        if any(not (isinstance(v, np.ndarray) and v.ndim >= 2) for v in out.values()):
            return None
        # padding at the concatenation only grows the total: past the cap
        # here is decisive, before the whole split sits in host memory
        probe_bytes += sum(v.nbytes for v in out.values())
        if probe_bytes > max_bytes:
            return None
        stacks.append(out)
    if not stacks or any(s.keys() != stacks[0].keys() for s in stacks):
        return None
    resident, total = {}, 0
    for k in stacks[0]:
        parts = [s[k] for s in stacks]
        # zero-pad trailing axes to the largest (the patch path's Lp); axis
        # 0 is the concatenated one, and the remainder batch is shorter
        tgt = tuple(max(p.shape[d] for p in parts) for d in range(parts[0].ndim))
        parts = [np.pad(p, [(0, 0)] + [(0, t - s) for s, t in zip(p.shape[1:], tgt[1:])])
                 if p.shape[1:] != tgt[1:] else p for p in parts]
        arr = np.concatenate(parts, axis=0)
        arr = np.concatenate([arr, np.zeros((1,) + arr.shape[1:], arr.dtype)])
        total += arr.nbytes
        resident[k] = arr
    if total > max_bytes:
        return None
    row_of = np.full(int(max(bit.indices, default=0)) + 1, -1, np.int64)
    row_of[np.asarray(bit.indices, np.int64)] = np.arange(len(bit.indices))
    return resident, row_of


def epoch_perm(bit, row_of, n_rows: int) -> np.ndarray:
    """The epoch's [n_batches, B] table of resident rows, from the same
    generator calls as BatchIterator.__iter__; remainder slots point at the
    all-zero pad row (JAX :144-160)."""
    order = np.array(bit.indices)
    if bit.shuffle:
        bit._rng.shuffle(order)
    return _batched(row_of[order], bit.batch_size, n_rows)


def eval_perm(bit, row_of, n_rows: int) -> np.ndarray:
    """The fixed-order table of a val or test split (JAX :163-168)."""
    return _batched(row_of[np.array(bit.indices)], bit.batch_size, n_rows)


def _batched(rows: np.ndarray, B: int, n_rows: int) -> np.ndarray:
    n_batches = (len(rows) + B - 1) // B
    padded = np.full(n_batches * B, n_rows - 1, np.int64)
    padded[: len(rows)] = rows
    return padded.reshape(n_batches, B).astype(np.int32)


class Resident:
    """A split's resident arrays on `device` and its [n_batches, B] row
    table, a static buffer each epoch's table is copied into."""

    def __init__(self, name: str, built, bit, device):
        arrays, self.row_of = built
        self.name, self.bit = name, bit
        self.store = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
        self.n_rows = next(iter(arrays.values())).shape[0]
        self.n_batches = (len(bit.indices) + bit.batch_size - 1) // bit.batch_size
        self.table = torch.zeros((self.n_batches, bit.batch_size), dtype=torch.int64,
                                 device=device)
        self.key = ("resident", name, self.n_rows)

    def load(self, perm: np.ndarray) -> None:
        self.table.copy_(torch.from_numpy(perm.astype(np.int64)))


def gather(table: torch.Tensor):
    """Batch `pos` of a resident store: its rows table[pos], a row
    index_select on the device (JAX :171-186)."""

    def select(store: dict, pos: torch.Tensor) -> dict:
        idx = table.index_select(0, pos)[0]
        return {k: v.index_select(0, idx) for k, v in store.items()}

    return select


def staged_batch(store: dict, pos: torch.Tensor) -> dict:
    """Batch `pos` of a staged store [n_batches, ...]."""
    return {k: v.index_select(0, pos)[0] for k, v in store.items()}


def make_epoch_runners(forward, grad_step, loop):
    """(run_train_epoch, run_eval_epoch) over Resident splits on `loop`
    (graphs.StepLoop), after JAX :189-230.

    run_train_epoch(res, perm, on_oom) -> ([n_batches] loss buffer,
    skipped steps): the modules, Adam and the generators advance in place.
    run_eval_epoch(res) -> each batch's error sums, [n_batches, D]."""

    def run_train_epoch(res: Resident, perm: np.ndarray, on_oom=None):
        res.load(perm)
        return loop.train_epoch(grad_step, res.key, res.store, gather(res.table), len(perm),
                                on_oom)

    def run_eval_epoch(res: Resident) -> dict:
        res.load(eval_perm(res.bit, res.row_of, res.n_rows))
        return loop.eval_epoch(forward, res.key, res.store, gather(res.table), res.n_batches)

    return run_train_epoch, run_eval_epoch


def make_predict_runner(forward, loop):
    """The inference variant (JAX :233-255): run_predict(res) -> (stacked
    predictions [n_batches, B, Lp, C], each batch's error sums)."""

    def run_predict(res: Resident):
        res.load(eval_perm(res.bit, res.row_of, res.n_rows))
        out = dict(loop.eval_epoch(forward, res.key + ("predict",), res.store,
                                   gather(res.table), res.n_batches, keep_pred=True))
        return out.pop("pred"), out

    return run_predict


def stage_epoch(loader) -> dict | None:
    """One epoch's batches collated on the host exactly as the streaming
    loop would (the same shuffle calls) and stacked [n_batches, ...], for
    batch-dependent collates (the ODE path's union time axis). 1-D time
    axes are edge-repeated to the epoch's longest (a repeated time is a
    dt = 0 identity step of the fixed-step solvers), everything else
    zero-padded (masks stay zero). None if a value is not an array (JAX
    :258-298)."""
    batches = []
    for out in loader:
        out = dict(out)
        for k in ("n_real", "n_observed_tp", "notes_text"):
            out.pop(k, None)
        if any(not isinstance(v, np.ndarray) for v in out.values()):
            return None
        batches.append(out)
    if not batches or any(b.keys() != batches[0].keys() for b in batches):
        return None
    stacked = {}
    for k in batches[0]:
        parts = [b[k] for b in batches]
        tgt = tuple(max(p.shape[d] for p in parts) for d in range(parts[0].ndim))
        padded = []
        for p in parts:
            if p.shape == tgt:
                padded.append(p)
            elif p.ndim == 1:  # a shared time axis: edge-repeat (dt = 0 pads)
                padded.append(np.pad(p, (0, tgt[0] - p.shape[0]), mode="edge"))
            else:
                padded.append(np.pad(p, [(0, t - s) for s, t in zip(p.shape, tgt)]))
        stacked[k] = np.stack(padded)
    return stacked


def make_staged_runners(forward, grad_step, loop, device):
    """Staged variants of the epoch runners (JAX :301-350): a static store
    per stacked shape, which each epoch of that shape is copied into (a
    new longest union axis is a new shape, and a new captured step).

    run_train_staged(stacked, on_oom) -> (losses, skipped);
    stage_eval(name, stacked) -> the split's store, once;
    run_eval_staged(name) -> each batch's error sums."""
    stores: dict = {}

    def _store(key, stacked: dict) -> dict:
        store = stores.get(key)
        if store is None:
            store = stores[key] = {k: torch.from_numpy(v).to(device) for k, v in stacked.items()}
        else:
            for k, v in stacked.items():
                store[k].copy_(torch.from_numpy(v))
        return store

    def run_train_staged(stacked: dict, on_oom=None):
        key = ("staged",) + tuple((k, v.shape) for k, v in stacked.items())
        n = next(iter(stacked.values())).shape[0]
        return loop.train_epoch(grad_step, key, _store(key, stacked), staged_batch, n, on_oom)

    def stage_eval(name: str, stacked: dict) -> None:
        _store(("staged", name), stacked)

    def run_eval_staged(name: str) -> dict:
        store = stores[("staged", name)]
        n = next(iter(store.values())).shape[0]
        return loop.eval_epoch(forward, ("staged", name), store, staged_batch, n)

    return run_train_staged, stage_eval, run_eval_staged


def reduce_eval_sums(sum_stack: dict) -> dict:
    """The per-batch sums reduced on the host in float64, in sequence: the
    streaming evaluation's order and dtype (JAX :353-365)."""
    out = {}
    for k, v in sum_stack.items():
        v = v.double().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v, np.float64)
        acc = v[0].copy()
        for i in range(1, len(v)):
            acc += v[i]
        out[k] = acc
    return out
