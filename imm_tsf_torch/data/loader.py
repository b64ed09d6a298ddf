"""Split logic and batching iterators, host side (after
imm_tsf_tpu/data/loader.py:25-273).

Split semantics match the JAX package's exactly:

  instance: sklearn train_test_split(rec_ids, 0.8, random_state=42, shuffle=True)
            then (0.75, shuffle=False) (reference :689-713), re-derived
            here with np.random.RandomState(42), since the machine with
            the card has no sklearn
  sample:   per-record temporal 60/20/20 by chunk idx (:715-731)

`BatchIterator` shuffles with the same np.random.default_rng(seed)
stream, so batch order matches the JAX package's for the same seed. The
double-buffered `PrefetchIterator` is not ported yet (ROADMAP.md, Queue 1, item 4).
"""

from __future__ import annotations

import math
import os
from collections import defaultdict
from typing import Callable, Iterator

import numpy as np

from ..config import finalize_patching
from . import collate as C
from .dataset import Chunk, ChunkedTimeSeriesDataset


def _train_test_split(items: list, train_size: float, shuffle: bool) -> tuple[list, list]:
    """sklearn's train_test_split(items, train_size=..., random_state=42,
    shuffle=...): floor(train_size * n) train items, the rest test; when
    shuffling, test is the head of RandomState(42).permutation(n) and
    train the next n_train."""
    n = len(items)
    n_train = math.floor(train_size * n)
    n_test = n - n_train
    if n_train == 0 or n_test == 0:
        raise ValueError(f"With n_samples={n} and train_size={train_size}, the resulting "
                         "train or test set will be empty")
    if shuffle:
        perm = np.random.RandomState(42).permutation(n)
        test, train = perm[:n_test], perm[n_test:n_test + n_train]
    else:
        train, test = np.arange(n_train), np.arange(n_train, n)
    return [items[i] for i in train], [items[i] for i in test]


def split_indices(chunks: list[Chunk], split_method: str):
    if split_method == "instance":
        rec_ids = sorted({c.record_id for c in chunks})
        train_recs, test_recs = _train_test_split(rec_ids, 0.8, shuffle=True)
        train_recs, val_recs = _train_test_split(train_recs, 0.75, shuffle=False)
        train_recs, val_recs, test_recs = set(train_recs), set(val_recs), set(test_recs)
        train_idx = [i for i, c in enumerate(chunks) if c.record_id in train_recs]
        val_idx = [i for i, c in enumerate(chunks) if c.record_id in val_recs]
        test_idx = [i for i, c in enumerate(chunks) if c.record_id in test_recs]
    elif split_method == "sample":
        grouped = defaultdict(list)
        for i, c in enumerate(chunks):
            grouped[c.record_id].append((c.chunk_index, i))
        train_idx, val_idx, test_idx = [], [], []
        for lst in grouped.values():
            lst.sort(key=lambda x: x[0])
            N = len(lst)
            t_end, v_end = int(N * 0.6), int(N * 0.8)
            train_idx += [i for _, i in lst[:t_end]]
            val_idx += [i for _, i in lst[t_end:v_end]]
            test_idx += [i for _, i in lst[v_end:]]
    else:
        raise ValueError(f"Unknown split_method: {split_method!r}")
    return train_idx, val_idx, test_idx


class BatchIterator:
    """Epoch iterator over a chunk subset. Each __iter__ re-shuffles (train)."""

    def __init__(self, chunks: list[Chunk], indices: list[int], batch_size: int,
                 collate_fn: Callable[[list[Chunk]], dict], shuffle: bool, seed: int = 0,
                 pad_to_batch: bool = True):
        self.chunks = chunks
        self.indices = list(indices)
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.pad_to_batch = pad_to_batch
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return (len(self.indices) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        order = np.array(self.indices)
        if self.shuffle:
            self._rng.shuffle(order)
        for s in range(0, len(order), self.batch_size):
            batch = [self.chunks[i] for i in order[s: s + self.batch_size]]
            out = self.collate_fn(batch)
            if self.pad_to_batch and len(batch) < self.batch_size:
                out = _pad_batch_dim(out, len(batch), self.batch_size)
            out["n_real"] = len(batch)
            yield out


def _pad_batch_dim(out: dict, n: int, B: int) -> dict:
    """Pad the batch axis to a static B with all-zero-mask dummy rows.

    Metric sums/counts and the masked two-stage loss are invariant to
    zero-mask rows, so remainder batches keep one static shape."""
    pad = B - n
    padded = {}
    for k, v in out.items():
        # batch-axis arrays are exactly the >=2-D ones (the ODE path's shared
        # 1-D time axes have no batch dim and must not be padded)
        if isinstance(v, np.ndarray) and v.ndim >= 2 and v.shape[0] == n:
            padded[k] = np.concatenate(
                [v, np.zeros((pad,) + v.shape[1:], v.dtype)], axis=0
            )
        elif isinstance(v, list) and len(v) == n:  # notes_text
            padded[k] = v + [[] for _ in range(pad)]
        else:
            padded[k] = v
    return padded


def parse_datasets(cfg, verbose: bool = True) -> dict:
    """Build the dataset and its three loaders: the reference's data_obj
    contract (lib/parse_datasets.py:847-854), with cfg.input_len,
    cfg.pred_len and cfg.input_dim resolved from the chunks' bounds (and,
    for tPatchGNN, the patching finalized). Each model family takes its
    collate, as imm_tsf_tpu/data/loader.py:206-223 dispatches them:
    tPatchGNN the patch collate, CRU the CRU collate, LatentODE the ODE
    collate, every other model the standard one."""
    base = cfg.data_root if os.path.isabs(cfg.data_root) else os.path.abspath(cfg.data_root)
    ds = ChunkedTimeSeriesDataset(
        root=os.path.join(base, cfg.dataset), history=cfg.history,
        pred_window=cfg.pred_window, stride=cfg.stride, time_unit=cfg.time_unit,
        unit_scale=cfg.unit_scale, normalize=True, enable_text=cfg.enable_text,
        use_text_embeddings=cfg.use_text_embeddings, llm_model_fusion=cfg.llm_model_fusion,
        llm_layers_fusion=cfg.llm_layers_fusion, max_length=cfg.max_length,
        rec_ids=list(cfg.rec_ids) if cfg.rec_ids else None, verbose=verbose)
    b = ds.bounds
    time_max = float(cfg.history + cfg.pred_window)
    cfg = cfg.replace(input_dim=ds.input_dim, input_len=b.max_obs_len, pred_len=b.max_pred_len)
    if cfg.model == "tPatchGNN":
        cfg = finalize_patching(cfg)
        base_collate = lambda batch: C.patch_collate(
            batch, cfg.history, time_max, b.max_pred_len, cfg.patch_size, cfg.patch_stride,
            cfg.npatch)
    elif cfg.model == "LatentODE":
        base_collate = lambda batch: C.ode_collate(batch, cfg.history, time_max)
    else:
        fn = C.cru_collate if cfg.model == "CRU" else C.standard_collate
        base_collate = lambda batch: fn(batch, cfg.history, time_max, b.max_obs_len,
                                        b.max_pred_len)

    def collate_fn(batch: list[Chunk]) -> dict:
        out = base_collate(batch)
        return C.add_multimodal(out, batch, cfg.enable_text, cfg.use_text_embeddings,
                                b.max_notes, b.d_txt)

    train_idx, val_idx, test_idx = split_indices(ds.chunks, cfg.split_method)
    if not train_idx or not val_idx:
        raise ValueError(
            f"Empty {'train' if not train_idx else 'val'} split: "
            f"{len(ds.chunks)} chunks -> train={len(train_idx)}, "
            f"val={len(val_idx)}, test={len(test_idx)} with "
            f"split_method={cfg.split_method!r}. Use more data, a smaller "
            "stride, or split_method='instance'.")
    if verbose:
        print(f"After chunking & splitting ({cfg.split_method}): "
              f"train={len(train_idx)}, val={len(val_idx)}, test={len(test_idx)}")
    loader = lambda idx, shuffle, seed=0: BatchIterator(ds.chunks, idx, cfg.batch_size,
                                                         collate_fn, shuffle=shuffle, seed=seed)
    return {
        "train_dataloader": loader(train_idx, True,
                                   cfg.seed if cfg.data_seed is None else cfg.data_seed),
        "val_dataloader": loader(val_idx, False),
        "test_dataloader": loader(test_idx, False) if test_idx else None,
        "input_dim": ds.input_dim,
        "time_max": time_max,
        "ds": ds,
        "cfg": cfg,
    }
