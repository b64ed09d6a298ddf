"""Chunked irregular-multimodal time-series dataset, host side (after
imm_tsf_tpu/data/dataset.py:25-352), written without pandas: the machine
with the card has none. CSVs are read with the `csv` module and
timestamps parsed as `numpy.datetime64` (ISO 8601, as pandas writes
them), with the JAX package's semantics:

  - per-record, per-feature z-score with the ddof = 1 std, each moment
    over the observed values; a feature whose std is 0 is centred only
    (and one with a single observation, whose std is NaN, turns NaN,
    as pandas' `if col.std()` lets it);
  - NaN goes into the mask;
  - times are units since the record's first stamp;
  - windows [st, st + history + pred) advance by stride while
    st + total <= t_max; a chunk needs >= 2 points and >= 1 observed
    value in both its history and its forecast window, and chunks with
    no note in the history window are dropped even when enable_text is
    off (reference lib/parse_datasets.py:174-237).

On-disk contract (reference README.md:41-53):
  root/processed/<record_id>/time_series.csv   date_time, [record_id], float features (NaN=missing)
  root/processed/<record_id>/text.csv          date_time + exactly one text column
  root/processed/<record_id>/text_embeddings_model={llm}_layers={n|full}_maxlen={L}.pt
      {"embeddings": [N_notes, d_txt], "rel_times": [N_notes]}  (.npz also accepted)

The windows of a record whose notes are sorted come from the native
two-pointer core (native/chunker.cpp, built with g++ at first use), as
in the JAX package; a record with unsorted notes takes the JAX package's
NumPy loop, which is also the oracle the tests hold the core to
(`ChunkedTimeSeriesDataset.native = False` runs it for every record).
Both compare window bounds against the times in their own precision (the
loop in float32, the core in float64), as the JAX package's two do; they
agree wherever a window bound is a float32 value, as with the dyadic
strides of the presets and the tests.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass

import numpy as np

from ..native import chunk_windows

UNIT_SECONDS = {
    # reference lib/parse_datasets.py:32-38
    "seconds": 1.0,
    "minutes": 60.0,
    "hours": 3600.0,
    "days": 86400.0,
    "weeks": 604800.0,
}
_NS = 1_000_000_000  # nanoseconds a second


@dataclass
class Chunk:
    """One sliding-window sample. tt is chunk-relative (tt - window_start)."""

    chunk_id: str
    tt: np.ndarray  # [L] float32, chunk-relative times
    vals: np.ndarray  # [L, D] float32, NaN->0
    mask: np.ndarray  # [L, D] float32 observation mask
    note_times: np.ndarray  # [N] float32, chunk-relative note times
    note_payloads: list  # list of str (raw) or np.ndarray[d_txt] (embeddings)

    @property
    def record_id(self) -> str:
        return self.chunk_id.rsplit("_chunk", 1)[0]

    @property
    def chunk_index(self) -> int:
        return int(self.chunk_id.rsplit("_chunk", 1)[1])


@dataclass
class ShapeBounds:
    """Static shape ceilings computed at build time."""

    max_obs_len: int = 0  # max #(tt < history) over chunks
    max_pred_len: int = 0  # max #(tt >= history) over chunks
    max_notes: int = 0  # max notes per chunk
    max_chunk_len: int = 0  # max total points per chunk
    d_txt: int = 0  # embedding dim (0 when raw text / no text)


def embeddings_filename(llm_model: str, llm_layers, max_length: int) -> str:
    """reference lib/parse_datasets.py:134-138 / compute_text_embeddings.py:56-60."""
    return (
        f"text_embeddings_model={llm_model}"
        f"_layers={llm_layers or 'full'}"
        f"_maxlen={max_length}.pt"
    )


def _load_embeddings_file(path: str, expect_unit: str | None = None):
    """Load {"embeddings": [N, d], "rel_times": [N]} from .pt or .npz
    (after imm_tsf_tpu/data/dataset.py:75-113). An artifact's
    ``time_unit`` field must equal ``expect_unit`` when given; artifacts
    without it stored days."""
    npz_path = path[:-3] + ".npz" if path.endswith(".pt") else path + ".npz"
    unit = None
    if os.path.isfile(path):
        import torch

        data = torch.load(path, map_location="cpu", weights_only=False)
        emb = np.asarray(data["embeddings"], dtype=np.float32)
        rel = np.asarray(data["rel_times"], dtype=np.float32)
        unit = data.get("time_unit")
    elif os.path.isfile(npz_path):
        data = np.load(npz_path)
        emb = data["embeddings"].astype(np.float32)
        rel = data["rel_times"].astype(np.float32)
        if "time_unit" in data.files:
            unit = str(data["time_unit"])
    else:
        raise FileNotFoundError(f"Missing text embeddings file: {path}")
    if np.isnan(emb).any():
        raise ValueError("text embeddings contains NaN values.")
    if expect_unit is not None and (unit or "days") != expect_unit:
        raise ValueError(
            f"{path}: embeddings artifact stores note rel_times in "
            f"{unit!r} but the dataset runs with time_unit={expect_unit!r}; "
            "recompute the embeddings in the dataset's preset unit.")
    return emb, rel


def _read_csv(path: str) -> tuple[list[str], list[list[str]]]:
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _stamps_ns(strings) -> np.ndarray:
    """ISO 8601 date-times -> int64 nanoseconds."""
    return np.array(strings, dtype="datetime64[ns]").astype(np.int64)


def _float(s: str) -> float:
    return float(s) if s.strip() else np.nan


def _zscore(col: np.ndarray) -> np.ndarray:
    """pandas' (col - col.mean()) / col.std() if col.std() else col - col.mean(),
    both moments over the observed values (NaN skipped), std with ddof = 1."""
    obs = ~np.isnan(col)
    n = int(obs.sum())
    if n == 0:
        return col - np.nan
    filled = np.where(obs, col, 0.0)
    mean = filled.sum() / n
    sq = np.where(obs, (mean - col) ** 2, 0.0)
    std = np.sqrt(sq.sum() / (n - 1)) if n > 1 else np.nan
    return (col - mean) / std if std else col - mean  # a NaN std is truthy, as in pandas


class ChunkedTimeSeriesDataset:
    """Loads every entity, normalizes, chunks into sliding windows."""

    native = True  # False: the NumPy loop for every record (the tests' oracle)

    def __init__(
        self,
        root: str,
        history: float,
        pred_window: float,
        stride: float,
        time_unit: str = "days",
        unit_scale: float | None = None,
        normalize: bool = True,
        enable_text: bool = False,
        use_text_embeddings: bool = False,
        llm_model_fusion: str | None = None,
        llm_layers_fusion: int | None = None,
        max_length: int = 1024,
        rec_ids: list[str] | None = None,
        verbose: bool = True,
    ):
        self.history = history
        self.pred_window = pred_window
        self.stride = stride
        self.enable_text = enable_text
        self.use_text_embeddings = use_text_embeddings

        if time_unit == "custom":
            if unit_scale is None:
                raise ValueError("Must set unit_scale when time_unit='custom'")
            self._sec_per_unit = float(unit_scale)
        else:
            try:
                self._sec_per_unit = UNIT_SECONDS[time_unit]
            except KeyError:
                raise ValueError(f"Unknown time_unit '{time_unit}'")

        proc_dir = os.path.join(root, "processed")
        all_recs = sorted(
            d for d in os.listdir(proc_dir) if os.path.isdir(os.path.join(proc_dir, d)))
        if rec_ids is not None:
            all_recs = list(rec_ids)

        raw_data = []
        self.feature_names: list[str] = []
        for rec in all_recs:
            ts_path = os.path.join(proc_dir, rec, "time_series.csv")
            if not os.path.isfile(ts_path):
                continue
            header, rows = _read_csv(ts_path)
            feat_idx = [i for i, c in enumerate(header) if c not in ("date_time", "record_id")]
            if not self.feature_names:
                self.feature_names = [header[i] for i in feat_idx]
            stamps = _stamps_ns([r[header.index("date_time")] for r in rows])
            order = np.argsort(stamps, kind="stable")
            stamps = stamps[order]
            vals = np.array([[_float(r[i]) for i in feat_idx] for r in rows],
                            dtype=np.float64).reshape(len(rows), len(feat_idx))[order]
            if normalize:
                vals = np.stack([_zscore(vals[:, j]) for j in range(vals.shape[1])], axis=1)
            tt = ((stamps - stamps.min()) / _NS / self._sec_per_unit).astype(np.float32)
            vals_np = vals.astype(np.float32)
            mask = (~np.isnan(vals_np)).astype(np.float32)
            vals_np = np.nan_to_num(vals_np)
            if mask.sum() == 0:
                raise ValueError(f"Mask for {rec} is all zeros")

            texts: list[tuple[float, object]] = []
            if use_text_embeddings and llm_model_fusion and enable_text:
                fname = embeddings_filename(llm_model_fusion, llm_layers_fusion, max_length)
                emb, rel = _load_embeddings_file(os.path.join(proc_dir, rec, fname),
                                                 expect_unit=time_unit)
                texts = [(float(rel[i]), emb[i]) for i in range(len(rel))]
            else:
                text_path = os.path.join(proc_dir, rec, "text.csv")
                if os.path.isfile(text_path):
                    theader, trows = _read_csv(text_path)
                    cols = [c for c in theader if c not in ("date_time", "record_id")]
                    if len(cols) != 1:
                        raise ValueError(f"{rec}: expected 1 text column, got {cols}")
                    t_at, x_at = theader.index("date_time"), theader.index(cols[0])
                    nstamps = _stamps_ns([r[t_at] for r in trows])
                    base = int(stamps.min())
                    for k in np.argsort(nstamps, kind="stable"):
                        txt = trows[k][x_at]
                        if txt == "":  # pandas reads an empty field as NaN
                            continue
                        t_rel = (int(nstamps[k]) - base) / _NS / self._sec_per_unit
                        texts.append((t_rel, txt))
            raw_data.append((rec, tt, vals_np, mask, texts))

        # --- chunking (reference :174-237; JAX :230-297) ---
        chunks: list[Chunk] = []
        for rec, tt, vals, mask, record_texts in raw_data:
            note_t = np.array([t for t, _ in record_texts], np.float64)
            if self.native and (len(note_t) == 0 or (np.diff(note_t) >= 0).all()):
                win = chunk_windows(tt.astype(np.float64), mask.sum(axis=1), note_t, history,
                                    pred_window, stride)  # the core needs sorted notes
                emitted, cnt, drop_count = self._emit_from_windows(
                    rec, tt, vals, mask, record_texts, win, enable_text)
            else:
                emitted, cnt, drop_count = self._loop_windows(rec, tt, vals, mask,
                                                              record_texts, enable_text)
            chunks.extend(emitted)
            if verbose and (cnt + drop_count) > 0:
                ratio = drop_count / (cnt + drop_count)
                print(f"Record {rec}: {cnt} chunks created, {drop_count} dropped ({ratio:.2%})")

        if not chunks:
            raise RuntimeError("No chunks created; check history/pred_window/stride")
        self.chunks = chunks
        self.input_dim = chunks[0].vals.shape[-1]
        self.bounds = self._compute_bounds()

    def _loop_windows(self, rec, tt, vals, mask, record_texts, enable_text):
        """The JAX package's NumPy loop over one record's windows: (chunks,
        chunks numbered, chunks dropped for want of a note)."""
        history, stride = self.history, self.stride
        total = history + self.pred_window
        chunks: list[Chunk] = []
        cnt = 0
        drop_count = 0
        t_max = float(tt.max())
        st = float(tt.min())
        while st + total <= t_max:
            idx = np.nonzero((tt >= st) & (tt < st + total))[0]
            if idx.size >= 2:
                sub_tt = tt[idx] - st
                sub_mask = mask[idx]
                if (sub_mask[sub_tt < history].sum() == 0
                        or sub_mask[sub_tt >= history].sum() == 0):
                    st += stride
                    continue
                hist_end = st + history
                selected = [(t - st, payload) for (t, payload) in record_texts
                            if st <= t < hist_end]
                chunk_id = f"{rec}_chunk{cnt}"
                cnt += 1
                # drop no-text chunks even when enable_text=False (:217-221)
                if len(selected) == 0:
                    drop_count += 1
                    st += stride
                    continue
                if enable_text:
                    note_times = np.array([t for t, _ in selected], np.float32)
                    payloads = [p for _, p in selected]
                else:
                    note_times = np.zeros((0,), dtype=np.float32)
                    payloads = []
                chunks.append(Chunk(chunk_id, sub_tt.astype(np.float32), vals[idx],
                                    sub_mask, note_times, payloads))
            st += stride
        return chunks, cnt, drop_count

    def _emit_from_windows(self, rec, tt, vals, mask, record_texts, win, enable_text):
        """Chunk objects from the native core's windows of one record, with
        the loop's chunk numbering and drop rule (JAX :300-332): (chunks,
        chunks numbered, chunks dropped for want of a note)."""
        chunks: list[Chunk] = []
        cnt = 0
        drop_count = 0
        st = float(tt.min())
        for w in range(len(win["starts"])):
            if win["valid"][w]:
                cnt += 1
                if not win["has_text"][w]:
                    drop_count += 1
                else:
                    lo, hi = int(win["starts"][w]), int(win["ends"][w])
                    sub_tt = (tt[lo:hi] - np.float32(st)).astype(np.float32)
                    if enable_text:
                        sel = record_texts[int(win["note_lo"][w]):int(win["note_hi"][w])]
                        note_times = np.array([t - st for t, _ in sel], np.float32)
                        payloads = [p for _, p in sel]
                    else:
                        note_times = np.zeros((0,), np.float32)
                        payloads = []
                    chunks.append(Chunk(f"{rec}_chunk{cnt - 1}", sub_tt, vals[lo:hi],
                                        mask[lo:hi], note_times, payloads))
            st += self.stride
        return chunks, cnt, drop_count

    def _compute_bounds(self) -> ShapeBounds:
        b = ShapeBounds()
        for c in self.chunks:
            n_obs = int((c.tt < self.history).sum())
            b.max_obs_len = max(b.max_obs_len, n_obs)
            b.max_pred_len = max(b.max_pred_len, len(c.tt) - n_obs)
            b.max_chunk_len = max(b.max_chunk_len, len(c.tt))
            b.max_notes = max(b.max_notes, len(c.note_times))
            for p in c.note_payloads:
                if isinstance(p, np.ndarray):
                    b.d_txt = max(b.d_txt, p.shape[-1])
        return b

    def __len__(self) -> int:
        return len(self.chunks)

    def __getitem__(self, idx: int) -> Chunk:
        return self.chunks[idx]
