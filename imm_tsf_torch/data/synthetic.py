"""Synthetic dataset generator matching the on-disk contract (after
imm_tsf_tpu/data/synthetic.py), written without pandas.

Writes `processed/<entity>/time_series.csv`, `text.csv` and the
precomputed-embedding artifact (`torch.save`), making the JAX
generator's numpy draws in the same order, so the values, times and
embeddings written are the JAX generator's. Time stamps are ISO 8601
with nanoseconds; both packages' datasets parse the files to the same
chunks.
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from .dataset import UNIT_SECONDS, embeddings_filename

_BASE = np.datetime64("2024-01-01T00:00:00", "ns")


def _stamps(t: np.ndarray, time_unit: str) -> list[str]:
    """Float offsets in `time_unit` from 2024-01-01 -> ISO 8601 strings."""
    ns = np.round(t * UNIT_SECONDS[time_unit] * 1e9).astype(np.int64)
    return list(np.datetime_as_string(_BASE + ns.astype("timedelta64[ns]"), unit="ns"))


def _write_csv(path: str, header: list[str], rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def make_synthetic_dataset(
    root: str,
    n_entities: int = 4,
    n_features: int = 3,
    n_days: int = 120,
    obs_per_day: float = 2.0,
    missing_rate: float = 0.3,
    notes_per_day: float = 0.7,
    d_txt: int = 16,
    with_embeddings: bool = True,
    llm_model: str = "GPT2",
    llm_layers=6,
    max_length: int = 1024,
    seed: int = 0,
    time_unit: str = "days",
    record_id_col: bool = False,
) -> str:
    """Create `root/processed/...`; returns root. n_days, obs_per_day and
    notes_per_day are in `time_unit` units (days, hours or weeks)."""
    rng = np.random.default_rng(seed)
    proc = os.path.join(root, "processed")
    os.makedirs(proc, exist_ok=True)
    for e in range(n_entities):
        name = f"entity{e:03d}"
        ent_dir = os.path.join(proc, name)
        os.makedirs(ent_dir, exist_ok=True)
        n_obs = max(int(n_days * obs_per_day), 8)
        # irregular timestamps, sorted unique
        t = np.sort(rng.uniform(0, n_days, n_obs))
        t = np.unique(np.round(t, 4))
        n_obs = len(t)
        freqs = rng.uniform(0.05, 0.5, n_features)
        phases = rng.uniform(0, np.pi, n_features)
        vals = (
            np.sin(t[:, None] * freqs[None] * 2 * np.pi + phases[None])
            + 0.1 * rng.standard_normal((n_obs, n_features))
            + rng.uniform(-2, 2, n_features)[None]
        )
        miss = rng.random((n_obs, n_features)) < missing_rate
        vals = vals.astype(np.float64)
        vals[miss] = np.nan
        # each row keeps at least one observation so chunks are valid
        all_missing = miss.all(axis=1)
        vals[all_missing, 0] = rng.standard_normal(all_missing.sum())
        header = ["date_time"] + (["record_id"] if record_id_col else []) + [
            f"f{i}" for i in range(n_features)]
        rows = [[stamp] + ([name] if record_id_col else [])
                + ["" if np.isnan(v) else repr(float(v)) for v in row]
                for stamp, row in zip(_stamps(t, time_unit), vals)]
        _write_csv(os.path.join(ent_dir, "time_series.csv"), header, rows)

        n_notes = max(int(n_days * notes_per_day), 4)
        nt = np.sort(rng.uniform(0, n_days, n_notes))
        notes = [f"note {e}-{i}: sensor reading discussed." for i in range(n_notes)]
        _write_csv(os.path.join(ent_dir, "text.csv"), ["date_time", "note"],
                   zip(_stamps(nt, time_unit), notes))

        if with_embeddings:
            # rel_times from the first numeric time stamp, in the dataset's own unit
            rel = nt - t[0]
            emb = rng.standard_normal((n_notes, d_txt)).astype(np.float32)
            torch.save({"embeddings": torch.from_numpy(emb),
                        "rel_times": torch.from_numpy(rel.astype(np.float32)),
                        "time_unit": time_unit},
                       os.path.join(ent_dir, embeddings_filename(llm_model, llm_layers,
                                                                 max_length)))
    return root
