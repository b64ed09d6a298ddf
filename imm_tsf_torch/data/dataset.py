"""The `Chunk` sample record (after imm_tsf_tpu/data/dataset.py:36-54).

The CSV dataset and its chunker come with the training slice."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
