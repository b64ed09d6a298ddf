"""Collate functions: ragged chunks -> static-shaped NumPy batch dicts.

The standard (MTS/LMTS) and CRU paths and the multimodal wrapper,
carried over from imm_tsf_tpu/data/collate.py unchanged (they are
host-side NumPy): batches are padded to dataset-level ceilings, the
notes axis to a small menu of bucket sizes. The ODE and patch collates
come with the slices that port those backbones.

Batch dict contract (keys identical to reference):
  observed_data [B, L, D], observed_tp [B, L], observed_mask,
  data_to_predict [B, Lp, D], tp_to_predict, mask_predicted_data,
  + multimodal keys: tau [B, N], notes_mask [B, N],
    notes_embeddings [B, N, d_txt] or notes_text List[List[str]].
"""

from __future__ import annotations

import numpy as np

from .dataset import Chunk

# Bucket sizes for dynamic axes (the notes axis here). A small fixed menu
# keeps the number of distinct batch shapes bounded.
_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
            1536, 2048, 3072, 4096)


def pad_to_bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(np.ceil(n / 1024) * 1024)


def normalize_tp(tp: np.ndarray, time_max: float) -> np.ndarray:
    """reference lib/utils.py:334-347 normalize_masked_tp with att_min=0."""
    scale = time_max if time_max != 0 else 1e-8
    return (tp / scale).astype(np.float32)


def _split_hist_pred(chunk: Chunk, history: float):
    hist = chunk.tt < history
    return (
        chunk.tt[hist], chunk.vals[hist], chunk.mask[hist],
        chunk.tt[~hist], chunk.vals[~hist], chunk.mask[~hist],
    )


def standard_collate(
    batch: list[Chunk], history: float, time_max: float, L_obs: int, L_pred: int
) -> dict:
    """Standard path (MTS/LMTS models), reference :252-295.

    tp normalized to [0,1] by history+pred_window; pads are zeros, exactly
    like the reference's pad_sequence + each model's subsequent zero-pad to
    input_len.
    """
    B = len(batch)
    D = batch[0].vals.shape[-1]
    out = {
        "observed_data": np.zeros((B, L_obs, D), np.float32),
        "observed_tp": np.zeros((B, L_obs), np.float32),
        "observed_mask": np.zeros((B, L_obs, D), np.float32),
        "data_to_predict": np.zeros((B, L_pred, D), np.float32),
        "tp_to_predict": np.zeros((B, L_pred), np.float32),
        "mask_predicted_data": np.zeros((B, L_pred, D), np.float32),
    }
    for i, c in enumerate(batch):
        htt, hv, hm, ptt, pv, pm = _split_hist_pred(c, history)
        if pm.sum() == 0:
            raise ValueError("Mask for batch is all zeros in collate_fn")
        n, p = len(htt), len(ptt)
        out["observed_tp"][i, :n] = normalize_tp(htt, time_max)
        out["observed_data"][i, :n] = hv
        out["observed_mask"][i, :n] = hm
        out["tp_to_predict"][i, :p] = normalize_tp(ptt, time_max)
        out["data_to_predict"][i, :p] = pv
        out["mask_predicted_data"][i, :p] = pm
    return out


def cru_collate(
    batch: list[Chunk], history: float, time_max: float, L_obs: int, L_pred: int
) -> dict:
    """CRU path, reference :369-408 — identical to standard but tp stays raw
    (chunk-relative units).

    TPU deviation: pad time entries REPEAT the last real time (the reference
    zero-pads to the batch max, which makes its Kalman recursion evolve the
    state backward through t=0 at pad positions — a batch-composition-
    dependent artifact). Repeat-padding makes every pad step an exact dt=0
    identity under the scan, independent of batch composition."""
    B = len(batch)
    D = batch[0].vals.shape[-1]
    out = {
        "observed_data": np.zeros((B, L_obs, D), np.float32),
        "observed_tp": np.zeros((B, L_obs), np.float32),
        "observed_mask": np.zeros((B, L_obs, D), np.float32),
        "data_to_predict": np.zeros((B, L_pred, D), np.float32),
        "tp_to_predict": np.zeros((B, L_pred), np.float32),
        "mask_predicted_data": np.zeros((B, L_pred, D), np.float32),
    }
    for i, c in enumerate(batch):
        htt, hv, hm, ptt, pv, pm = _split_hist_pred(c, history)
        n, p = len(htt), len(ptt)
        out["observed_tp"][i] = htt[-1] if n else 0.0
        out["observed_tp"][i, :n] = htt
        out["observed_data"][i, :n] = hv
        out["observed_mask"][i, :n] = hm
        out["tp_to_predict"][i] = ptt[-1] if p else 0.0
        out["tp_to_predict"][i, :p] = ptt
        out["data_to_predict"][i, :p] = pv
        out["mask_predicted_data"][i, :p] = pm
    return out


def add_multimodal(
    out: dict,
    batch: list[Chunk],
    enable_text: bool,
    use_text_embeddings: bool,
    N_max: int,
    d_txt: int,
) -> dict:
    """Multimodal wrapper, reference :764-826. Adds tau (+mask) and either
    notes_embeddings or notes_text."""
    B = len(batch)
    N = max(N_max, 1)
    tau = np.zeros((B, N), np.float32)
    notes_mask = np.zeros((B, N), np.float32)
    for i, c in enumerate(batch):
        n = len(c.note_times)
        tau[i, :n] = c.note_times
        notes_mask[i, :n] = 1.0
    out["tau"] = tau
    out["notes_mask"] = notes_mask
    if enable_text and not use_text_embeddings:
        out["notes_text"] = [[p for p in c.note_payloads] for c in batch]
    if enable_text and use_text_embeddings:
        emb = np.zeros((B, N, d_txt), np.float32)
        for i, c in enumerate(batch):
            for j, p in enumerate(c.note_payloads):
                emb[i, j] = p
        out["notes_embeddings"] = emb
    return out
