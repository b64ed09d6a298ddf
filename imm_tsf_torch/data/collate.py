"""Collate functions: ragged chunks -> static-shaped NumPy batch dicts.

All four paths of imm_tsf_tpu/data/collate.py and the multimodal
wrapper, carried over unchanged (they are host-side NumPy): the standard
(MTS/LMTS) and CRU batches are padded to dataset-level ceilings; the ODE
collate (LatentODE) and the patch collate (tPatchGNN) build the batch's
union time axis and pad it, and the notes axis, to a small menu of
bucket sizes.

Batch dict contract (keys identical to reference):
  observed_data [B, L, D], observed_tp [B, L], observed_mask,
  data_to_predict [B, Lp, D], tp_to_predict, mask_predicted_data,
  (the ODE path: observed_tp [L] and tp_to_predict [Lp] shared by the
  batch, and the int n_observed_tp; the patch path: observed_{data,tp,mask}
  [B, npatch, L, D])
  + multimodal keys: tau [B, N], notes_mask [B, N],
    notes_embeddings [B, N, d_txt] or notes_text List[List[str]].
"""

from __future__ import annotations

import numpy as np

from .dataset import Chunk

# Bucket sizes for dynamic axes (the notes axis, the ODE / patch collates'
# union-time axes). A small fixed menu keeps the number of distinct batch
# shapes bounded.
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


def ode_collate(batch: list[Chunk], history: float, time_max: float,
                t_obs_cap: int | None = None,
                t_pred_cap: int | None = None) -> dict:
    """LatentODE path, reference :411-471.

    Builds one global sorted-unique time axis for the whole batch, scatters
    values/masks onto it, normalizes, adds idx*eps jitter for strict
    monotonicity, splits at n_obs = #(t < history).

    TPU redesign: the observed/predicted unions are padded to bucket sizes.
    Pad time entries REPEAT the final real time so a fixed-step ODE solve
    over them is the identity (dt=0); their masks are zero everywhere.

    t_obs_cap / t_pred_cap: optional FIXED axis lengths instead of the
    dynamic buckets — the JAX package's AOT export (its export.py) pins the
    union axes to static ceilings so one compiled program serves any batch
    content. No caller in the port sets them.
    Padding semantics are identical to the bucket pads (dt=0 repeats,
    zero masks), so results at real rows match the bucketed program.
    Raises when the actual union exceeds a cap.
    """
    all_tt = np.concatenate([c.tt for c in batch])
    combined_raw = np.unique(all_tt)  # sorted unique
    n_obs = int((combined_raw < history).sum())
    T = len(combined_raw)
    B = len(batch)
    D = batch[0].vals.shape[-1]

    combined_vals = np.zeros((B, T, D), np.float32)
    combined_mask = np.zeros((B, T, D), np.float32)
    for b, c in enumerate(batch):
        idx = np.searchsorted(combined_raw, c.tt)
        combined_vals[b, idx] = c.vals
        combined_mask[b, idx] = c.mask

    combined_tt = normalize_tp(combined_raw, time_max)
    # strict-monotonicity jitter (reference :450-454)
    eps = np.finfo(np.float32).eps * time_max
    combined_tt = combined_tt + np.arange(T, dtype=np.float32) * eps

    if t_obs_cap is not None:
        if n_obs > t_obs_cap:
            raise ValueError(
                f"ode_collate: {n_obs} union observed times exceed the "
                f"static cap {t_obs_cap} (re-export with a larger cap or "
                f"split the batch)")
        T_obs = t_obs_cap
    else:
        T_obs = pad_to_bucket(max(n_obs, 1))
    if t_pred_cap is not None:
        if T - n_obs > t_pred_cap:
            raise ValueError(
                f"ode_collate: {T - n_obs} union forecast times exceed the "
                f"static cap {t_pred_cap} (re-export with a larger cap or "
                f"split the batch)")
        T_pred = t_pred_cap
    else:
        T_pred = pad_to_bucket(max(T - n_obs, 1))

    def pad_times(t: np.ndarray, L: int) -> np.ndarray:
        out = np.full((L,), t[-1] if len(t) else 0.0, np.float32)
        out[: len(t)] = t
        return out

    def pad_grid(x: np.ndarray, L: int) -> np.ndarray:
        out = np.zeros((B, L, D), np.float32)
        out[:, : x.shape[1]] = x
        return out

    return {
        "observed_tp": pad_times(combined_tt[:n_obs], T_obs),
        "tp_to_predict": pad_times(combined_tt[n_obs:], T_pred),
        "observed_data": pad_grid(combined_vals[:, :n_obs], T_obs),
        "data_to_predict": pad_grid(combined_vals[:, n_obs:], T_pred),
        "observed_mask": pad_grid(combined_mask[:, :n_obs], T_obs),
        "mask_predicted_data": pad_grid(combined_mask[:, n_obs:], T_pred),
        "n_observed_tp": n_obs,
    }


def patch_collate(
    batch: list[Chunk],
    history: float,
    time_max: float,
    L_pred: int,
    patch_size: float,
    patch_stride: float,
    npatch: int,
    max_patch_len: int | None = None,
) -> dict:
    """tPatchGNN path, reference :298-366 + lib/utils.py:359-413.

    Produces compacted per-(batch, patch, feature) sequences of observed
    points: observed_{tp,data,mask} all [B, npatch, Lp_max, D], where only
    the first L observed points per (b, patch, feature) are filled (mask=1)
    and the rest are zeros — numerically identical to the reference's
    gather-based construction, built directly on host.
    """
    B = len(batch)
    D = batch[0].vals.shape[-1]

    # union observed-time axis (reference :321-341)
    obs = [(c.tt[c.tt < history], c.vals[c.tt < history], c.mask[c.tt < history]) for c in batch]
    non_empty = [t for t, _, _ in obs if len(t)]
    combined_tt = np.unique(np.concatenate(non_empty)) if non_empty else np.zeros((0,), np.float32)
    n_pts = len(combined_tt)
    combined_vals = np.zeros((B, n_pts, D), np.float32)
    combined_mask = np.zeros((B, n_pts, D), np.float32)
    for b, (t, v, m) in enumerate(obs):
        if len(t):
            idx = np.searchsorted(combined_tt, t)
            combined_vals[b, idx] = v
            combined_mask[b, idx] = m

    norm_tt = normalize_tp(combined_tt, time_max)

    # per-patch index windows on the UN-normalized axis (reference :346-357)
    windows = []
    for i in range(npatch):
        st = i * patch_stride
        ed = st + patch_size
        if i == npatch - 1:
            sel = (combined_tt >= st) & (combined_tt < history)
        else:
            sel = (combined_tt >= st) & (combined_tt < ed)
        windows.append(np.nonzero(sel)[0])

    # max observed count per (batch, patch, feature) -> Lp ceiling
    need = 1
    for w in windows:
        if len(w) == 0:
            continue
        st_i, ed_i = w[0], w[-1]
        need = max(need, int(combined_mask[:, st_i : ed_i + 1].sum(axis=1).max()))
    if max_patch_len is not None and need > max_patch_len:
        # mirror ode_collate's cap semantics: a stale/hand-tuned exported
        # cap must fail with the actionable message, not a numpy
        # broadcast error deep in the fill loop
        raise ValueError(
            f"patch_collate: {need} observed points per (batch, patch, "
            f"feature) exceed the static cap {max_patch_len} (re-export "
            "with a larger cap or split the batch)")
    Lp = max_patch_len if max_patch_len is not None else pad_to_bucket(need)

    tp_p = np.zeros((B, npatch, Lp, D), np.float32)
    val_p = np.zeros((B, npatch, Lp, D), np.float32)
    mask_p = np.zeros((B, npatch, Lp, D), np.float32)
    for i, w in enumerate(windows):
        if len(w) == 0:
            continue
        st_i, ed_i = w[0], w[-1]
        seg_mask = combined_mask[:, st_i : ed_i + 1]  # [B, S, D]
        seg_vals = combined_vals[:, st_i : ed_i + 1]
        seg_tt = norm_tt[st_i : ed_i + 1]  # [S]
        for b in range(B):
            for d in range(D):
                pos = np.nonzero(seg_mask[b, :, d])[0]
                L = len(pos)
                if L == 0:
                    continue
                tp_p[b, i, :L, d] = seg_tt[pos]
                val_p[b, i, :L, d] = seg_vals[b, pos, d]
                mask_p[b, i, :L, d] = 1.0

    out = {
        "observed_tp": tp_p,
        "observed_data": val_p,
        "observed_mask": mask_p,
        "data_to_predict": np.zeros((B, L_pred, D), np.float32),
        "tp_to_predict": np.zeros((B, L_pred), np.float32),
        "mask_predicted_data": np.zeros((B, L_pred, D), np.float32),
    }
    for b, c in enumerate(batch):
        pt = c.tt[c.tt >= history]
        pv = c.vals[c.tt >= history]
        pm = c.mask[c.tt >= history]
        p = len(pt)
        out["tp_to_predict"][b, :p] = normalize_tp(pt, time_max)
        out["data_to_predict"][b, :p] = pv
        out["mask_predicted_data"][b, :p] = pm
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
