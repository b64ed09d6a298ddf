"""Masked error metrics and streaming evaluation (after
imm_tsf_tpu/training/evaluation.py:21-148).

The reference's metric math (lib/evaluation.py:17-69 compute_error,
:192-283 evaluation): masked MSE/MAE/MAPE with the two-stage reduction,
a per-variable mean over all (traj, batch, time) elements first, then the
mean over variables with at least one observation. Padding rows have a
zero mask, so they add nothing to the sums or the counts.

Under a data mesh (parallel/mesh.py) the loss and the metrics are the
global batch's: a mean of the ranks' means is wrong wherever their mask
counts differ (a padded last batch, sparse IMTS masks). Each rank divides
its error sums by the all-reduced counts (`masked_mse_loss(..., mesh)`),
so the ranks' losses, and their gradients, sum to the global ones; the
eval sums are all-reduced before the final reduction (`evaluation(...,
mesh)`).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def compute_error(truth, pred_y, mask, func: str, reduce: str, mesh=None):
    """truth [B,T,D]; pred_y [B,T,D] or [S,B,T,D]; mask [B,T,D].
    reduce="mean" -> scalar; reduce="sum" -> (error_var_sum [D], mask_count [D]).
    Under a data mesh, "mean" divides by the counts summed over the ranks:
    this rank's share of the global mean."""
    if pred_y.ndim == 3:
        pred_y = pred_y[None]
    truth = truth[None].expand(pred_y.shape)
    mask = mask[None].expand(pred_y.shape)
    if func == "MSE":
        error = (truth - pred_y) ** 2 * mask
    elif func == "MAE":
        error = (truth - pred_y).abs() * mask
    elif func == "MAPE":
        mask = (truth != 0).to(mask.dtype) * mask
        truth_div = truth + (truth == 0).to(truth.dtype) * 1e-8
        error = (truth - pred_y).abs() / truth_div * mask
    else:
        raise ValueError(f"Error function not specified: {func}")
    D = pred_y.shape[-1]
    error_var_sum = error.reshape(-1, D).sum(dim=0)
    mask_count = mask.reshape(-1, D).sum(dim=0)
    if reduce == "mean" and mesh is not None:
        mask_count = mesh.all_reduce_(mask_count.detach().clone())
    if reduce == "mean":
        error_var_avg = error_var_sum / (mask_count + 1e-8)
        return error_var_avg.sum() / torch.count_nonzero(mask_count)
    if reduce == "sum":
        return error_var_sum, mask_count
    raise ValueError("Reduce argument not specified!")


def masked_mse_loss(pred_y, truth, mask, mesh=None):
    """The training loss: two-stage masked MSE (lib/evaluation.py:107-156);
    under a data mesh the rank's share of the global batch's, which the
    ranks' gradient all-reduce sums."""
    return compute_error(truth, pred_y, mask, func="MSE", reduce="mean", mesh=mesh)


def batch_error_sums(pred_y, truth, mask) -> dict:
    """One eval step's per-variable error sums and counts for MSE / MAE /
    MAPE (lib/evaluation.py:226-257)."""
    se, cnt = compute_error(truth, pred_y, mask, "MSE", "sum")
    ae, _ = compute_error(truth, pred_y, mask, "MAE", "sum")
    ape, cnt_mape = compute_error(truth, pred_y, mask, "MAPE", "sum")
    return {"se": se, "ae": ae, "ape": ape, "cnt": cnt, "cnt_mape": cnt_mape}


def finalize_metrics(acc: dict) -> dict:
    """Final two-stage reduction over streamed sums (lib/evaluation.py:259-276)."""
    se, ae, ape, cnt, cnt_mape = (np.asarray(acc[k], np.float64)
                                  for k in ("se", "ae", "ape", "cnt", "cnt_mape"))
    n_avai = np.count_nonzero(cnt)
    n_avai_mape = np.count_nonzero(cnt_mape)
    if n_avai == 0:
        raise ValueError(
            "finalize_metrics: zero observed variables across the whole "
            "split — every prediction-window mask was empty (all-pad eval "
            "shard or broken mask plumbing)")
    mse = float((se / (cnt + 1e-8)).sum() / n_avai)
    mae = float((ae / (cnt + 1e-8)).sum() / n_avai)
    if n_avai_mape == 0:
        # every masked truth exactly zero: MAPE undefined, MSE/MAE still valid
        warnings.warn(
            "finalize_metrics: zero nonzero-truth observations across the "
            "whole split — MAPE is undefined (all ground-truth values are "
            "exactly zero under the mask); reporting MAPE=nan",
            RuntimeWarning, stacklevel=2)
        mape = float("nan")
    else:
        mape = float((ape / (cnt_mape + 1e-8)).sum() / n_avai_mape)
    return {"loss": mse, "mse": mse, "mae": mae, "rmse": float(np.sqrt(mse)), "mape": mape}


def evaluation(forecast_fn, dataloader, mesh=None) -> dict:
    """Streaming evaluation over a loader (lib/evaluation.py:192-283).
    forecast_fn(batch) -> (pred_y [B,Lp,D], truth, mask) as tensors of one
    device; the sums come to the host in float64 (under a data mesh summed
    over the ranks, whose rows forecast_fn predicts)."""
    acc = None
    for batch in dataloader:
        sums = batch_error_sums(*forecast_fn(batch))
        sums = {k: v.double().cpu().numpy() for k, v in sums.items()}
        if acc is None:
            acc = sums
        else:
            for k in acc:
                acc[k] += sums[k]
    if acc is None:
        raise ValueError("empty dataloader")
    return finalize_metrics(acc if mesh is None else mesh.all_reduce_sums(acc))
