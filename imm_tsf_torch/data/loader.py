"""Host-side batch helpers (after imm_tsf_tpu/data/loader.py).

Only the batch-axis padding the serving path needs is ported so far; the
dataset construction and the iterators come with the training slice."""

from __future__ import annotations

import numpy as np


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
