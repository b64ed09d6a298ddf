"""Native (C++) host components, bound via ctypes (after
imm_tsf_tpu/native/__init__.py).

`chunk_windows` is the dataset build's sliding-window scan (reference
lib/parse_datasets.py:174-237 rescans all timestamps per window; the C++
core `chunker.cpp` is two-pointer O(T + W)). Its library is built with
`g++ -O3 -shared -fPIC` by kernels/_build.py into `imm_tsf_torch/_build/`
at first use. One departure from the JAX binding, which returns None when
the build fails and lets the caller fall back to the NumPy loop: here a
failed build raises, as every build of the port does.
"""

from __future__ import annotations

import ctypes

import numpy as np

_SIGNATURES = {"chunk_windows": ([
    ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
    ctypes.c_double, ctypes.c_double, ctypes.c_double,
    ctypes.c_int64,
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_int64),
    ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
    ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
], ctypes.c_int64)}


def chunk_windows(tt, mask_rowsum, note_t, history, pred_window, stride) -> dict:
    """The windows [st, st + history + pred_window) of one record, st from
    tt[0] by `stride`: dict of per-window arrays starts, ends (the point
    index range), hist_ends (the first point at or past st + history),
    valid (>= 2 points, >= 1 observed value in each part), has_text (>= 1
    note in the history part), note_lo and note_hi (its note index range).
    tt and note_t must be sorted ascending."""
    from ..kernels import _build

    lib = _build.load("chunker", _SIGNATURES)
    tt = np.ascontiguousarray(tt, np.float64)
    ms = np.ascontiguousarray(mask_rowsum, np.float64)
    nt = np.ascontiguousarray(note_t, np.float64)
    n, m = len(tt), len(nt)
    if n == 0:
        return dict(starts=np.zeros(0, np.int64), ends=np.zeros(0, np.int64),
                    hist_ends=np.zeros(0, np.int64), valid=np.zeros(0, bool),
                    has_text=np.zeros(0, bool), note_lo=np.zeros(0, np.int64),
                    note_hi=np.zeros(0, np.int64))
    span = float(tt[-1] - tt[0])
    max_w = int(max(span - (history + pred_window), 0) / stride) + 2
    starts = np.zeros(max_w, np.int64)
    ends = np.zeros(max_w, np.int64)
    hist_ends = np.zeros(max_w, np.int64)
    valid = np.zeros(max_w, np.uint8)
    has_text = np.zeros(max_w, np.uint8)
    note_lo = np.zeros(max_w, np.int64)
    note_hi = np.zeros(max_w, np.int64)
    p = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    w = lib.chunk_windows(
        p(tt, ctypes.c_double), p(ms, ctypes.c_double), n,
        p(nt, ctypes.c_double), m,
        float(history), float(pred_window), float(stride), max_w,
        p(starts, ctypes.c_int64), p(ends, ctypes.c_int64),
        p(hist_ends, ctypes.c_int64),
        p(valid, ctypes.c_uint8), p(has_text, ctypes.c_uint8),
        p(note_lo, ctypes.c_int64), p(note_hi, ctypes.c_int64),
    )
    return dict(
        starts=starts[:w], ends=ends[:w], hist_ends=hist_ends[:w],
        valid=valid[:w].astype(bool), has_text=has_text[:w].astype(bool),
        note_lo=note_lo[:w], note_hi=note_hi[:w],
    )
