"""The port's native chunker (imm_tsf_torch/native/) on the CPU.

- `chunk_windows` gives the JAX binding's windows exactly, and the
  windows of a plain per-window scan, with notes, without any, and with
  strides shorter than the window;
- its library is built by g++ into `imm_tsf_torch/_build/`, never next
  to the source or the JAX package's, and a failed build raises;
- the dataset's chunks through the core equal the NumPy loop's
  (`ChunkedTimeSeriesDataset.native = False`) bit for bit, and the JAX
  package's dataset's, on the JAX generator's fixture (dropped windows
  and windows of fewer than two points among them), and a record whose
  notes are unsorted takes the loop.
"""

import os

import numpy as np
import pytest
import torch

from imm_tsf_tpu.data.dataset import ChunkedTimeSeriesDataset as JDataset
from imm_tsf_tpu.native import chunk_windows as j_chunk_windows

import imm_tsf_torch.data.dataset as dsmod
from imm_tsf_torch.data.dataset import ChunkedTimeSeriesDataset as TDataset
from imm_tsf_torch.data.synthetic import _stamps, _write_csv
from imm_tsf_torch.kernels import _build
from imm_tsf_torch.native import chunk_windows

torch.set_num_threads(1)

KEYS = ("starts", "ends", "hist_ends", "valid", "has_text", "note_lo", "note_hi")


def _scan(tt, rowsum, note_t, history, pred, stride):
    """Each window's (valid, has_text, and for a valid one its point range),
    by masks over every point (tests/test_native_chunker.py's reference)."""
    st, rows = float(tt.min()), []
    while st + history + pred <= float(tt.max()):
        idx = np.nonzero((tt >= st) & (tt < st + history + pred))[0]
        hist = tt[idx] - st < history
        valid = idx.size >= 2 and rowsum[idx][hist].sum() > 0 and rowsum[idx][~hist].sum() > 0
        has_text = bool(((note_t >= st) & (note_t < st + history)).any())
        rows.append((valid, has_text, (idx[0], idx[-1] + 1) if valid else None))
        st += stride
    return rows


@pytest.mark.parametrize("seed, stride, n_notes", [(0, 7.0, 40), (1, 3.5, 40), (2, 1.75, 40),
                                                    (3, 7.0, 0), (4, 0.5, 3)])
def test_windows_equal_the_jax_binding_and_a_plain_scan(seed, stride, n_notes):
    rng = np.random.default_rng(seed)
    tt = np.sort(np.concatenate([rng.uniform(0, 40, 150), rng.uniform(60, 100, 150)]))  # a gap
    rowsum = (rng.random(300) > 0.3) * rng.integers(1, 4, 300).astype(np.float64)
    note_t = np.sort(rng.uniform(0, 100, n_notes))
    got = chunk_windows(tt, rowsum, note_t, 7.0, 7.0, stride)
    want = j_chunk_windows(tt, rowsum, note_t, 7.0, 7.0, stride)
    assert want is not None  # the JAX package's g++ build
    for k in KEYS:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    ref = _scan(tt, rowsum, note_t, 7.0, 7.0, stride)
    assert len(got["starts"]) == len(ref) > 0
    for w, (valid, has_text, span) in enumerate(ref):
        assert got["valid"][w] == valid and got["has_text"][w] == has_text, w
        if valid:
            assert (got["starts"][w], got["ends"][w]) == span, w
    assert got["valid"].any() and not got["valid"].all()  # windows of < 2 points or no values
    if n_notes == 0:
        assert not got["has_text"].any()
    empty = chunk_windows(np.zeros(0), np.zeros(0), note_t, 7.0, 7.0, stride)
    assert all(len(empty[k]) == 0 for k in KEYS)


def test_library_builds_into_the_ports_build_directory():
    jax_so = os.path.join(os.path.dirname(os.path.abspath(j_chunk_windows.__code__.co_filename)),
                          "_chunker.so")
    before = os.path.getmtime(jax_so) if os.path.exists(jax_so) else None
    chunk_windows(np.arange(30.0), np.ones(30), np.array([1.0]), 3.0, 3.0, 1.0)
    path = _build.library_path("chunker")
    assert path.exists() and path.parent.parent == _build.BUILD_ROOT
    assert _build.BUILD_ROOT.name == "_build" and _build.BUILD_ROOT.parent.name == "imm_tsf_torch"
    assert not any(f.endswith(".so") for f in os.listdir(_build.HOST_SOURCES["chunker"].parent))
    assert (os.path.getmtime(jax_so) if os.path.exists(jax_so) else None) == before


def test_failed_build_raises(tmp_path, monkeypatch):
    """No fallback to the loop: a compiler that fails is an error."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_gxx", lambda: "false")
    with pytest.raises(RuntimeError, match="false failed for .*chunker.cpp"):
        chunk_windows(np.arange(30.0), np.ones(30), np.array([1.0]), 3.0, 3.0, 1.0)
    assert not list((tmp_path / "_build").glob("*/*.so"))


def _assert_same_chunks(got, want):
    assert len(got.chunks) == len(want.chunks) > 0
    assert vars(got.bounds) == vars(want.bounds)
    for g, w in zip(got.chunks, want.chunks):
        assert g.chunk_id == w.chunk_id
        for k in ("tt", "vals", "mask", "note_times"):
            a, b = getattr(g, k), getattr(w, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), (g.chunk_id, k)
        assert len(g.note_payloads) == len(w.note_payloads)
        assert all(np.array_equal(a, b) for a, b in zip(g.note_payloads, w.note_payloads))


@pytest.fixture
def native_calls(monkeypatch):
    calls = []

    def counted(*args):
        calls.append(args)
        return chunk_windows(*args)

    monkeypatch.setattr(dsmod, "chunk_windows", counted)
    return calls


def _build_three(kw, monkeypatch, native_calls):
    """The port's dataset through the core, through the loop, and the JAX
    package's; how many records took the core."""
    native = TDataset(**kw)
    n_native = len(native_calls)
    monkeypatch.setattr(TDataset, "native", False)
    loop = TDataset(**kw)
    assert len(native_calls) == n_native
    return native, loop, JDataset(**kw), n_native


@pytest.mark.parametrize("history, stride, text", [(7, 7, True), (7, 3.5, False),
                                                   (1, 0.5, True), (2, 0.25, False)])
def test_dataset_chunks_equal_the_loop_and_the_jax_dataset(synth_root, monkeypatch,
                                                           native_calls, history, stride, text):
    """The conftest fixture (4 entities, 120 days, GPT-2 note embeddings):
    history 1 and 2 meet windows the core marks invalid and drop windows
    without a note."""
    kw = dict(root=os.path.join(synth_root, "EPA-Air"), history=history, pred_window=history,
              stride=stride, time_unit="days", enable_text=text, use_text_embeddings=True,
              llm_model_fusion="GPT2", llm_layers_fusion=6, max_length=1024, verbose=False)
    native, loop, jax_ds, n_native = _build_three(kw, monkeypatch, native_calls)
    assert n_native == 4  # every record's notes are sorted
    _assert_same_chunks(native, loop)
    _assert_same_chunks(native, jax_ds)
    if history <= 2:
        wins = [chunk_windows(*a) for a in native_calls]
        assert any((~w["valid"]).any() for w in wins)  # < 2 points, or no value in a part
        assert any((w["valid"] & ~w["has_text"]).any() for w in wins)  # dropped: no note


def test_unsorted_notes_take_the_loop(tmp_path, monkeypatch, native_calls):
    """Record a's note embeddings are stored out of time order (the core
    needs sorted notes), record b has none at all: a takes the loop, b the
    core, and both packages give the same chunks."""
    root = tmp_path / "EPA-Air"
    rng = np.random.default_rng(0)
    fname = "text_embeddings_model=GPT2_layers=6_maxlen=1024.npz"
    for rec, note_t in (("a", np.array([9.5, 2.25, 30.0, 16.0, 2.5, 23.0])),
                        ("b", np.zeros(0))):
        d = root / "processed" / rec
        os.makedirs(d)
        t = np.concatenate([np.arange(0, 20, 0.25), np.arange(24, 40, 0.5)])  # a gap
        vals = rng.standard_normal((len(t), 2))
        vals[rng.random(vals.shape) < 0.3] = np.nan
        _write_csv(str(d / "time_series.csv"), ["date_time", "f0", "f1"],
                   [[s] + ["" if np.isnan(v) else repr(float(v)) for v in row]
                    for s, row in zip(_stamps(t, "days"), vals)])
        np.savez(d / fname, embeddings=rng.standard_normal((len(note_t), 4)).astype(np.float32),
                 rel_times=note_t.astype(np.float32))
    kw = dict(root=str(root), history=4, pred_window=4, stride=2, time_unit="days",
              enable_text=True, use_text_embeddings=True, llm_model_fusion="GPT2",
              llm_layers_fusion=6, max_length=1024, verbose=False)
    native, loop, jax_ds, n_native = _build_three(kw, monkeypatch, native_calls)
    assert n_native == 1 and len(native_calls[0][2]) == 0  # only b's (empty) notes
    _assert_same_chunks(native, loop)
    _assert_same_chunks(native, jax_ds)
    assert {c.record_id for c in native.chunks} == {"a"}  # b's windows all dropped
