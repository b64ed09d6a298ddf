"""The IMTS collates and their loader dispatch, the port against the JAX
package, on the CPU: every key equal exactly (np.array_equal and the
dtype).

- `ode_collate` (LatentODE): the batch's sorted-unique union time axis,
  the idx * eps * time_max jitter, the split at n_obs, pads to buckets
  that repeat the last real time (dt = 0 steps), fixed caps, and the
  ValueError past a cap; a batch with no history at all;
- `patch_collate` (tPatchGNN): windows on the un-normalized axis, the last
  patch running to `history`, overlapping patches, `max_patch_len` and its
  ValueError; a batch with no observation;
- `parse_datasets` for tPatchGNN (finalize_patching), LatentODE and
  NeuralFlow: the resolved config and the first batches of each split.
"""

import itertools

import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data import collate as JC
from imm_tsf_tpu.data.dataset import Chunk as JChunk
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.data import collate as TC
from imm_tsf_torch.data.dataset import Chunk as TChunk
from imm_tsf_torch.data.loader import parse_datasets

torch.set_num_threads(1)

HISTORY, TIME_MAX, D = 7.0, 14.0, 3


def _chunks(seed: int, B: int = 5, empty_history: bool = False):
    """Ragged chunks on a coarse grid (so times repeat across the batch),
    a third of the values unobserved; one chunk with no history when
    asked. -> (port chunks, JAX chunks)."""
    rng = np.random.default_rng(seed)
    grid = np.round(np.linspace(0, TIME_MAX, 57), 4).astype(np.float32)
    t_chunks, j_chunks = [], []
    for b in range(B):
        n = int(rng.integers(3, 20))
        tt = np.sort(rng.choice(grid, n, replace=False)).astype(np.float32)
        if empty_history and b == 1:
            tt = tt[tt >= HISTORY]
        vals = rng.standard_normal((len(tt), D)).astype(np.float32)
        mask = (rng.random((len(tt), D)) < 0.67).astype(np.float32)
        args = (f"rec{b}_chunk0", tt, vals * mask, mask, np.zeros(0, np.float32), [])
        t_chunks.append(TChunk(*args))
        j_chunks.append(JChunk(*args))
    return t_chunks, j_chunks


def _assert_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), k
        else:
            assert type(g) is type(w) and g == w, k


@pytest.mark.parametrize("seed, caps, empty", [(0, None, False), (1, (32, 48), False),
                                               (2, None, True), (3, (24, 24), True)])
def test_ode_collate_matches_jax_exactly(seed, caps, empty):
    tc, jc = _chunks(seed, empty_history=empty)
    kw = {} if caps is None else dict(t_obs_cap=caps[0], t_pred_cap=caps[1])
    got = TC.ode_collate(tc, HISTORY, TIME_MAX, **kw)
    want = JC.ode_collate(jc, HISTORY, TIME_MAX, **kw)
    _assert_equal(got, want)
    n_obs, t_obs = got["n_observed_tp"], got["observed_tp"]
    assert isinstance(n_obs, int)
    assert (np.diff(t_obs[:n_obs]) > 0).all()  # strictly increasing after the jitter
    assert (t_obs[n_obs:] == t_obs[n_obs - 1]).all()  # pads repeat the last real time
    assert not got["observed_mask"][:, n_obs:].any()
    if caps is not None:
        assert t_obs.shape == (caps[0],) and got["tp_to_predict"].shape == (caps[1],)


def test_ode_collate_cap_exceeded_raises_as_jax():
    tc, jc = _chunks(4)
    n_obs = JC.ode_collate(jc, HISTORY, TIME_MAX)["n_observed_tp"]
    n_pred = len(np.unique(np.concatenate([c.tt for c in jc]))) - n_obs
    for kw in (dict(t_obs_cap=n_obs - 1), dict(t_pred_cap=n_pred - 1)):
        with pytest.raises(ValueError) as want:
            JC.ode_collate(jc, HISTORY, TIME_MAX, **kw)
        with pytest.raises(ValueError) as got:
            TC.ode_collate(tc, HISTORY, TIME_MAX, **kw)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("patch_size, patch_stride, npatch, cap",
                         [(2.0, 2.0, 4, None), (3.0, 2.0, 3, None), (2.0, 2.0, 4, 24),
                          (7.0, 7.0, 1, None)])
def test_patch_collate_matches_jax_exactly(patch_size, patch_stride, npatch, cap):
    tc, jc = _chunks(5)
    args = (HISTORY, TIME_MAX, 12, patch_size, patch_stride, npatch)
    got = TC.patch_collate(tc, *args, max_patch_len=cap)
    want = JC.patch_collate(jc, *args, max_patch_len=cap)
    _assert_equal(got, want)
    assert got["observed_data"].shape[:2] == (len(tc), npatch)
    assert got["observed_mask"][:, -1].any()  # the last patch runs to history


def test_patch_collate_edges_match_jax():
    tc, jc = _chunks(6, empty_history=True)
    args = (HISTORY, TIME_MAX, 12, 2.0, 2.0, 4)
    with pytest.raises(ValueError) as want:
        JC.patch_collate(jc, *args, max_patch_len=1)
    with pytest.raises(ValueError) as got:
        TC.patch_collate(tc, *args, max_patch_len=1)
    assert str(got.value) == str(want.value)
    # no observation in the whole batch: every patch empty
    tc = [TChunk(c.chunk_id, c.tt[c.tt >= HISTORY], c.vals[c.tt >= HISTORY],
                 c.mask[c.tt >= HISTORY], c.note_times, c.note_payloads) for c in tc]
    jc = [JChunk(*(getattr(c, f) for f in ("chunk_id", "tt", "vals", "mask", "note_times",
                                           "note_payloads"))) for c in tc]
    got, want = TC.patch_collate(tc, *args), JC.patch_collate(jc, *args)
    _assert_equal(got, want)
    assert not got["observed_mask"].any()


@pytest.mark.parametrize("model, over", [("tPatchGNN", dict(patch_size=2)),
                                         ("tPatchGNN", dict(patch_size=2, npatch=4)),
                                         ("LatentODE", {}), ("NeuralFlow", {})])
def test_parse_datasets_dispatches_the_collates_as_jax(synth_root, model, over):
    kw = dict(dataset="EPA-Air", data_root=synth_root, model=model, history=7, pred_window=7,
              stride=7, time_unit="days", batch_size=16, enable_text=True,
              use_text_embeddings=True, d_txt=16, **over)
    got, want = parse_datasets(TConfig(**kw), verbose=False), j_parse_datasets(
        JConfig(**kw), verbose=False)
    for k in ("input_dim", "input_len", "pred_len", "npatch", "patch_size", "patch_stride"):
        assert getattr(got["cfg"], k) == getattr(want["cfg"], k), k
    assert got["time_max"] == want["time_max"]
    for split in ("train_dataloader", "val_dataloader"):
        assert len(got[split]) == len(want[split])
        for g, w in itertools.islice(zip(got[split], want[split]), 2):
            _assert_equal({k: v for k, v in g.items() if k != "notes_text"},
                          {k: v for k, v in w.items() if k != "notes_text"})
    if model == "LatentODE":  # shared 1-D time axes; the int count reaches no device
        from imm_tsf_torch.training.trainer import to_device

        assert g["observed_tp"].ndim == 1 and g["tp_to_predict"].ndim == 1
        assert "n_observed_tp" not in to_device(g, torch.device("cpu"))
