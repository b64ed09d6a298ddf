"""The port's config and host data path against the JAX package.

Config fields, defaults, presets and the overlay helpers must equal
imm_tsf_tpu.config; the NumPy collates the serving path runs must give
bit-identical batches on random ragged chunks (one with no notes)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import imm_tsf_tpu.config as jcfg
from imm_tsf_tpu.data import collate as jC
from imm_tsf_tpu.data.dataset import Chunk as JChunk
from imm_tsf_tpu.data.loader import _pad_batch_dim as j_pad_batch_dim

import imm_tsf_torch.config as tcfg
from imm_tsf_torch.data import collate as tC
from imm_tsf_torch.data.dataset import Chunk as TChunk
from imm_tsf_torch.data.loader import _pad_batch_dim as t_pad_batch_dim

torch.set_num_threads(1)


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = f.default_factory()
    return out


def test_config_fields_and_defaults_equal():
    assert [f.name for f in dataclasses.fields(tcfg.Config)] == \
        [f.name for f in dataclasses.fields(jcfg.Config)]
    assert _defaults(tcfg.Config) == _defaults(jcfg.Config)
    assert tcfg.Config().to_dict() == jcfg.Config().to_dict()


def test_preset_tables_and_families_equal():
    assert tcfg.DATASET_PRESETS == jcfg.DATASET_PRESETS
    assert tcfg.MODEL_PRESETS == jcfg.MODEL_PRESETS
    for name in ("DATASETS", "MODELS", "MTS_MODELS", "LMTS_MODELS",
                 "IMTS_MODELS", "TTF_MODULES", "MMF_MODULES", "EPHEMERAL_FIELDS"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name


@pytest.mark.parametrize("model", jcfg.MODELS)
def test_apply_presets_and_patching_equal(model):
    kw = dict(overwrite_args=True, dataset="EPA-Air", model=model)
    fixed, tunable = {"lr": 5e-4}, {"batch_size": 8}
    t = tcfg.finalize_patching(tcfg.apply_presets(tcfg.Config(**kw), fixed, tunable))
    j = jcfg.finalize_patching(jcfg.apply_presets(jcfg.Config(**kw), fixed, tunable))
    assert t.to_dict() == j.to_dict()


def test_load_saved_config_round_trip_equal(tmp_path):
    cfg = jcfg.Config(model="PatchTST", mesh_shape=(2,), vmap_lrs=(1e-3,),
                      input_dim=3, input_len=12, pred_len=6)
    raw = json.loads(cfg.to_json())
    raw["platform"] = "cpu"  # ephemeral: dropped by both loaders
    raw["a_field_from_another_version"] = 1
    path = tmp_path / "config.json"
    path.write_text(json.dumps(raw))
    assert tcfg.load_saved_config(str(path)).to_dict() == \
        jcfg.load_saved_config(str(path)).to_dict()
    with pytest.raises(ValueError, match="compute_dtype"):
        tcfg.Config(compute_dtype="fp8")


def _random_chunks(rng, B, D, d_txt, history=7.0, time_max=14.0):
    """Ragged chunks: varying obs/pred counts and note counts, NaN-free
    values with random observation masks; the last chunk has no notes."""
    chunks = []
    for i in range(B):
        n_obs = int(rng.integers(0, 12))
        n_pred = int(rng.integers(1, 6))
        tt = np.concatenate([
            np.sort(rng.choice(np.linspace(0, history - 0.01, 40), n_obs, replace=False)),
            np.sort(rng.choice(np.linspace(history, time_max, 20), n_pred, replace=False)),
        ]).astype(np.float32)
        L = len(tt)
        vals = rng.standard_normal((L, D)).astype(np.float32)
        mask = (rng.random((L, D)) < 0.7).astype(np.float32)
        mask[n_obs:] = 1.0
        n_notes = 0 if i == B - 1 else int(rng.integers(1, 6))
        note_times = np.sort(rng.uniform(0, history, n_notes)).astype(np.float32)
        payloads = [rng.standard_normal(d_txt).astype(np.float32) for _ in range(n_notes)]
        chunks.append((f"rec{i}_chunk{i}", tt, vals * mask, mask, note_times, payloads))
    return chunks


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_standard_collate_multimodal_and_padding_bit_identical(seed):
    rng = np.random.default_rng(seed)
    B, D, d_txt, pad_to = 5, 3, 8, 8
    raw = _random_chunks(rng, B, D, d_txt)
    jchunks = [JChunk(*c) for c in raw]
    tchunks = [TChunk(*c) for c in raw]
    assert tchunks[0].record_id == jchunks[0].record_id
    assert tchunks[0].chunk_index == jchunks[0].chunk_index
    L_obs, L_pred = 16, 8
    n_notes = jC.pad_to_bucket(max(len(c.note_times) for c in jchunks))
    assert tC.pad_to_bucket(n_notes) == n_notes
    for b in (1, 7, 8, 9, 100, 5000):
        assert tC.pad_to_bucket(b) == jC.pad_to_bucket(b)

    jout = jC.standard_collate(jchunks, 7.0, 14.0, L_obs, L_pred)
    tout = tC.standard_collate(tchunks, 7.0, 14.0, L_obs, L_pred)
    jout = j_pad_batch_dim(jC.add_multimodal(jout, jchunks, True, True, n_notes, d_txt), B, pad_to)
    tout = t_pad_batch_dim(tC.add_multimodal(tout, tchunks, True, True, n_notes, d_txt), B, pad_to)
    assert sorted(tout) == sorted(jout)
    for k in jout:
        assert tout[k].dtype == jout[k].dtype, k
        np.testing.assert_array_equal(tout[k], jout[k], err_msg=k)
    assert not tout["notes_mask"][B - 1].any()  # the no-notes chunk

    # raw-text payloads ride as lists and pad with empty lists
    text = [TChunk(c[0], c[1], c[2], c[3], c[4], [f"note {j}" for j in range(len(c[4]))])
            for c in raw]
    tt = t_pad_batch_dim(tC.add_multimodal({}, text, True, False, n_notes, d_txt), B, pad_to)
    jt = j_pad_batch_dim(jC.add_multimodal(
        {}, [JChunk(*dataclasses.astuple(c)) for c in text], True, False, n_notes, d_txt), B, pad_to)
    assert tt["notes_text"] == jt["notes_text"]


def test_collate_rejects_all_zero_prediction_mask():
    c = TChunk("r_chunk0", np.asarray([1.0, 8.0], np.float32),
               np.zeros((2, 2), np.float32), np.zeros((2, 2), np.float32),
               np.zeros(0, np.float32), [])
    with pytest.raises(ValueError, match="all zeros"):
        tC.standard_collate([c], 7.0, 14.0, 4, 4)
