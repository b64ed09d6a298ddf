"""The port's data pipeline against the JAX package, on the CPU.

The pandas-free dataset must give the JAX package's chunks on the JAX
generator's fixtures (days, hours and weeks units; a record_id column;
text on and off), the port's generator must write files that both
packages parse to the same chunks, the instance split must equal
sklearn's, and BatchIterator must visit the JAX package's batches in its
order. Chunk times, masks, ids and notes compare exactly; values to
1e-6 (both packages z-score in float64 with pairwise sums before the
float32 cast, and the CSV float parsers may differ in the last bit).
"""

import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.data.dataset import ChunkedTimeSeriesDataset as JDataset
from imm_tsf_tpu.data.loader import parse_datasets as j_parse_datasets
from imm_tsf_tpu.data.loader import split_indices as j_split_indices
from imm_tsf_tpu.data.synthetic import PRESET_FIXTURES, make_preset_dataset

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.data.dataset import Chunk
from imm_tsf_torch.data.dataset import ChunkedTimeSeriesDataset as TDataset
from imm_tsf_torch.data.loader import parse_datasets as t_parse_datasets
from imm_tsf_torch.data.loader import split_indices as t_split_indices
from imm_tsf_torch.data.synthetic import make_synthetic_dataset

torch.set_num_threads(1)

WINDOWS = {"days": (7, 7, 7), "hours": (24, 24, 24), "weeks": (36, 36, 4)}


def _kw(root, unit, text):
    history, pred, stride = WINDOWS[unit]
    return dict(root=root, history=history, pred_window=pred, stride=stride, time_unit=unit,
                enable_text=text, use_text_embeddings=True, llm_model_fusion="GPT2",
                llm_layers_fusion=6, max_length=1024, verbose=False)


def _assert_same_chunks(got, want):
    assert len(got.chunks) == len(want.chunks)
    assert got.input_dim == want.input_dim
    assert vars(got.bounds) == vars(want.bounds)
    for g, w in zip(got.chunks, want.chunks):
        assert g.chunk_id == w.chunk_id
        np.testing.assert_array_equal(g.tt, w.tt, err_msg=g.chunk_id)
        np.testing.assert_array_equal(g.mask, w.mask, err_msg=g.chunk_id)
        np.testing.assert_allclose(g.vals, w.vals, rtol=1e-6, atol=1e-6, err_msg=g.chunk_id)
        np.testing.assert_array_equal(g.note_times, w.note_times, err_msg=g.chunk_id)
        assert len(g.note_payloads) == len(w.note_payloads)
        for a, b in zip(g.note_payloads, w.note_payloads):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("preset,text", [("EPA-Air", True), ("MIMIC", True),
                                         ("ILINet", False), ("GDELT", False)])
def test_dataset_matches_jax_on_jax_fixtures(tmp_path, preset, text):
    """EPA-Air and GDELT in days, MIMIC in hours with a record_id column,
    ILINet in weeks."""
    root = make_preset_dataset(preset, str(tmp_path), seed=0)
    unit = PRESET_FIXTURES[preset]["time_unit"]
    _assert_same_chunks(TDataset(**_kw(root, unit, text)), JDataset(**_kw(root, unit, text)))


def test_dataset_reads_raw_text_notes_as_jax(tmp_path):
    root = make_preset_dataset("CESNET", str(tmp_path), seed=1, with_embeddings=False)
    kw = dict(_kw(root, "days", True), use_text_embeddings=False)
    got, want = TDataset(**kw), JDataset(**kw)
    _assert_same_chunks(got, want)
    assert isinstance(got.chunks[0].note_payloads[0], str)


@pytest.mark.parametrize("unit,record_id_col", [("days", False), ("hours", True),
                                                ("weeks", False)])
def test_port_generator_files_parse_alike_in_both_packages(tmp_path, unit, record_id_col):
    fixture = dict(n_entities=3, n_features=4, n_days=160, obs_per_day=1.5, notes_per_day=0.5,
                   d_txt=8, seed=2, time_unit=unit, record_id_col=record_id_col)
    root = make_synthetic_dataset(str(tmp_path / "port"), **fixture)
    got = TDataset(**_kw(root, unit, True))
    _assert_same_chunks(got, JDataset(**_kw(root, unit, True)))
    # the same draws as the JAX generator: its files give the same chunks
    jroot = str(tmp_path / "jax")
    from imm_tsf_tpu.data.synthetic import make_synthetic_dataset as j_make

    j_make(jroot, **fixture)
    _assert_same_chunks(got, JDataset(**_kw(jroot, unit, True)))


def _chunks_of_records(n_records, per=3):
    return [Chunk(f"rec{r:02d}_chunk{i}", np.zeros(1, np.float32), np.zeros((1, 1), np.float32),
                  np.zeros((1, 1), np.float32), np.zeros(0, np.float32), [])
            for r in range(n_records) for i in range(per)]


@pytest.mark.parametrize("n_records", [4, 5, 8, 13])
@pytest.mark.parametrize("method", ["instance", "sample"])
def test_split_indices_equal_jax(n_records, method):
    """"instance" calls sklearn's train_test_split in the JAX package."""
    chunks = _chunks_of_records(n_records)
    assert t_split_indices(chunks, method) == j_split_indices(chunks, method)


def test_batch_order_equals_jax(tmp_path):
    root = make_preset_dataset("EPA-Air", str(tmp_path), seed=0)
    kw = dict(dataset="EPA-Air", data_root=str(tmp_path), model="CRU", history=7,
              pred_window=7, stride=7, batch_size=5, seed=3, enable_text=True,
              use_text_embeddings=True, llm_model_fusion="GPT2", llm_layers_fusion=6)
    assert root
    got = t_parse_datasets(TConfig(**kw), verbose=False)
    want = j_parse_datasets(JConfig(**kw), verbose=False)
    for key in ("input_len", "pred_len", "input_dim"):
        assert getattr(got["cfg"], key) == getattr(want["cfg"], key)
    for split in ("train_dataloader", "val_dataloader", "test_dataloader"):
        for _ in range(2):  # two epochs: the shuffle stream advances alike
            for g, w in zip(got[split], want[split], strict=True):
                assert sorted(g) == sorted(w)
                for k in w:
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=1e-6, err_msg=k)
