"""The port's text-embedding stage (`python -m
imm_tsf_torch.compute_text_embeddings`) against the JAX package's root
`compute_text_embeddings.py`, on the CPU.

Both stages run with `load_llm` patched to one small Llama (64 wide, 2
blocks, vocab 256) carried from flax into the port by
`llama_params_from_jax`, and the hash tokenizer, on synthetic fixtures
in days (EPA-Air) and in hours (MIMIC, `time_unit` "auto" in both), one
entity with an empty note cell (skipped) and one without a text.csv:

- the same artifact filenames for the same entities;
- `rel_times` bit for bit (offsets past 2^53 ns on the 120-day fixture),
  embeddings to 2e-5, the unit tag;
- skip-if-exists, and `overwrite`;
- the port's artifacts load through both packages' datasets, chunk for
  chunk;
- `--embed_dtype bfloat16`: within 0.05 x scale of the float32 artifact
  (tests/test_llm_stack.py:128), stored float32; `--llm_tp` above 1
  refused.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import compute_text_embeddings as jstage
from imm_tsf_tpu.data.dataset import ChunkedTimeSeriesDataset as JDataset
from imm_tsf_tpu.llm import llama as jllama
from imm_tsf_tpu.llm import loader as jloader

from imm_tsf_torch import compute_text_embeddings as stage
from imm_tsf_torch.convert import llama_params_from_jax
from imm_tsf_torch.data.dataset import ChunkedTimeSeriesDataset
from imm_tsf_torch.data.synthetic import make_synthetic_dataset
from imm_tsf_torch.llm import llama, loader

torch.set_num_threads(1)

SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=2)
MAX_LENGTH = 64
FIXTURES = {"EPA-Air": "days", "MIMIC": "hours"}
SPANS = {"EPA-Air": 120, "MIMIC": 30}  # 120 days: offsets past 2^53 ns
FNAME = "text_embeddings_model=Llama_layers=full_maxlen=64.pt"


@pytest.fixture(scope="module")
def models():
    jm = jllama.LlamaModel(jllama.LlamaConfig(**SMALL))
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    tm = llama.LlamaModel(llama.LlamaConfig(**SMALL))
    tm.load_state_dict(llama_params_from_jax(params))
    return jm, params, tm.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stage"))
    for ds, unit in FIXTURES.items():
        make_synthetic_dataset(os.path.join(root, ds), n_entities=3, n_features=2,
                               n_days=SPANS[ds], obs_per_day=1.5, notes_per_day=1.0, time_unit=unit,
                               with_embeddings=False, seed=1)
        proc = os.path.join(root, ds, "processed")
        path = os.path.join(proc, "entity001", "text.csv")
        with open(path) as f:
            lines = f.read().splitlines()
        stamp = lines[3].split(",")[0]
        lines[3] = f"{stamp},"  # an empty note cell
        lines[5] = lines[5].split(",")[0] + "," + " ".join(f"w{i}" for i in range(50))
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        os.remove(os.path.join(proc, "entity002", "text.csv"))
    return root


def _patch(monkeypatch, models):
    jm, params, tm = models
    monkeypatch.setattr(jloader, "load_llm", lambda *a, **k: (jm, params,
                                                               jloader.HashTokenizer(256)))
    monkeypatch.setattr(loader, "load_llm", lambda *a, **k: (tm, loader.HashTokenizer(256)))


def _artifacts(root, ds):
    proc = os.path.join(root, ds, "processed")
    return {(rec, f): torch.load(os.path.join(proc, rec, f), weights_only=False)
            for rec in sorted(os.listdir(proc)) for f in os.listdir(os.path.join(proc, rec))
            if f.startswith("text_embeddings")}


@pytest.mark.parametrize("ds", sorted(FIXTURES))
def test_stage_matches_jax_stage(ds, fixture_root, models, tmp_path, monkeypatch, capsys):
    _patch(monkeypatch, models)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    for r in (jroot, troot):
        shutil.copytree(os.path.join(fixture_root, ds), os.path.join(r, ds))
    jstage.compute_text_embeddings(ds, "Llama", None, MAX_LENGTH, jroot, token_batch=4,
                                   llm_tp=1)
    tps = stage.compute_text_embeddings(ds, "Llama", None, MAX_LENGTH, troot, token_batch=4,
                                        device="cpu")
    assert tps > 0 and "steady-state" in capsys.readouterr().out
    want, got = _artifacts(jroot, ds), _artifacts(troot, ds)
    assert sorted(got) == sorted(want) == [("entity000", FNAME), ("entity001", FNAME)]
    for key, w in want.items():
        g = got[key]
        assert g["time_unit"] == w["time_unit"] == FIXTURES[ds]
        assert g["rel_times"].dtype == torch.float32 and g["embeddings"].dtype == torch.float32
        np.testing.assert_array_equal(g["rel_times"].numpy(), w["rel_times"].numpy())
        np.testing.assert_allclose(g["embeddings"].numpy(), w["embeddings"].numpy(), atol=2e-5,
                                   rtol=0)
    n_notes = len(open(os.path.join(troot, ds, "processed", "entity001", "text.csv")).readlines())
    assert got[("entity001", FNAME)]["rel_times"].shape == (n_notes - 2,)  # header, empty cell

    # skip-if-exists, then overwrite
    before = {k: v["embeddings"].clone() for k, v in got.items()}
    path = os.path.join(troot, ds, "processed", "entity000", FNAME)
    torch.save(dict(got[("entity000", FNAME)],
                    embeddings=torch.zeros_like(before[("entity000", FNAME)])), path)
    assert stage.compute_text_embeddings(ds, "Llama", None, MAX_LENGTH, troot,
                                         device="cpu") == 0.0
    assert "[skip] entity000" in capsys.readouterr().out
    assert not torch.load(path, weights_only=False)["embeddings"].any()
    stage.compute_text_embeddings(ds, "Llama", None, MAX_LENGTH, troot, overwrite=True,
                                  device="cpu")
    np.testing.assert_array_equal(torch.load(path, weights_only=False)["embeddings"].numpy(),
                                  before[("entity000", FNAME)].numpy())

    # the port's artifacts through both packages' datasets
    kw = dict(root=os.path.join(troot, ds), history=7, pred_window=7, stride=7,
              time_unit=FIXTURES[ds], enable_text=True, use_text_embeddings=True,
              llm_model_fusion="Llama", llm_layers_fusion=None, max_length=MAX_LENGTH,
              rec_ids=["entity000", "entity001"], verbose=False)  # entity002 has no notes
    jds, tds = JDataset(**kw), ChunkedTimeSeriesDataset(**kw)
    assert [c.chunk_id for c in tds.chunks] == [c.chunk_id for c in jds.chunks]
    assert tds.bounds.d_txt == jds.bounds.d_txt == 64
    for a, b in zip(tds.chunks, jds.chunks):
        np.testing.assert_array_equal(a.note_times, b.note_times)
        np.testing.assert_array_equal(np.stack(a.note_payloads), np.stack(b.note_payloads))


def test_bfloat16_stage_and_refusals(fixture_root, models, tmp_path, monkeypatch):
    _patch(monkeypatch, models)
    root = str(tmp_path)
    shutil.copytree(os.path.join(fixture_root, "EPA-Air"), os.path.join(root, "EPA-Air"))
    stage.compute_text_embeddings("EPA-Air", "Llama", None, MAX_LENGTH, root, device="cpu")
    f32 = _artifacts(root, "EPA-Air")
    tm = models[2]
    bf16_model = llama.LlamaModel(llama.LlamaConfig(**SMALL))
    bf16_model.load_state_dict(tm.state_dict())  # the stage casts the model it loads in place
    monkeypatch.setattr(loader, "load_llm", lambda *a, **k: (bf16_model.eval(),
                                                              loader.HashTokenizer(256)))
    stage.main(["--datasets", "EPA-Air", "--llm_model_fusion", "Llama", "--max_length",
                str(MAX_LENGTH), "--data_root", root, "--overwrite", "--embed_dtype",
                "bfloat16", "--device", "cpu"])
    assert bf16_model.word_embedding_table().dtype == torch.bfloat16
    b16 = _artifacts(root, "EPA-Air")
    assert sorted(b16) == sorted(f32)
    for key, w in f32.items():
        g = b16[key]["embeddings"]
        assert g.dtype == torch.float32
        scale = float(w["embeddings"].abs().max())
        np.testing.assert_allclose(g.numpy(), w["embeddings"].numpy(), atol=0.05 * scale, rtol=0)
        np.testing.assert_array_equal(b16[key]["rel_times"].numpy(), w["rel_times"].numpy())
    with pytest.raises(NotImplementedError, match="Queue 1, item 16"):
        stage.compute_text_embeddings("EPA-Air", "Llama", None, MAX_LENGTH, root, llm_tp=2,
                                      device="cpu")
