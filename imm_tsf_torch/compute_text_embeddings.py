"""Offline text-embedding stage (after the JAX package's root
compute_text_embeddings.py; reference compute_text_embeddings.py:8-148).

    python -m imm_tsf_torch.compute_text_embeddings --datasets EPA-Air \\
        --data_root ./data --llm_model_fusion Llama [--embed_dtype bfloat16]

For each entity of `<data_root>/<dataset>/processed/`: read text.csv,
take each note's time relative to the entity's first time-series stamp in
the dataset's time unit, embed every note with the frozen LLM
(llm/loader.embed_notes, length-bucketed batches), and save
`text_embeddings_model={llm}_layers={n|full}_maxlen={L}.pt`
({"embeddings" [N, d] float32, "rel_times" [N] float32, "time_unit"}),
which both packages' datasets load with `--use_text_embeddings`. An
existing artifact is kept unless `overwrite`.

As the JAX stage does: rel times in the dataset's own unit (`time_unit`
"auto" reads config.DATASET_PRESETS; unknown datasets take days), an
empty note cell skipped (what pandas reads as NaN), the steady-state real
tokens/s printed with the first call excluded. Written without pandas:
the CSVs go through data/dataset's reader, notes are ordered by a stable
sort of their stamps (pandas' default sort is not stable, so notes with
equal stamps may come in another order there).

`--device` (default cuda) picks the card; `--llm_tp` picks the frozen
LLM's ("data", "model") mesh over the cards from it on (llm/loader.
resolve_llm_mesh: 0, the default, puts every card on the "model" axis for
Llama and DeepSeek); `--embed_dtype bfloat16` runs the frozen forward in
bfloat16 (the model cast once), pooling in float32.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .config import DATASET_PRESETS
from .data.dataset import UNIT_SECONDS, _read_csv, _stamps_ns, embeddings_filename
from .llm import loader

_EMBED_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


def _entity_notes(text_path: str, ts_path: str, sec_per_unit: float):
    """(notes, float32 rel times) of one entity, in stamp order."""
    header, rows = _read_csv(ts_path)
    base = int(_stamps_ns([r[header.index("date_time")] for r in rows]).min())
    theader, trows = _read_csv(text_path)
    cols = [c for c in theader if c not in ("date_time", "record_id")]
    t_at, x_at = theader.index("date_time"), theader.index(cols[0])
    stamps = _stamps_ns([r[t_at] for r in trows])
    notes, rel = [], []
    for k in np.argsort(stamps, kind="stable"):
        if trows[k][x_at] == "":
            continue
        notes.append(trows[k][x_at])
        rel.append((int(stamps[k]) - base) / 1e9 / sec_per_unit)  # float64, then float32
    return notes, np.asarray(rel, np.float32)


def compute_text_embeddings(
    data_name: str,
    llm_model_fusion: str = "GPT2",
    llm_layers_fusion=None,
    max_length: int = 1024,
    data_root: str = "./data",
    model_dir: str | None = None,
    overwrite: bool = False,
    token_batch: int = 64,
    llm_tp: int = 0,
    time_unit: str = "auto",
    unit_scale: float | None = None,
    embed_dtype: str = "float32",
    device=None,
) -> float:
    """Embed every entity's notes of `data_name`; returns the real tokens/s
    over the whole run (0.0 when nothing was embedded)."""
    if time_unit == "auto":
        time_unit = DATASET_PRESETS.get(data_name, {}).get("time_unit", "days")
    if time_unit == "custom":
        if unit_scale is None:
            raise ValueError("Must set unit_scale when time_unit='custom'")
        sec_per_unit = float(unit_scale)
    else:
        sec_per_unit = UNIT_SECONDS[time_unit]
    mesh = loader.resolve_llm_mesh(llm_model_fusion, llm_tp, device)
    if mesh is not None:
        print(f"[mesh] frozen LLM sharded over {mesh.shape}")
    compute_dtype = _EMBED_DTYPES[embed_dtype]
    model, tokenizer = loader.load_llm(llm_model_fusion, llm_layers_fusion,
                                       model_dir=model_dir, device=device)
    if compute_dtype is not None:  # the stage owns the model: cast it once, in place
        model = model.to(compute_dtype)

    proc = os.path.join(data_root, data_name, "processed")
    fname = embeddings_filename(llm_model_fusion, llm_layers_fusion, max_length)
    total_tokens = steady_tokens = n_calls = 0
    embed_secs = 0.0  # the first call excluded
    t0 = time.perf_counter()
    for rec in sorted(os.listdir(proc)):
        ent = os.path.join(proc, rec)
        if not os.path.isdir(ent):
            continue
        out_path = os.path.join(ent, fname)
        if os.path.exists(out_path) and not overwrite:  # skip-if-exists (:63-66)
            print(f"[skip] {rec}")
            continue
        text_path = os.path.join(ent, "text.csv")
        ts_path = os.path.join(ent, "time_series.csv")
        if not (os.path.isfile(text_path) and os.path.isfile(ts_path)):
            continue
        notes, rel = _entity_notes(text_path, ts_path, sec_per_unit)
        if not notes:
            continue
        stats: dict = {}
        te = time.perf_counter()
        emb, _ = loader.embed_notes([notes], model, tokenizer, max_length=max_length,
                                    token_batch=token_batch, stats_out=stats, mesh=mesh,
                                    compute_dtype=compute_dtype)
        te = time.perf_counter() - te  # embed_notes returns host arrays: the card is done
        n_calls += 1
        if n_calls > 1:
            embed_secs += te
            steady_tokens += stats["real_tokens"]
        total_tokens += stats["real_tokens"]
        torch.save({"embeddings": torch.from_numpy(emb[0]), "rel_times": torch.from_numpy(rel),
                    "time_unit": time_unit}, out_path)
        print(f"[done] {rec}: {len(notes)} notes")
    dt = time.perf_counter() - t0
    if total_tokens:
        msg = f"embed throughput: {total_tokens / dt:.0f} tokens/sec (incl. warm-up)"
        if steady_tokens:
            msg += f"; steady-state: {steady_tokens / embed_secs:.0f} tokens/sec"
        print(msg)
    return total_tokens / dt if total_tokens else 0.0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--datasets", nargs="+", default=["EPA-Air"])
    ap.add_argument("--llm_model_fusion", default="GPT2")
    ap.add_argument("--llm_layers_fusion", type=int, default=None)
    ap.add_argument("--max_length", type=int, default=1024)
    ap.add_argument("--data_root", default="./data")
    ap.add_argument("--model_dir", default=None)
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--llm_tp", type=int, default=0,
                    help="tensor-parallel width of the frozen LLM's mesh (0 = auto: every "
                         "card on the model axis for Llama / DeepSeek; 1 = one card)")
    ap.add_argument("--time_unit", default="auto",
                    help="unit for the stored note rel-times; 'auto' resolves each "
                         "dataset's unit from config.DATASET_PRESETS (unknown: days)")
    ap.add_argument("--unit_scale", type=float, default=None,
                    help="seconds per unit when --time_unit=custom")
    ap.add_argument("--embed_dtype", default="float32", choices=sorted(_EMBED_DTYPES),
                    help="frozen-LLM forward dtype; pooling stays float32")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for ds in args.datasets:
        compute_text_embeddings(
            ds, args.llm_model_fusion, args.llm_layers_fusion, args.max_length,
            args.data_root, args.model_dir, args.overwrite, llm_tp=args.llm_tp,
            time_unit=args.time_unit, unit_scale=args.unit_scale,
            embed_dtype=args.embed_dtype, device=args.device)


if __name__ == "__main__":
    main()
