"""The forward path of the training harness, in eval only, and the
host-side loader stages (after imm_tsf_tpu/training/trainer.py:163-283,
349-446).

The loss, optimizer, epoch loop and early stopping come with the
training slice; the TimeLLM prompt stage with TimeLLM.
"""

from __future__ import annotations

import numpy as np

from ..config import Config


def make_forward(cfg: Config, model, fusion):
    """forward(batch) -> pred_y [B, Lp, C]: the backbone, then
    `pred_y.float()`, then the fusion stack when the run has text.
    `batch` holds tensors on the modules' device; call it under
    `torch.inference_mode()` with the modules in eval mode."""

    def forward(batch: dict):
        pred_y = model(batch["tp_to_predict"], batch["observed_data"],
                       batch["observed_tp"], batch["observed_mask"]).float()
        if fusion is not None:
            pred_y = fusion(batch["notes_embeddings"], batch["tau"],
                            batch["tp_to_predict"], pred_y, batch["notes_mask"])
        return pred_y

    return forward


class _EmbedNotesLoader:
    """Wraps a loader to add note embeddings for raw-text fusion: each
    batch's `notes_text` goes through the frozen LLM (llm.loader.
    embed_notes) and comes back as `notes_embeddings` [B, N, d] with a
    matching `notes_mask`.

    Embeddings are cached by note string: the LLM is frozen and one
    note's pooled embedding does not depend on its batch neighbours, so
    the cache is exact and a string is embedded once per loader."""

    def __init__(self, base, llm, tokenizer, max_length: int):
        self.base = base
        self.llm, self.tokenizer, self.max_length = llm, tokenizer, max_length
        self._cache: dict = {}  # note string -> pooled embedding [d]
        self._d: int | None = None
        self.llm_calls = 0  # batches that reached the LLM

    def __len__(self):
        return len(self.base)

    def _embed_cached(self, notes_text):
        from ..llm.loader import embed_notes

        cache = self._cache
        missing = sorted({s for seq in notes_text for s in seq if s not in cache})
        if missing or self._d is None:
            self.llm_calls += 1
            emb_new, _ = embed_notes([missing] if missing else [[]], self.llm,
                                     self.tokenizer, max_length=self.max_length)
            for s, v in zip(missing, emb_new[0]):
                cache[s] = v
            self._d = int(emb_new.shape[-1])
        B = len(notes_text)
        N_max = max((len(s) for s in notes_text), default=1) or 1
        emb = np.zeros((B, N_max, self._d), np.float32)
        note_mask = np.zeros((B, N_max), bool)
        for i, seq in enumerate(notes_text):
            for j, s in enumerate(seq):
                emb[i, j] = cache[s]
                note_mask[i, j] = True
        return emb, note_mask

    def __iter__(self):
        for batch in self.base:
            emb, note_mask = self._embed_cached(batch["notes_text"])
            N = batch["tau"].shape[1]
            if emb.shape[1] < N:  # pad the note axis to the batch's tau width
                pad = N - emb.shape[1]
                emb = np.pad(emb, ((0, 0), (0, pad), (0, 0)))
                note_mask = np.pad(note_mask, ((0, 0), (0, pad)))
            batch = dict(batch)
            batch["notes_embeddings"] = emb[:, :N]
            batch["notes_mask"] = note_mask[:, :N].astype(np.float32)
            yield batch


def make_loader_wrappers(cfg: Config, device=None) -> list:
    """Host-side loader stages a run needs, as loader -> loader callables
    (outermost last): raw-text note embedding through the frozen LLM on
    `device` (cuda unless the caller asks for the CPU). Apply once."""
    wrappers = []
    if cfg.enable_text and not cfg.use_text_embeddings:
        from ..llm.loader import load_llm

        llm, tokenizer = load_llm(cfg.llm_model_fusion, cfg.llm_layers_fusion,
                                  device=device,
                                  use_fused_attn=cfg.use_pallas and cfg.use_fused_attn)
        wrappers.append(lambda ld: _EmbedNotesLoader(ld, llm, tokenizer, cfg.max_length))
    return wrappers
