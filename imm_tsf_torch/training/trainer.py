"""The forward path of the training harness, in eval only (after
imm_tsf_tpu/training/trainer.py:163-283).

The loss, optimizer, epoch loop and early stopping come with the
training slice.
"""

from __future__ import annotations

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
