"""Every product of each backbone's training step under
compute_dtype="bfloat16" takes bf16 operands, on the CPU: the check that a
product escaped the mode, which whole-model tolerances cannot make where
rounding flips spread (TimeLLM: tests/test_torch_bf16_models.py)."""

import numpy as np
import pytest
import torch

from imm_tsf_torch.training import trainer

from torch_port_parity import BF16_MODELS, UnroundedProducts, backbone_case, port_modules, tensors

torch.set_num_threads(1)


@pytest.mark.parametrize("model", list(BF16_MODELS))
def test_every_product_of_the_step_takes_bf16_operands(model):
    """The assembled model's training step (dropout 0) under "bfloat16" on
    the CPU: no float32 product of its forward or backward takes an operand
    that bf16 does not hold exactly (UnroundedProducts), so none escaped the
    mode, while the same forward in float32 takes such operands. This is
    what holds TimeLLM's reprogramming and mapping layers to the mode:
    its whole-model limits (FWD_ATOL) are wider than the distance from
    float32. The CRU's backward is not held: its expm products are
    HIGHEST (ops/expm.py), and so are their transposes, as JAX's inherit
    the precision."""
    jcfg, batch, _, params, stats = backbone_case(model, dropout=0.0)
    tcfg, tm, tf = port_modules(jcfg, params, stats)
    tm.train(), tf.train()
    with UnroundedProducts() as rec:
        loss = trainer.make_loss_fn(trainer.make_forward(tcfg, tm, tf))(tensors(batch))
        forward = dict(rec.found)
        loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert forward == {}, forward
    if model != "CRU":
        assert rec.found == {}, rec.found
    with UnroundedProducts() as rec, torch.no_grad():
        trainer.make_forward(tcfg.replace(compute_dtype="float32"), tm, tf)(tensors(batch))
    assert rec.found, "the recorder saw no float32 product"
