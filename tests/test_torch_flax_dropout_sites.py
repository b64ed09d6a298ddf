"""dropout_impl="flax" on the CPU: the other five backbones' train-mode
forwards against the JAX package (tests/test_torch_flax_dropout.py's
check, split off so that the test files run side by side): with both
fusion pairs, each dropout draw's (scope path, counter) equals the JAX
forward's, and the output through params_from_jax matches it to 2e-5."""

import pytest
import torch

from test_torch_flax_dropout import MODELS_HERE, PAIRS, check_train_forward
from torch_port_parity import BF16_MODELS

torch.set_num_threads(1)


@pytest.mark.parametrize("pair", PAIRS, ids=["recavg_gr_add", "t2v_xattn"])
@pytest.mark.parametrize("model", sorted(set(BF16_MODELS) - set(MODELS_HERE)))
def test_train_forward_sites_and_output_match_jax(model, pair, monkeypatch):
    check_train_forward(model, pair, monkeypatch)
