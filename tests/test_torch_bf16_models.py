"""The eval forward of every backbone under compute_dtype="bfloat16", the
port against the JAX package under the bf16 product oracle, on the CPU
(tests/test_torch_bf16.py says what the oracle is and where the two
packages may still round a value apart). Each backbone runs with
TTF_RecAvg + MMF_GR_Add and the kernel routes on (#1's, #2's and #3's
one-pass plain versions), from the JAX init through params_from_jax; the
CRU on both its scan routes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imm_tsf_tpu.training.trainer as jtrainer

from imm_tsf_torch.training import trainer

from torch_port_parity import (BF16_MODELS, backbone_case, install_bf16_oracle, port_modules,
                               tensors)
from torch_port_parity import jitted_jax_init  # noqa: F401 -- autouse: JAX's init jitted

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def oracle():
    restore = install_bf16_oracle()
    yield
    restore()


# |port - JAX| of the eval forward (outputs of order 1), 1e-4 unless named:
# the float32 summation order, and here and there one value that the two
# round to neighbouring bf16 values (measured at most 8.1e-6, TimesNet; the
# fused CRU 2.4e-7); TTM 5e-4 (measured 4.9e-5); TimeLLM's 768-wide GPT-2
# takes ~14 rounding stages, each of which turns the last one's float32
# differences into flips (every stage alone agrees:
# tests/test_torch_bf16.py::test_gpt2_block_stages_match_jax), measured
# 1.3e-2 at most and 2.9e-3 relative in norm, against bf16's own 2.4e-2 /
# 6.3e-3 from float32. Those limits would pass a float32 TimeLLM too, so
# its distance to JAX in norm is also held under FWD_FLOAT32_SHARE of the
# port's float32 forward's distance to JAX: the case is drawn anew in each
# process, and over 15 draws the share was 0.44-0.66 (a float32 forward's
# is 1). tests/test_torch_bf16_rounding.py holds each of its products to
# the mode.
FWD_ATOL = {"TTM": 5e-4, "TimeLLM": 5e-2}
FWD_REL_NORM = {"TimeLLM": 1e-2}
FWD_FLOAT32_SHARE = 0.85


_FORWARDS: dict = {}


def _forwards(model: str, fused: bool = False):
    """(port, JAX) eval forwards of one backbone case under "bfloat16", and
    the port's float32 forward of the same weights (cached by model and CRU
    route: the CRU test reads the forward test's default route)."""
    if (model, fused) not in _FORWARDS:
        jcfg, batch, (jm, jf), params, stats = backbone_case(model)
        fwd = jtrainer.make_forward(jcfg, jm, jf)
        dev = {k: jnp.asarray(v) for k, v in batch.items()}
        want = np.asarray(jax.jit(lambda p, s, b: fwd(p, s, b, False, None)[0])(
            params, stats, dev))
        tcfg, tm, tf = port_modules(jcfg, params, stats)
        tm.eval(), tf.eval()
        with torch.inference_mode():
            got = trainer.make_forward(tcfg, tm, tf)(tensors(batch)).numpy()
            float32 = trainer.make_forward(tcfg.replace(compute_dtype="float32"), tm, tf)(
                tensors(batch)).numpy()
        _FORWARDS[(model, fused)] = got, want, float32
    return _FORWARDS[(model, fused)]


@pytest.mark.parametrize("model", list(BF16_MODELS))
def test_eval_forward_matches_jax(oracle, model):
    """Every backbone with TTF_RecAvg + MMF_GR_Add (kernel routes on: #1's,
    #2's and #3's one-pass plain versions) under "bfloat16" against the
    JAX package's forward under the oracle, to FWD_ATOL and, for TimeLLM,
    FWD_REL_NORM; the mode moves the output from float32's (the port's, which
    the other tests hold to JAX's) by more, and the port's output lies
    nearer JAX's than its float32 forward does (FWD_FLOAT32_SHARE)."""
    got, want, float32 = _forwards(model)
    assert got.shape == want.shape and np.isfinite(got).all()
    atol = FWD_ATOL.get(model, 1e-4)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= FWD_REL_NORM.get(model, 1.0), rel
    assert np.abs(want - float32).max() >= min(10 * atol, 5e-3)
    share = np.linalg.norm(got - want) / np.linalg.norm(float32 - want)
    assert share <= FWD_FLOAT32_SHARE, share


def test_cru_routes_part_in_jax_and_each_port_route_matches_its_own(oracle, monkeypatch):
    """The default CRU scan names no precision (its products round under the
    context), the fused scan's Pallas kernels pin HIGHEST: the two JAX routes
    part under the oracle, and the port's fused route (kernel #6's plain
    version under full_precision) matches the JAX fused route (measured
    2.4e-7) while the default route matches the default (the forward test)."""
    default, want_default, _ = _forwards("CRU")
    monkeypatch.setenv("IMM_TSF_CRU_FUSED", "1")
    jax.clear_caches()
    fused, want_fused, float32 = _forwards("CRU", fused=True)
    np.testing.assert_allclose(fused, want_fused, atol=1e-4, rtol=0)
    np.testing.assert_allclose(default, want_default, atol=1e-4, rtol=0)
    assert np.abs(want_fused - want_default).max() >= 1e-4
    assert np.abs(want_fused - float32).max() >= 1e-4  # the rest of the CRU still rounds
