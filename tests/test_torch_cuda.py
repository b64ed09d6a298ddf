"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card: a CUDA kernel
has no CPU mode. This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: float32 with another summation order, |err| <= 1e-4 +
1e-4|ref| for the FFN (K=2048 sums), 1e-5 + 1e-5|ref| for the recency
average (N-term sums), 2e-5 + 1e-5|ref| for the causal attention (online
softmax against the plain two-pass softmax)."""

import pytest
import torch

from chip_smoke import (attn_inputs, attn_ragged_inputs, dropout_probe_inputs, ffn_inputs,
                        recavg_inputs)
from imm_tsf_torch.kernels import attn, ffn, recavg

KEEP = 0.9


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def gen(dev):
    return torch.Generator(device=dev).manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("M,D,F,act,drop", [
    (1000, 512, 2048, "gelu", False),
    (200, 512, 2048, "relu", True),
    (37, 96, 200, "gelu", True),  # ragged D and F: masked columns
    (1, 512, 64, "relu", False),
])
def test_ffn_kernel_matches_plain(dev, gen, M, D, F, act, drop):
    args = ffn_inputs(M, D, F, gen, dev)
    before = ffn.launches
    out = ffn.fused_encoder_ffn(*args, KEEP, act, drop)
    torch.cuda.synchronize()
    assert ffn.launches == before + 1
    torch.testing.assert_close(out, ffn.ffn_reference(*args, KEEP, act, drop),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["output", "hidden"])
def test_ffn_kernel_dropout_bits_are_the_hash_bits(dev, gen, site):
    salts = ffn_inputs(8, 8, 8, gen, dev)[-1]
    args, expect = dropout_probe_inputs(300, 512, 1024, site, salts, dev)
    got = ffn.fused_encoder_ffn(*args, KEEP, "relu", True) > 0
    assert torch.equal(got, expect)


@pytest.mark.cuda
def test_ffn_kernel_refuses_what_it_cannot_take(dev, gen):
    args = ffn_inputs(16, 640, 64, gen, dev)
    with pytest.raises(ValueError, match="accumulator"):
        ffn.fused_encoder_ffn(*args, KEEP, "gelu", False)
    args = ffn_inputs(16, 64, 64, gen, dev)
    with pytest.raises(ValueError, match="float32"):
        ffn.fused_encoder_ffn(args[0].double(), *args[1:], KEEP, "gelu", False)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,T,d,empty", [
    (64, 8, 24, 768, False),
    (3, 5, 7, 300, True),
    (2, 70, 9, 1, False),  # notes over several shared-memory chunks
])
def test_recavg_kernel_matches_plain(dev, gen, B, N, T, d, empty):
    args = recavg_inputs(B, N, T, d, gen, dev, empty_sample=empty)
    before = recavg.launches
    out = recavg.recency_weighted_average(*args)
    torch.cuda.synchronize()
    assert recavg.launches == before + 1
    torch.testing.assert_close(out, recavg.recavg_reference(*args), atol=1e-5, rtol=1e-5)
    if empty:
        assert bool((out[-1] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D,lo", [
    (2, 3, 40, 64, None),
    (4, 12, 37, 64, 1),     # T not a multiple of 8, right-padded
    (2, 2, 200, 64, 101),   # several query and key tiles
    (3, 2, 130, 128, 60),   # the 128-column variant
    (2, 2, 70, 30, 35),     # D not a multiple of 4: zero-padded columns
])
def test_attn_kernel_matches_plain(dev, gen, B, H, T, D, lo):
    args = attn_inputs(B, H, T, D, gen, dev, lo)
    before = attn.launches
    out = attn.fused_causal_attention(*args)
    torch.cuda.synchronize()
    assert attn.launches == before + 1
    assert out.shape == (B, H, T, D)
    torch.testing.assert_close(out, attn.attention_reference(*args), atol=2e-5, rtol=1e-5)


@pytest.mark.cuda
def test_attn_kernel_fully_masked_rows_are_zero(dev, gen):
    args = attn_ragged_inputs(gen, dev)
    out = attn.fused_causal_attention(*args)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all())
    assert bool((out[0, :, 0] == 0).all()) and bool((out[1] == 0).all())
    torch.testing.assert_close(out, attn.attention_reference(*args), atol=2e-5, rtol=1e-5)


@pytest.mark.cuda
def test_attn_kernel_refuses_what_it_cannot_take(dev, gen):
    q, k, v, pad = attn_inputs(1, 1, 8, 136, gen, dev)
    with pytest.raises(ValueError, match="head dim"):
        attn.fused_causal_attention(q, k, v, pad)
    q, k, v, pad = attn_inputs(1, 1, 8, 64, gen, dev)
    with pytest.raises(ValueError, match="float32"):
        attn.fused_causal_attention(q.double(), k, v, pad)
