"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card: a CUDA kernel
has no CPU mode. This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: float32 with another summation order, |err| <= 1e-4 +
1e-4|ref| for the FFN (K=2048 sums), 1e-5 + 1e-5|ref| for the recency
average (N-term sums), 2e-5 + 1e-5|ref| for the causal attention (online
softmax against the plain two-pass softmax); the expm to 1e-5 of each
matrix's largest entry (tiered Taylor against Taylor-12, up to 7
squarings); the fused CRU scan against its plain version run in float64,
to 2.5 x (1e-4 + 1e-4|ref|) (chip_smoke.check_scan: T Kalman steps whose
float32 rounding alone passes 1e-4 + 1e-4|ref|)."""

import pytest
import torch

from chip_smoke import (attn_inputs, attn_ragged_inputs, check_scan, dropout_probe_inputs,
                        expm_inputs, expm_rel_err, ffn_inputs, recavg_inputs, scan_inputs)
from imm_tsf_torch.kernels import attn, cru_scan, expm, ffn, recavg
from imm_tsf_torch.ops.expm import expm as ops_expm
from imm_tsf_torch.ops.expm import expm_taylor12

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


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,norm", [
    (64, 64, 0.01),  # Taylor-4
    (64, 64, 0.5),   # Taylor-12
    (64, 64, 6.0),   # Taylor-12 and 3 squarings
    (64, 64, 80.0),  # 7 squarings, the most the CRU allows
    (3, 24, 3.0),    # n < 64: zero-padded in shared memory
    (5, 1, 2.0),
    (2, 63, 1.5),
])
def test_expm_kernel_matches_plain(dev, gen, B, n, norm):
    M = expm_inputs(B, n, norm, gen, dev)
    before = expm.launches
    out = expm.batched_expm(M, 7)
    torch.cuda.synchronize()
    assert expm.launches == before + 1
    assert out.shape == (B, n, n)
    expm_rel_err(out, expm_taylor12(M, 7))


@pytest.mark.cuda
def test_expm_kernel_zero_is_exactly_identity(dev):
    out = expm.batched_expm(torch.zeros((4, 64, 64), device=dev))
    assert torch.equal(out, torch.eye(64, device=dev).expand(4, 64, 64))


@pytest.mark.cuda
def test_expm_kernel_refuses_what_it_cannot_take(dev, gen):
    with pytest.raises(ValueError, match="exceeds"):
        expm.batched_expm(expm_inputs(2, 65, 1.0, gen, dev))
    with pytest.raises(ValueError, match="float32"):
        expm.batched_expm(expm_inputs(2, 8, 1.0, gen, dev).double())
    with pytest.raises(ValueError, match="float32"):  # the dispatch does not cast
        ops_expm(expm_inputs(2, 8, 1.0, gen, dev).double())


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,lod,K", [
    (64, 72, 16, 15),  # the CRU preset at serving shape
    (3, 9, 4, 5),      # a small Van Loan block, zero-padded to 64
    (2, 5, 1, 1),
    (1, 40, 16, 32),   # the most bases the softmax warp takes
])
def test_cru_scan_kernel_matches_plain(dev, gen, B, T, lod, K):
    ins = scan_inputs(B, T, lod, K, gen, dev)
    before = cru_scan.launches
    got = cru_scan.fused_cru_scan(**ins)
    torch.cuda.synchronize()
    assert cru_scan.launches == before + 1
    print(f"scores at {(B, T, lod, K)}:",
          {k: (round(v["score"], 3), round(v["plain_score"], 3))
           for k, v in check_scan(got, ins).items()})


@pytest.mark.cuda
def test_cru_scan_kernel_refuses_what_it_cannot_take(dev, gen):
    with pytest.raises(ValueError, match="exceed"):
        cru_scan.fused_cru_scan(**scan_inputs(2, 4, 17, 3, gen, dev))
    with pytest.raises(ValueError, match="exceed"):
        cru_scan.fused_cru_scan(**scan_inputs(2, 4, 4, 33, gen, dev))
    ins = scan_inputs(2, 4, 4, 3, gen, dev)
    with pytest.raises(ValueError, match="float32"):
        cru_scan.fused_cru_scan(**dict(ins, y_var=ins["y_var"].double()))
