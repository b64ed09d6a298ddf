"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a card: a CUDA kernel
has no CPU mode. This file imports no JAX, so it runs on a machine that
has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: float32 with another summation order, |err| <= 1e-4 +
1e-4|ref| for the FFN (K=2048 sums, 3xTF32 products), 1e-5 + 1e-5|ref|
for the recency average (N-term sums), 2e-5 + 1e-5|ref| for the causal
attention (online softmax against the plain two-pass softmax) and for its
backward's dq, dk and dv against autograd of the plain forward; the expm
to 1e-5 of each matrix's largest entry (tiered Taylor against Taylor-12,
up to 7 squarings); its Frechet derivative to 2e-5 of each matrix's
largest entry (tests/test_ops_expm.py:117), at each cluster size; the
fused CRU scan and its backward against their plain versions run in
float64, to 2.5 x (1e-4 + 1e-4|ref|) and SCAN_BWD_SCORE_MAX x (1e-5
max|ref| + 1e-5|ref|) (chip_smoke.check_scan and check_scan_bwd: T Kalman
steps whose float32 rounding alone passes 1e-4 + 1e-4|ref|)."""

import os

import pytest
import torch

from chip_smoke import (IMTS_MODELS, MTS_MODELS, RESUME_ARGS, TRAIN_DATA, attn_inputs,
                        attn_ragged_inputs, bucket_lo, check_attn_backward, check_scan,
                        check_scan_bwd, compare_step, compare_timellm_step,
                        dropout_probe_inputs, expm_inputs, expm_rel_err, expm_tri_inputs,
                        ffn_inputs, final_weights, frechet_inputs, frechet_rel_err,
                        recavg_inputs, run_imts_serving, run_mts_serving, scan_bwd_case,
                        scan_inputs, training_data)
from imm_tsf_torch.kernels import attn, cru_scan, expm, ffn, recavg
from imm_tsf_torch.llm.loader import EMBED_BUCKETS
from imm_tsf_torch.ops.expm import expm as ops_expm
from imm_tsf_torch.ops.expm import expm_frechet_taylor12, expm_plain, expm_taylor12

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
    (130, 64, 256, "gelu", True),    # one column tile of GEMM2's warps in use
    (100, 256, 2048, "relu", False),
    (77, 30, 70, "relu", True),      # D, F not multiples of 4: 4-byte copies
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
@pytest.mark.parametrize("M,D,F,act,drop", [
    (8192, 512, 2048, "gelu", True),  # the bench headline's PatchTST shape
    (200, 512, 2048, "relu", True),
    (37, 96, 200, "gelu", True),      # ragged D and F: masked columns
    (45, 31, 67, "gelu", True),       # odd D and F: one 4-byte store a column
    (130, 64, 256, "relu", False),
])
def test_ffn_training_form_matches_plain(dev, gen, M, D, F, act, drop):
    """The training form's out, a1 and r against the plain training form."""
    args = ffn_inputs(M, D, F, gen, dev)
    before = (ffn.launches, ffn.train_launches)
    got = ffn._forward(*args, KEEP, act, drop, with_residuals=True)
    torch.cuda.synchronize()
    assert (ffn.launches, ffn.train_launches) == (before[0] + 1, before[1] + 1)
    want = ffn.ffn_forward_reference(*args, KEEP, act, drop, with_residuals=True)
    for name, g, w in zip(("out", "a1", "r"), got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["output", "hidden"])
def test_ffn_training_form_dropout_bits_are_the_hash_bits(dev, gen, site):
    salts = ffn_inputs(8, 8, 8, gen, dev)[-1]
    args, expect = dropout_probe_inputs(300, 512, 1024, site, salts, dev)
    out, _, r = ffn._forward(*args, KEEP, "relu", True, with_residuals=True)
    assert torch.equal(out > 0, expect)
    assert torch.equal(r > 0, expect)


@pytest.mark.cuda
@pytest.mark.parametrize("M,act,drop", [(1000, "gelu", True), (333, "gelu", False),
                                        (333, "relu", True)])
def test_ffn_training_form_gradients_match_plain(dev, gen, M, act, drop):
    """fused_encoder_ffn's gradients: the hand backward on the training
    form's own residuals (the autograd plumbing: each gradient reaches its
    input), and, for the smooth GELU, autograd through the plain forward
    within 1e-4 of each gradient's largest entry. (relu' is a step: where
    the kernel's a1 and the plain a1 straddle 0 within their rounding, a
    whole dh entry moves, so relu is held by the first check only.)"""
    args = ffn_inputs(M, 512, 2048, gen, dev)
    g = torch.randn((M, 512), generator=gen, device=dev)
    params = [a.detach().clone().requires_grad_() for a in args[:7]]
    before = ffn.train_launches
    got = torch.autograd.grad(ffn.fused_encoder_ffn(*params, args[7], KEEP, act, drop),
                              params, g)
    assert ffn.train_launches == before + 1
    _, a1, r = ffn._forward(*args, KEEP, act, drop, with_residuals=True)
    hand = ffn.ffn_backward_reference(args[0], args[1], args[3], args[5], args[7], a1, r, g,
                                      KEEP, act, drop)
    names = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")
    for name, gt, w in zip(names, got, hand):
        torch.testing.assert_close(gt, w, atol=1e-6 * float(w.abs().max()), rtol=1e-6,
                                   msg=lambda m, name=name: f"{name}: {m}")
    if act != "gelu":
        return
    plain = [a.detach().clone().requires_grad_() for a in args[:7]]
    want = torch.autograd.grad(ffn.ffn_reference(*plain, args[7], KEEP, act, drop), plain, g)
    for name, gt, w in zip(names, got, want):
        torch.testing.assert_close(gt, w, atol=1e-4 * float(w.abs().max()), rtol=1e-4,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
def test_ffn_kernel_refuses_what_it_cannot_take(dev, gen):
    args = ffn_inputs(16, 640, 64, gen, dev)
    with pytest.raises(ValueError, match="accumulator"):
        ffn.fused_encoder_ffn(*args, KEEP, "gelu", False)
    args = ffn_inputs(16, 64, 64, gen, dev)
    with pytest.raises(ValueError, match="float32"):
        ffn.fused_encoder_ffn(args[0].double(), *args[1:], KEEP, "gelu", False)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,T,d,empty,offset", [
    (64, 8, 24, 768, False, 0),
    (3, 5, 7, 300, True, 0),
    (2, 70, 9, 1, False, 0),   # notes over several chunks, 4-byte form
    (32, 8, 36, 768, False, 0),  # the PatchTST training shape
    (64, 8, 24, 1024, False, 0),
    (5, 8, 24, 767, True, 0),    # d = 4k + 3: the 4-byte form
    (64, 8, 24, 768, False, 1),  # V 4 bytes off 16-byte alignment: the 4-byte form
    (8, 0, 24, 768, False, 0),   # no notes at all: E = 0
    (4, 70, 24, 768, False, 0),  # several chunks of 32 notes, 16-byte form
    (3, 12, 130, 64, True, 0),   # T over several blocks of times; 16-note chunks
])
def test_recavg_kernel_matches_plain(dev, gen, B, N, T, d, empty, offset):
    args = recavg_inputs(B, N, T, d, gen, dev, empty_sample=empty, offset=offset)
    assert (args[2].data_ptr() % 16 != 0) == (offset != 0)
    before = recavg.launches
    out = recavg.recency_weighted_average(*args)
    torch.cuda.synchronize()
    assert recavg.launches == before + 1
    torch.testing.assert_close(out, recavg.recavg_reference(*args), atol=1e-5, rtol=1e-5)
    if empty:
        assert bool((out[-1] == 0).all())
    if N == 0:
        assert bool((out == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("threads,t_per_block", [(32, 24), (64, 24), (64, 8), (128, 5),
                                                 (32, 64)])
def test_recavg_kernel_at_every_launch_config(dev, gen, threads, t_per_block):
    """The kernel's answer does not depend on how the host cuts the grid."""
    args = recavg_inputs(6, 11, 70, 520, gen, dev, empty_sample=True)
    out = recavg._forward(*args, config=(threads, t_per_block))
    torch.testing.assert_close(out, recavg.recavg_reference(*args), atol=1e-5, rtol=1e-5)
    assert bool((out[-1] == 0).all())
    torch.testing.assert_close(recavg.tiled_forward(*args), recavg.recavg_reference(*args),
                               atol=1e-5, rtol=1e-5)


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
@pytest.mark.parametrize("T", EMBED_BUCKETS)
def test_attn_kernel_at_every_bucket(dev, gen, T):
    """Each embed_notes bucket, right-padded as it pads notes, with enough
    (b, h) slices for several waves of blocks on the card."""
    B, H = max(8, 16384 // T), 12
    args = attn_inputs(B, H, T, 64, gen, dev, bucket_lo(T))
    out = attn.fused_causal_attention(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, attn.attention_reference(*args), atol=2e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,T,D,lo", [
    (5, 3, 1, 64, None),     # one token: four (b, h) slices a block
    (7, 3, 31, 64, 1),       # two slices a block, one row short of the tile
    (7, 3, 33, 64, 1),       # one slice a block, 64-row tiles
    (3, 5, 65, 64, 2),       # two query tiles, the second one row
    (9, 3, 16, 128, 1),      # four slices a block at the 128-column width
    (4, 3, 32, 128, 1),      # two slices a block at the 128-column width
    (2, 2, 1024, 128, 513),  # the 128-column width at the longest bucket
])
def test_attn_kernel_at_edge_lengths(dev, gen, B, H, T, D, lo):
    args = attn_inputs(B, H, T, D, gen, dev, lo)
    out = attn.fused_causal_attention(*args)
    torch.cuda.synchronize()
    assert out.shape == (B, H, T, D)
    torch.testing.assert_close(out, attn.attention_reference(*args), atol=2e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("T", [5, 29, 200])
def test_attn_kernel_fully_masked_rows_are_exact_zeros(dev, gen, T):
    """Rows before a sample's first real token and samples without one:
    exact zeros, at each block layout (4, 2 and 1 slices a block)."""
    q, k, v, pad = attn_inputs(6, 4, T, 64, gen, dev)
    pad[0, :3] = 0.0
    pad[1] = 0.0
    pad[2, T // 2:] = 0.0
    out = attn.fused_causal_attention(q, k, v, pad)
    torch.cuda.synchronize()
    assert bool((out[0, :, :3] == 0).all()) and bool((out[1] == 0).all())
    torch.testing.assert_close(out, attn.attention_reference(q, k, v, pad), atol=2e-5, rtol=1e-5)


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
@pytest.mark.parametrize("shape", [
    (32, 12, 68, 64),   # TimeLLM's fast prompt as trained (36 + 4 patches x 8)
    (32, 12, 160, 64),  # its exact prompt (128 + 32)
    (4, 3, 13, 16),     # a narrow head
    None,               # ragged: token 0 padded in one sample, none real in another
])
def test_attn_backward_matches_autograd_of_plain(dev, gen, shape):
    args = attn_inputs(*shape, gen, dev) if shape else attn_ragged_inputs(gen, dev)
    g = torch.randn(args[0].shape, generator=gen, device=dev)
    launches, calls = attn.launches, attn.backward_calls
    _, (dq, dk, dv) = check_attn_backward(args, g)  # raises beyond 2e-5 + 1e-5|ref|
    torch.cuda.synchronize()
    assert (attn.launches, attn.backward_calls) == (launches + 1, calls + 1)
    if shape is None:
        for d in (dq, dk, dv):
            assert bool((d[0, :, 0] == 0).all()) and bool((d[1] == 0).all())


@pytest.mark.cuda
def test_timellm_step_kernel_route_matches_plain(dev):
    """One full-width TimeLLM step (the preset, 6 GPT-2 blocks, B 32):
    kernel route vs plain vs float64, exact launch counts
    (chip_smoke.compare_timellm_step raises otherwise)."""
    out = compare_timellm_step(dev)
    assert out["launches"]["fused_causal_attention"] == 6
    assert out["launches"]["fused_causal_attention_backward"] == 6


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
@pytest.mark.parametrize("B,n,norm,form", [
    (1, 64, 6.0, "dense"),
    (1, 64, 6.0, "triangular"),
    (3, 64, 80.0, "triangular"),  # 7 squarings: the result ends in buffer 4
    (3, 64, 0.01, "triangular"),  # Taylor-4
    (64, 64, 0.5, "triangular"),
    (64, 64, 80.0, "dense"),
    (3, 24, 3.0, "dense"),        # n <= 32 is always triangular once padded
    (5, 1, 2.0, "dense"),
    (2, 63, 1.5, "dense"),
    (2, 63, 1.5, "triangular"),
])
def test_expm_kernel_in_each_form(dev, gen, B, n, norm, form):
    """The dense and the block-triangular form: the same function."""
    M = (expm_tri_inputs if form == "triangular" else expm_inputs)(B, n, norm, gen, dev)
    assert bool(expm.takes_triangular(M).all()) == (form == "triangular" or n <= 32)
    before = expm.launches
    out = expm.batched_expm(M, 7)
    torch.cuda.synchronize()
    assert expm.launches == before + 1
    expm_rel_err(out, expm_taylor12(M, 7))


@pytest.mark.cuda
def test_expm_kernel_one_lower_entry_takes_the_dense_form(dev, gen):
    """A single nonzero in the lower-left 32 x 32 block: the triangular
    form would drop it (an error of its size); the dense form's answer."""
    M = expm_tri_inputs(4, 64, 1.0, gen, dev)
    M[:, 47, 3] = 0.5
    assert not bool(expm.takes_triangular(M).any())
    out = expm.batched_expm(M, 7)
    expm_rel_err(out, expm_taylor12(M, 7))
    M[:, 47, 3] = 0.0
    assert (out - expm_taylor12(M, 7)).abs().max() > 1e-2  # the entry matters


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
    (1, 72, 16, 15),
    (3, 9, 4, 5),      # a small Van Loan block, laid out at 32-offsets
    (3, 20, 12, 15),   # lsd 24: the -A^T block would cross row 32 unpermuted
    (2, 9, 9, 3),
    (2, 9, 15, 7),
    (2, 5, 1, 1),
    (1, 40, 16, 32),   # the most bases the softmax warp takes
    (3, 40, 16, 32),
    (2, 7, 16, 1),
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
@pytest.mark.parametrize("lod", [16, 12, 4])
def test_cru_scan_kernel_holds_its_state_over_pad_steps(dev, gen, lod):
    """A tail of pad steps (dt = 0, invalid) is an exact identity step:
    the post-means and the residual state stay as they were."""
    ins = scan_inputs(4, 12, lod, 15, gen, dev)
    ins["dts"][:, 6:] = 0.0
    ins["valid"][:, 6:] = 0.0
    out, (pm, pcu, pcl, pcs) = cru_scan.fused_cru_scan(**ins)
    for res in (pm, pcu, pcl, pcs):
        assert torch.equal(res[:, 7:], res[:, 6:7].expand_as(res[:, 7:]))
    assert torch.equal(out[:, 7:], out[:, 6:7].expand_as(out[:, 7:]))


@pytest.mark.cuda
def test_cru_scan_kernel_refuses_what_it_cannot_take(dev, gen):
    with pytest.raises(ValueError, match="exceed"):
        cru_scan.fused_cru_scan(**scan_inputs(2, 4, 17, 3, gen, dev))
    with pytest.raises(ValueError, match="exceed"):
        cru_scan.fused_cru_scan(**scan_inputs(2, 4, 4, 33, gen, dev))
    ins = scan_inputs(2, 4, 4, 3, gen, dev)
    with pytest.raises(ValueError, match="float32"):
        cru_scan.fused_cru_scan(**dict(ins, y_var=ins["y_var"].double()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,norm", [
    (32, 64, 0.01),
    (32, 64, 0.5),
    (32, 64, 6.0),   # 3 squarings
    (32, 64, 80.0),  # 7 squarings
    (3, 24, 3.0),    # n < 64: zero-padded in shared memory
    (5, 1, 2.0),
    (2, 63, 1.5),
])
def test_frechet_kernel_matches_plain(dev, gen, B, n, norm):
    M, E = frechet_inputs(B, n, norm, gen, dev)
    before = expm.frechet_launches
    out = expm.batched_expm_frechet(M, E, 7)
    torch.cuda.synchronize()
    assert expm.frechet_launches == before + 1
    assert out.shape == (B, n, n)
    frechet_rel_err(out, expm_frechet_taylor12(M, E, 7))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("B,n,norm", [(1, 64, 6.0), (3, 24, 3.0), (32, 64, 80.0), (32, 24, 0.5)])
def test_frechet_kernel_at_each_cluster_size(dev, gen, B, n, norm, cluster):
    """One matrix over 1, 2 or 4 CTAs: the same function; n 24 leaves the
    rows of the last CTAs of a cluster all padding."""
    M, E = frechet_inputs(B, n, norm, gen, dev)
    before = expm.frechet_launches
    out = expm.batched_expm_frechet(M, E, 7, cluster=cluster)
    torch.cuda.synchronize()
    assert expm.frechet_launches == before + 1
    frechet_rel_err(out, expm_frechet_taylor12(M, E, 7))
    plan = expm.frechet_plan(B, dev)
    assert plan["active_by_size"][1] > 0 and plan["cluster"] in (1, 2, 4)


@pytest.mark.cuda
def test_frechet_kernel_at_zero_is_the_direction(dev, gen):
    """L_exp(0)[E] = E exactly: the CRU's pad steps have Bm = 0."""
    E = torch.randn((4, 64, 64), generator=gen, device=dev)
    out = expm.batched_expm_frechet(torch.zeros_like(E), E)
    assert torch.equal(out, E)


@pytest.mark.cuda
def test_frechet_kernel_refuses_what_it_cannot_take(dev, gen):
    M, E = frechet_inputs(2, 65, 1.0, gen, dev)
    with pytest.raises(ValueError, match="exceeds"):
        expm.batched_expm_frechet(M, E)
    M, E = frechet_inputs(2, 8, 1.0, gen, dev)
    with pytest.raises(ValueError, match="float32"):
        expm.batched_expm_frechet(M, E.double())
    with pytest.raises(ValueError, match="float32"):
        expm.batched_expm_frechet(M, E[:1])
    with pytest.raises(ValueError, match="cluster"):
        expm.batched_expm_frechet(M, E, cluster=3)


@pytest.mark.cuda
@pytest.mark.parametrize("norm", [0.01, 0.5, 6.0])
def test_expm_backward_is_the_frechet_kernel(dev, gen, norm):
    """ops.expm.expm on the card: #5 forward, #4 backward; its gradient
    against the plain block-form backward."""
    M = expm_inputs(32, 64, norm, gen, dev)
    G = torch.randn(M.shape, generator=gen, device=dev)
    before = expm.frechet_launches
    Mk = M.clone().requires_grad_()
    (gk,) = torch.autograd.grad((ops_expm(Mk) * G).sum(), Mk)
    torch.cuda.synchronize()
    assert expm.frechet_launches == before + 1
    Mp = M.clone().requires_grad_()
    (gp,) = torch.autograd.grad((expm_plain(Mp) * G).sum(), Mp)
    frechet_rel_err(gk, gp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,lod,K", [
    (32, 72, 16, 15),  # the CRU preset at the trained batch
    (3, 9, 4, 5),      # a small Van Loan block, zero-padded to 64
    (3, 20, 12, 15),   # lsd 24, on #6's residuals
    (2, 5, 1, 1),
    (1, 40, 16, 32),   # the most bases: A_k read from device memory
])
def test_cru_scan_bwd_kernel_matches_plain(dev, gen, B, T, lod, K):
    ins = scan_inputs(B, T, lod, K, gen, dev)
    residuals, g = scan_bwd_case(ins, gen)
    before = cru_scan.backward_launches
    got = cru_scan.fused_cru_scan_backward(**ins, residuals=residuals, g=g)
    torch.cuda.synchronize()
    assert cru_scan.backward_launches == before + 1
    print(f"backward scores at {(B, T, lod, K)}:",
          {k: (round(v["score"], 3), round(v["plain_score"], 3))
           for k, v in check_scan_bwd(got, ins, residuals, g).items()})


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,lod,K,cluster", [
    (1, 72, 16, 15, None),   # one sample: the widest cluster
    (33, 72, 16, 15, 4),     # more clusters of 4 than the card holds at once
    (32, 72, 16, 15, 1),     # each cluster size at the trained batch (A_k staged)
    (32, 72, 16, 15, 2),
    (32, 72, 16, 15, 4),
    (32, 72, 16, 32, None),  # K 32: A_k read from device memory (L2)
    (4, 1, 16, 15, None),    # one step
    (3, 9, 4, 5, 4),         # a small Van Loan block over a cluster of 4
])
def test_cru_scan_bwd_kernel_cluster_sizes(dev, gen, B, T, lod, K, cluster):
    ins = scan_inputs(B, T, lod, K, gen, dev)
    residuals, g = scan_bwd_case(ins, gen)
    plan = cru_scan.cluster_plan(B, lod, K, dev)
    before = cru_scan.backward_launches
    got = cru_scan.fused_cru_scan_backward(**ins, residuals=residuals, g=g, cluster=cluster)
    torch.cuda.synchronize()
    assert cru_scan.backward_launches == before + 1
    print(f"backward at {(B, T, lod, K)}, cluster {cluster or plan['cluster']} (plan {plan}):",
          {k: (round(v["score"], 3), round(v["plain_score"], 3))
           for k, v in check_scan_bwd(got, ins, residuals, g).items()})


@pytest.mark.cuda
def test_cru_scan_bwd_kernel_refuses_what_it_cannot_take(dev, gen):
    ins = scan_inputs(2, 4, 4, 3, gen, dev)
    residuals, g = scan_bwd_case(ins, gen)
    with pytest.raises(ValueError, match="float32"):
        cru_scan.fused_cru_scan_backward(**ins, residuals=residuals, g=g.double())
    with pytest.raises(ValueError, match="float32"):
        cru_scan.fused_cru_scan_backward(**ins, residuals=residuals[:3] + (g,), g=g)
    with pytest.raises(ValueError, match="cluster"):
        cru_scan.fused_cru_scan_backward(**ins, residuals=residuals, g=g, cluster=3)


@pytest.mark.cuda
def test_training_step_on_each_route_kernels_vs_plain(dev, tmp_path):
    """chip_smoke.compare_step on a smaller fixture (4 entities, 120 days):
    exact launch counts of one step on each route, its loss and every
    gradient against the plain path and a float64 plain run."""
    from imm_tsf_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(os.path.join(str(tmp_path), "EPA-Air"),
                           **dict(TRAIN_DATA, n_entities=4, n_days=120))
    data = training_data(str(tmp_path))
    out = compare_step(data["cfg"], data, dev)
    print("one training step:", {r: v["worst_grad"] for r, v in out["routes"].items()})


# ------------------------------------------------------------ Informer
def _decoder_layer(dev, d, F, fused, train):
    from imm_tsf_torch.layers.prob_attention import ProbAttention
    from imm_tsf_torch.layers.transformer import AttentionLayer, DecoderLayer

    torch.manual_seed(0)  # the same weights on both routes
    prob = lambda mask_flag: AttentionLayer(ProbAttention(mask_flag, 3, attention_dropout=0.1),
                                            d, 2)
    layer = DecoderLayer(prob(True), prob(False), d, F, dropout=0.1, use_fused_ffn=fused)
    return layer.to(dev).train(train)


def _reseed(module, dev):
    """The same salts and ProbSparse samples on both routes."""
    from imm_tsf_torch.layers.fast_dropout import Dropout
    from imm_tsf_torch.layers.prob_attention import ProbAttention

    salts, samples = torch.Generator().manual_seed(0), torch.Generator(device=dev).manual_seed(0)
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = salts
        elif isinstance(m, ProbAttention):
            m.generator = samples


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True])
def test_decoder_layer_ffn_kernel_matches_plain(dev, gen, train):
    """DecoderLayer's FFN (ending in norm3) on the kernel route launches #2
    once (its training form with a gradient in flight) and agrees with the
    plain route: output to FFN_TOL, gradients within 1e-4 of the largest."""
    d, F = 512, 2048
    x = torch.randn((8, 24, d), generator=gen, device=dev)
    cross = torch.randn((8, 25, d), generator=gen, device=dev)
    outs, grads, launches = {}, {}, {}
    for fused in (False, True):
        layer = _decoder_layer(dev, d, F, fused, train)
        _reseed(layer, dev)
        ffn.launches = ffn.train_launches = 0
        with torch.set_grad_enabled(train):
            out = layer(x, cross)
            if train:
                (out * out).mean().backward()
                grads[fused] = {n: p.grad for n, p in layer.named_parameters()}
        torch.cuda.synchronize()
        launches[fused] = (ffn.launches, ffn.train_launches)
        outs[fused] = out.detach()
    assert launches == {False: (0, 0), True: (1, int(train))}
    err = (outs[True] - outs[False]).abs()
    assert bool((err <= 1e-4 + 1e-4 * outs[False].abs()).all()), float(err.max())
    if train:
        top = max(float(g.abs().max()) for g in grads[False].values())
        for n, g in grads[False].items():
            assert float((grads[True][n] - g).abs().max()) <= 1e-4 * top, n


@pytest.mark.cuda
def test_fused_route_raises_where_the_kernel_cannot_go(dev, gen):
    """d_model above the kernel's 512 columns: the fused route raises on a
    CUDA tensor instead of running the plain FFN unsaid."""
    layer = _decoder_layer(dev, 640, 1024, True, False)
    x = torch.randn((2, 6, 640), generator=gen, device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        with torch.no_grad():
            layer(x, x)


@pytest.mark.cuda
def test_small_informer_forward_kernels_vs_plain(dev, gen):
    from imm_tsf_torch.config import Config
    from imm_tsf_torch.models import get_model

    kw = dict(model="Informer", input_dim=4, input_len=36, pred_len=12, d_model=128, d_ff=256,
              n_heads=2, e_layers=2, d_layers=1, factor=3)
    B = 16
    mask = (torch.rand((B, 36, 4), generator=gen, device=dev) < 0.8).float()
    ins = (torch.sort(0.5 + 0.5 * torch.rand((B, 12), generator=gen, device=dev), 1).values,
           torch.randn((B, 36, 4), generator=gen, device=dev) * mask,
           torch.sort(0.5 * torch.rand((B, 36), generator=gen, device=dev), 1).values, mask)
    outs = {}
    for fused in (False, True):
        torch.manual_seed(0)
        model = get_model(Config(**kw, use_pallas=fused, use_fused_ffn=fused)).to(dev).eval()
        ffn.launches = 0
        with torch.inference_mode():
            outs[fused] = model(*ins)
        torch.cuda.synchronize()
        assert ffn.launches == (3 if fused else 0)
    err = (outs[True] - outs[False]).abs()
    assert bool((err <= 1e-4 + 1e-4 * outs[False].abs()).all()), float(err.max())


@pytest.mark.cuda
def test_prob_attention_eval_sample_on_the_card_is_the_cpu_sample(dev):
    from imm_tsf_torch.layers.prob_attention import eval_sample

    for L_Q, U, L_K in ((48, 12, 48), (24, 12, 25), (24, 12, 24)):
        got = eval_sample(L_Q, U, L_K, dev)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), eval_sample(L_Q, U, L_K, "cpu"))


# ------------------------------------------------- TimesNet, TimeMixer, TTM
@pytest.mark.cuda
@pytest.mark.parametrize("model", MTS_MODELS)
def test_served_dispatch_kernels_vs_plain(dev, tmp_path, model):
    """chip_smoke.run_mts_serving with 16 requests: the preset at full width
    behind TTF_RecAvg + MMF_GR_Add, #1 exactly once a dispatch, one
    dispatch kernels vs plain to 1e-4 + 1e-4|ref|."""
    out = run_mts_serving(dev, model, 16, 0, str(tmp_path / "exp"))
    assert out["launches"]["recency_weighted_average"] == out["dispatches"] > 0


@pytest.mark.cuda
def test_resumed_run_equals_uninterrupted_on_the_kernel_route(dev, tmp_path):
    """PatchTST + TTF_RecAvg + MMF_GR_Add on the kernel route (#1, #2's
    training form, hash dropout 0.1) on a small fixture (4 entities, 120
    days): one epoch, then `--load` to two, equals two epochs in one run
    bit for bit (per-step losses, val MSEs, final weights)."""
    from imm_tsf_torch import main as train_main
    from imm_tsf_torch.data.synthetic import make_synthetic_dataset

    root = str(tmp_path / "data")
    make_synthetic_dataset(os.path.join(root, "EPA-Air"),
                           **dict(TRAIN_DATA, n_entities=4, n_days=120))
    common = ["--data_root", root, "--save", str(tmp_path / "exp"), "--device", "cuda"]
    whole = train_main.main(RESUME_ARGS[:-2] + ["--epoch", "2"] + common)
    train_main.main(RESUME_ARGS + ["--epoch", "1"] + common)
    resumed = train_main.main(RESUME_ARGS + ["--epoch", "2"] + common)
    assert [h["epoch"] for h in resumed["history"]] == [0, 1]
    for a, b in zip(resumed["history"], whole["history"]):
        assert a["step_losses"] == b["step_losses"] and a["val"] == b["val"]
    got, want = final_weights(resumed), final_weights(whole)
    for mod in want:
        for name, v in want[mod].items():
            assert torch.equal(got[mod][name], v), f"{mod}.{name}"


# ------------------------------------------ LatentODE, NeuralFlow, tPatchGNN
@pytest.mark.cuda
@pytest.mark.parametrize("B,N,T,d", [(32, 8, 768, 768), (32, 12, 96, 768), (64, 8, 16, 768),
                                     (3, 5, 7, 300)])
def test_recavg_kernel_at_the_ode_union_shape(dev, gen, B, N, T, d):
    """#1 as the LatentODE's batches reach it: the ODE collate's 1-D union
    prediction axis, expanded over the batch (a stride-0 view, as TTF_RecAvg
    expands it; the wrapper makes it contiguous)."""
    tau, t_hat, V, mask, sigma = recavg_inputs(B, N, T, d, gen, dev)
    t_hat = torch.sort(t_hat[0]).values[None].expand(B, -1)
    assert t_hat.stride(0) == 0
    before = recavg.launches
    out = recavg.recency_weighted_average(tau, t_hat, V, mask, sigma)
    torch.cuda.synchronize()
    assert recavg.launches == before + 1
    torch.testing.assert_close(out, recavg.recavg_reference(tau, t_hat, V, mask, sigma),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("model", IMTS_MODELS)
def test_imts_served_dispatch_kernels_vs_plain(dev, tmp_path, model):
    """chip_smoke.run_imts_serving with a few requests: the preset behind
    TTF_RecAvg + MMF_GR_Add, #1 exactly once a dispatch (the LatentODE a
    request a dispatch), one dispatch kernels vs plain to 1e-4 +
    1e-4|ref|."""
    out = run_imts_serving(dev, model, 4 if model == "LatentODE" else 16, 0,
                           str(tmp_path / "exp"))
    assert out["launches"]["recency_weighted_average"] == out["dispatches"] > 0
