"""The launch plan of the port's cluster kernels (#4, #7) and the rule by
which the batched expm (#5) picks its form, on the CPU (no card needed).

- `_cluster.cluster_size` with the counts of an H100 (132 / 66 / 30
  resident clusters of 1 / 2 / 4 CTAs, one CTA an SM), and
  `cluster_plan`'s SMs in use.
- `expm.takes_triangular`, the plain helper beside the wrappers that
  `chip_smoke.expm_work` counts the bound with: true on the CRU's Van Loan
  blocks from `ops.cru_scan` at lsd 32 and lsd <= 16 and on any
  zero-padded n <= 32, false at 16 < lsd < 32, on dense draws and wherever
  the lower-left 32 x 32 block holds a nonzero or a NaN.
- The fused scan's (#6) layout of the Van Loan block at 32-offsets: a
  symmetric permutation whose lower-left 32 x 32 block is zero at every
  lsd <= 32, and whose expm holds E_A and M2 where the kernel reads them.
"""

import contextlib

import pytest
import torch

import chip_smoke
from imm_tsf_torch.kernels import _cluster, expm
from imm_tsf_torch.kernels._cluster import cluster_size
from imm_tsf_torch.ops import cru_scan as cru_ops

torch.set_num_threads(1)

ONE_A_SM = {1: 132, 2: 66, 4: 30}  # #4 and #7 on an H100: one CTA an SM


@pytest.mark.parametrize("B,want", [
    (1, 4), (16, 4), (30, 4),
    (31, 2), (32, 2), (64, 2), (66, 2),  # clusters of 4 would run two waves
    (67, 4),   # three waves of clusters of 4 (3/4) beat one of clusters of 1
    (132, 1), (264, 1), (0, 1),
])
def test_cluster_size_at_one_cta_an_sm(B, want):
    assert cluster_size(B, ONE_A_SM) == want


@pytest.mark.parametrize("B,want", [
    (16, {"cluster": 4, "sms_in_use": 64}),
    (32, {"cluster": 2, "sms_in_use": 64}),
    (64, {"cluster": 2, "sms_in_use": 128}),
    (132, {"cluster": 1, "sms_in_use": 132}),
    (300, {"cluster": 2, "sms_in_use": 132}),
])
def test_cluster_plan_counts_sms(monkeypatch, B, want):
    """The plan's SMs in use never pass the SMs its resident clusters span."""
    monkeypatch.setattr(torch.cuda, "device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(_cluster, "_active", {})
    plan = _cluster.cluster_plan(B, "cuda:0", "test", (B,), ONE_A_SM.__getitem__)
    assert {k: plan[k] for k in want} == want
    assert plan["ctas"] == B * plan["cluster"]
    assert plan["sms_in_use"] <= 132


def _van_loan_blocks(lod: int, K: int, seed: int) -> torch.Tensor:
    """Every step's Van Loan block of a scan over chip_smoke's scan inputs,
    recorded from ops.cru_scan's default route."""
    gen = torch.Generator().manual_seed(seed)
    ins = chip_smoke.scan_inputs(4, 12, lod, K, gen, torch.device("cpu"))
    blocks = []

    def record(M, max_squarings):
        blocks.append(M)
        return chip_smoke.expm_taylor12(M, max_squarings)

    cru_ops._scan_steps(**ins, max_squarings=7, expm_fn=record)
    return torch.cat(blocks)


@pytest.mark.parametrize("lod,K", [(16, 15), (16, 1), (8, 5), (4, 5), (1, 1), (12, 15), (9, 3)])
def test_van_loan_blocks_take_the_triangular_form(lod, K):
    """At lsd 32 and lsd <= 16 the batched expm's Van Loan blocks are
    triangular once zero-padded; in between, -A^T crosses row 32 and they
    take the dense form."""
    blocks = _van_loan_blocks(lod, K, seed=lod + K)
    assert blocks.shape[1:] == (4 * lod, 4 * lod)
    assert bool(expm.takes_triangular(blocks).all()) == (lod == 16 or lod <= 8)
    if lod == 16:  # the lower-left block itself is what makes it so
        assert bool((blocks[:, 32:, :32] == 0).all()) and bool((blocks[:, :32, :32] != 0).any())


def _at_32_offsets(blocks: torch.Tensor, lsd: int) -> torch.Tensor:
    """The Van Loan blocks [..., 2lsd, 2lsd] as csrc/cru_scan.cu lays them
    out in 64 x 64: index i < lsd stays, lsd + j goes to 32 + j."""
    idx = torch.cat([torch.arange(lsd), 32 + torch.arange(lsd)])
    out = blocks.new_zeros(blocks.shape[:-2] + (64, 64))
    out[..., idx[:, None], idx[None, :]] = blocks
    return out


@pytest.mark.parametrize("lod", [1, 4, 8, 9, 12, 15, 16])
def test_van_loan_blocks_at_32_offsets_are_triangular_at_every_lsd(lod):
    """#6's layout: the lower-left block is zero at every lsd <= 32, and
    exp of the permuted block holds E_A at [:lsd, :lsd] and M2 at
    [:lsd, 32:32 + lsd], as exp of the block itself does at [:lsd, :lsd]
    and [:lsd, lsd:]."""
    lsd = 2 * lod
    blocks = _van_loan_blocks(lod, 15, seed=lod).double()
    moved = _at_32_offsets(blocks, lsd)
    assert bool(expm.takes_triangular(moved).all())
    assert bool((moved[:, 32:, :32] == 0).all())
    E = torch.linalg.matrix_exp(blocks)
    Em = torch.linalg.matrix_exp(moved)
    torch.testing.assert_close(Em[:, :lsd, :lsd], E[:, :lsd, :lsd], rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(Em[:, :lsd, 32:32 + lsd], E[:, :lsd, lsd:], rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("n", [1, 24, 32])
def test_zero_padded_small_matrices_take_the_triangular_form(n):
    M = torch.randn((5, n, n), generator=torch.Generator().manual_seed(n))
    assert bool(expm.takes_triangular(M).all())


@pytest.mark.parametrize("n", [33, 48, 63, 64])
def test_dense_draws_take_the_dense_form(n):
    M = torch.randn((5, n, n), generator=torch.Generator().manual_seed(n))
    assert not bool(expm.takes_triangular(M).any())


def test_one_lower_left_entry_or_nan_takes_the_dense_form():
    M = torch.randn((4, 64, 64), generator=torch.Generator().manual_seed(0))
    M[:, 32:, :32] = 0.0
    M[1, 63, 0] = 1e-30
    M[2, 32, 31] = float("nan")
    M[3, 40, 10] = -0.0  # == 0: still triangular
    assert expm.takes_triangular(M).tolist() == [True, False, False, True]


def test_expm_work_counts_n_cubed_a_triangular_product():
    M = torch.randn((2, 64, 64), generator=torch.Generator().manual_seed(1))
    M = M / M.abs().sum(-1).amax(-1)[:, None, None] * 0.5  # Taylor-12, no squaring
    M[0, 32:, :32] = 0.0
    nbytes, flops = chip_smoke.expm_work(M)
    assert nbytes == 8 * 2 * 64 * 64
    assert flops == 5 * 64 ** 3 + 5 * 2 * 64 ** 3
