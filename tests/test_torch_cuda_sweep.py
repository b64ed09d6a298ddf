"""A sweep's replicas replayed at once on the card (imm_tsf_torch/
training/vmap_sweep.py): two replicas' captured PatchTST steps, each on
its own graphs.StepLoop stream over one shared store and row table,
replayed concurrently (graphs.interleave: one batch's steps of both back
to back) equal the same replays run one replica after the other, bit for
bit: losses, parameters and launch counts.

Marked `cuda`; it skips without a card. It imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_sweep.py -q
"""

import pytest
import torch

from imm_tsf_torch.kernels import ffn, recavg

STEPS = 4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _replica(dev, seed: int, lr: float):
    """PatchTST + TTF_RecAvg + MMF_GR_Add on the kernel route (#1, #2's
    training form, hash dropout 0.1), built under torch.manual_seed(seed),
    its own salts and Adam at lr, on a captured StepLoop."""
    from imm_tsf_torch.config import Config
    from imm_tsf_torch.training.graphs import StepLoop
    from imm_tsf_torch.training.trainer import build_run, make_forward, make_grad_step, \
        make_loss_fn

    cfg = Config(model="PatchTST", input_dim=4, input_len=24, pred_len=12, d_model=128,
                 d_ff=256, n_heads=2, e_layers=1, dropout=0.1, enable_text=True,
                 use_text_embeddings=True, d_txt=32, TTF_module="TTF_RecAvg",
                 MMF_module="MMF_GR_Add", use_pallas=True, use_fused_ffn=True, seed=seed, lr=lr)
    model, fusion, gens, params, optimizer = build_run(cfg, {"notes_embeddings":
                                                             torch.zeros(1, 1, 32)}, dev)
    grad_step = make_grad_step(make_loss_fn(make_forward(cfg, model, fusion)), optimizer,
                               params)
    return cfg, grad_step, params, StepLoop(dev, [gens["sample"], gens["z0"]])


def _sweep(dev, concurrent: bool):
    from chip_smoke import headline_batch
    from imm_tsf_torch.training import device_loop
    from imm_tsf_torch.training.graphs import interleave

    reps = [_replica(dev, 0, 1e-3), _replica(dev, 1, 3e-4)]
    store = headline_batch(reps[0][0], 64, torch.Generator().manual_seed(2), dev)
    table = torch.randperm(64, generator=torch.Generator().manual_seed(3)).to(dev)
    select = device_loop.gather(table.reshape(4, 16))
    before = (ffn.train_launches, recavg.launches)
    steps = [loop.train_steps(grad_step, ("test",), store, select, STEPS)
             for _, grad_step, _, loop in reps]
    out = interleave(steps) if concurrent else [interleave([s])[0] for s in steps]
    torch.cuda.synchronize()
    counts = (ffn.train_launches - before[0], recavg.launches - before[1])
    for _, _, _, loop in reps:
        assert loop.replays == STEPS - 1 and len(loop.graphs) == 1
    assert reps[0][3].stream != reps[1][3].stream
    return ([losses.tolist() for losses, skipped in out],
            [[p.detach().clone() for p in params] for _, _, params, _ in reps], counts)


@pytest.mark.cuda
def test_concurrent_replica_replays_equal_sequential_ones(dev):
    l_seq, p_seq, n_seq = _sweep(dev, concurrent=False)
    l_con, p_con, n_con = _sweep(dev, concurrent=True)
    assert l_seq[0] != l_seq[1]  # two distinct experiments
    assert l_con == l_seq
    for reps_con, reps_seq in zip(p_con, p_seq):
        for a, b in zip(reps_con, reps_seq):
            assert torch.equal(a, b)
    assert n_con == n_seq == (2 * STEPS, 2 * STEPS)
