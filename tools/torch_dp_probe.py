"""Probe the data-parallel collectives of the port's trainer on the card.

    python tools/torch_dp_probe.py [--params N] [--reps 20]

Prints the card (`nvidia-smi` name and power limit), then one JSON line:

- "nccl_world_1": one all-reduce of a float32 [N] buffer (the flat gradient
  buffer of parallel/mesh.DataMesh.sum_gradients; N defaults to the
  parameter count of chip_smoke's 14a PatchTST + TTF_RecAvg + MMF_GR_Add
  run) in a process group of one rank over NCCL: device ms by CUDA events
  (chip_smoke.device_ms), and whether a CUDA graph captures it and its
  replay gives the same sum;
- "gloo_shared_card": two rank processes on the one card over gloo, each
  all-reducing a CUDA tensor [N] (what `--mesh_shape 2 --share_card`
  does): whether gloo takes CUDA tensors, the result's device and its
  values against the expected sum, and the host ms of one all-reduce
  (synchronized; median of `--reps`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def patch_param_count() -> int:
    """Trainable parameters of chip_smoke's 14a experiment (PatchTST at its
    preset widths with the fusion pair on 768-d notes), on its fixture."""
    import tempfile

    import chip_smoke as cs
    from imm_tsf_torch.fusion.fusion_model import FusionModel
    from imm_tsf_torch.models import get_model
    from imm_tsf_torch.training.optim import trainable_parameters

    with tempfile.TemporaryDirectory() as root:
        cs.make_synthetic_dataset(os.path.join(root, "EPA-Air"), **cs.TRAIN_DATA)
        cfg = cs.training_data(root, cs.PATCH_TRAIN_ARGS + cs.PATCH_ROUTES["kernel"])["cfg"]
    model, fusion = get_model(cfg), FusionModel(cfg, d_notes=cfg.d_txt)
    return sum(p.numel() for p in trainable_parameters(model, fusion))


def gloo_rank(device, n: int, reps: int) -> dict:
    """One rank of the shared-card world: all-reduce a CUDA tensor."""
    import torch.distributed as dist

    rank = dist.get_rank()
    x = torch.full((n,), float(rank + 1), device=device)
    out = {"device": str(device), "backend": dist.get_backend()}
    try:
        dist.all_reduce(x)
        torch.cuda.synchronize(device)
    except Exception as e:  # noqa: BLE001 -- what gloo did is the finding
        return dict(out, ok=False, error=f"{type(e).__name__}: {e}")
    want = float(sum(r + 1 for r in range(dist.get_world_size())))
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        dist.all_reduce(x)
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(out, ok=True, result_device=str(x.device), equal_to_sum=bool(
        (x == want * dist.get_world_size() ** reps).all()), host_ms_median=float(np.median(ms)),
        host_ms=ms)


def nccl_world_1(n: int) -> dict:
    import chip_smoke as cs
    import torch.distributed as dist

    from imm_tsf_torch.parallel.mesh import free_port, init_distributed

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    init_distributed(1, 0, free_port(), "nccl", device)
    flat = torch.randn(n, device=device)
    out = {"params": n, "ms": cs.device_ms(lambda: dist.all_reduce(flat), [[]], per_rep=20)}
    # captured: the trainer's captured steps hold this all-reduce
    static = torch.randn(n, device=device)
    want = static.clone()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        dist.all_reduce(static)  # warm up on the capture stream
    torch.cuda.current_stream(device).wait_stream(stream)
    static.copy_(want)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        dist.all_reduce(static)
    static.copy_(want)
    graph.replay()
    torch.cuda.synchronize(device)
    out["captured_replay_equal"] = bool(torch.equal(static, want))
    dist.destroy_process_group()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("torch_dp_probe")
    ap.add_argument("--params", type=int, default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    n = args.params or patch_param_count()
    from imm_tsf_torch.parallel.multiproc import launch

    out = {"card": smi, "nccl_world_1": nccl_world_1(n)}
    out["gloo_shared_card"] = launch(gloo_rank, 2, (n, args.reps), device="cuda",
                                     share_card=True, timeout=600)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
