#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels #1-#7 of one checkout on one CUDA
card, at the main paths' shapes.

    python tools/torch_kernel_ab.py [--root DIR] [--tag NAME] [--save FILE]
                                    [--against FILE]

DIR is the root of a checkout of this repository (default: the one this
script lies in); its `chip_smoke.py` and `imm_tsf_torch/` are imported, and
its kernels built, from there, so the same inputs (seeded as chip_smoke
seeds them) go through that checkout's kernels. To compare two commits, run
it for each in turns on one card (A, B, B, A). Prints one JSON line:
{"tag", "root", "device", "power", "recavg_ms": {shape: ms}, "ffn_ms",
"attn": {shape: ms}, "frechet_ms", "expm_ms", "expm_dense_ms", "scan_ms",
"scan_bwd_ms"}: device ms (chip_smoke.device_ms) of #1 at the serving
shape [B 64, N 8, T 24, d 768] and the PatchTST training shape [32, 8, 36,
768], #2 at M 8192, D 512, F 2048 (gelu, no
dropout), #3 at each embed_notes bucket call ([rows, 12, T, 64],
right-padded notes), #4 at the trained [32, 64, 64] (one call at each of
chip_smoke's inf-norms 0.01, 0.5, 6 and 80, in turn), #5 at the served
[64, 64, 64] on the 72 Van Loan blocks of the served scan batch (one call
each, in turn; block triangular) and on the dense norm mix of #4, #6 at
the served batch (B 64, T 72, lod 16, K 15) and #7 at the trained one
(B 32). --save writes #5's and #6's outputs on these inputs to FILE
(torch.save); --against FILE adds "max_abs_diff", the largest difference
between those outputs and the ones saved in FILE (another checkout's, on
the same inputs).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

NORMS = (0.01, 0.5, 6.0, 80.0)  # chip_smoke's expm and Frechet checks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", default=None)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from imm_tsf_torch.kernels import attn, cru_scan, expm, ffn, recavg

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           check=True).stdout.strip()
    out = {"tag": args.tag, "root": root, "device": torch.cuda.get_device_name(0),
           "power": power}
    out["recavg_ms"] = {}
    for shape in ((64, 8, 24, 768), (32, 8, 36, 768)):
        sets = [cs.recavg_inputs(*shape, gen, dev) for _ in range(4)]
        out["recavg_ms"][str(list(shape))] = cs.device_ms(recavg.recency_weighted_average, sets,
                                                          per_rep=200)
    sets = [cs.ffn_inputs(8192, 512, 2048, gen, dev) for _ in range(2)]
    out["ffn_ms"] = cs.device_ms(lambda *a: ffn.fused_encoder_ffn(*a, cs.KEEP, "gelu", False),
                                 sets, per_rep=10)
    out["attn"] = {}
    for T in (32, 64, 128, 256, 512, 1024):
        rows = max(64, 32768 // T)
        rows = 1 << (rows - 1).bit_length()
        sets = [cs.attn_inputs(rows, 12, T, 64, gen, dev, cs.bucket_lo(T)) for _ in range(2)]
        out["attn"][f"[{rows},12,{T},64]"] = cs.device_ms(attn.fused_causal_attention, sets,
                                                          per_rep=20 if T <= 128 else 5)
    sets = [list(cs.frechet_inputs(32, 64, norm, gen, dev)) + [cs.MAX_SQUARINGS]
            for norm in NORMS]
    out["frechet_ms"] = cs.device_ms(expm.batched_expm_frechet, sets, per_rep=20)
    dense = [[cs.expm_inputs(64, 64, norm, gen, dev), cs.MAX_SQUARINGS] for norm in NORMS]
    out["expm_dense_ms"] = cs.device_ms(expm.batched_expm, dense, per_rep=20)
    ins = cs.scan_inputs(64, 72, 16, 15, gen, dev)
    blocks = [[M, cs.MAX_SQUARINGS] for M in cs.van_loan_blocks(ins)]
    out["expm_ms"] = cs.device_ms(expm.batched_expm, blocks, per_rep=len(blocks))
    scan_args = list(ins.values())
    out["scan_ms"] = cs.device_ms(cru_scan.fused_cru_scan, [scan_args], per_rep=2)
    bwd_ins = cs.scan_inputs(32, 72, 16, 15, gen, dev)
    residuals, g = cs.scan_bwd_case(bwd_ins, gen)
    out["scan_bwd_ms"] = cs.device_ms(cru_scan.fused_cru_scan_backward,
                                      [list(bwd_ins.values()) + [residuals, g]], per_rep=2)
    outputs = {"expm": torch.stack([expm.batched_expm(*a) for a in blocks]),
               "expm_dense": torch.stack([expm.batched_expm(*a) for a in dense]),
               "scan": torch.cat([torch.cat([o.flatten() for o in (s[0], *s[1])])
                                  for s in [cru_scan.fused_cru_scan(*scan_args)]])}
    if args.save:
        torch.save({k: v.cpu() for k, v in outputs.items()}, args.save)
    if args.against:
        other = torch.load(args.against)
        out["max_abs_diff"] = {k: float((v.cpu() - other[k]).abs().max())
                               for k, v in outputs.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
