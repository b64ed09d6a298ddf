#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels #2-#7 of one checkout on one CUDA
card, at the main paths' shapes.

    python tools/torch_kernel_ab.py [--root DIR] [--tag NAME]

DIR is the root of a checkout of this repository (default: the one this
script lies in); its `chip_smoke.py` and `imm_tsf_torch/` are imported, and
its kernels built, from there, so the same inputs (seeded as chip_smoke
seeds them) go through that checkout's kernels. To compare two commits, run
it for each in turns on one card (A, B, B, A). Prints one JSON line:
{"tag", "root", "device", "ffn_ms", "attn": {shape: ms}, "frechet_ms",
"expm_ms", "scan_ms", "scan_bwd_ms"}: device ms (chip_smoke.device_ms) of
#2 at M 8192, D 512, F 2048 (gelu, no dropout), #3 at each embed_notes
bucket call ([rows, 12, T, 64], right-padded notes), #4 at the trained
[32, 64, 64] and #5 at the served [64, 64, 64] (one call at each of
chip_smoke's inf-norms 0.01, 0.5, 6 and 80, in turn), #6 at the served
batch (B 64, T 72, lod 16, K 15) and #7 at the trained one (B 32).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

NORMS = (0.01, 0.5, 6.0, 80.0)  # chip_smoke's expm and Frechet checks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from imm_tsf_torch.kernels import attn, cru_scan, expm, ffn

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    out = {"tag": args.tag, "root": root, "device": torch.cuda.get_device_name(0)}
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
    sets = [[cs.expm_inputs(64, 64, norm, gen, dev), cs.MAX_SQUARINGS] for norm in NORMS]
    out["expm_ms"] = cs.device_ms(expm.batched_expm, sets, per_rep=20)
    ins = cs.scan_inputs(64, 72, 16, 15, gen, dev)
    out["scan_ms"] = cs.device_ms(cru_scan.fused_cru_scan, [list(ins.values())], per_rep=2)
    ins = cs.scan_inputs(32, 72, 16, 15, gen, dev)
    residuals, g = cs.scan_bwd_case(ins, gen)
    out["scan_bwd_ms"] = cs.device_ms(cru_scan.fused_cru_scan_backward,
                                      [list(ins.values()) + [residuals, g]], per_rep=2)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
