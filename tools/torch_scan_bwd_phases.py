#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's CRU scan backward (kernel #7,
`imm_tsf_torch/csrc/cru_scan_bwd.cu`) spends a step, on one CUDA card.

    python tools/torch_scan_bwd_phases.py [--batch 32] [--steps 72]

Builds an instrumented copy of the kernel (clock64() read by thread 0 of the
first CTA at the phase boundaries below, summed over the steps) into
`imm_tsf_torch/_build/phases/`, runs it at the CRU preset's widths (lod 16,
K 15) on chip_smoke's scan inputs for each cluster size, and prints one
JSON line per size: the call's device ms, each phase's SM cycles per step
and its share of the first CTA's cycles (when every cluster runs at once,
that CTA spans the call, and share x ms is the phase's time). The compiler
may move work across the clock reads, so the split between neighbouring
phases is approximate. The copy is made by inserting the reads at lines
of the source; if one of those lines changed, the script raises.

Phases: `scalar` (residual loads, Kalman update, softmax), `bm` (Bm
assembly), `expm`, `ge` (gE assembly, covariance and mean adjoints),
`bmt` (Bm^T assembly), `frechet`, `h` (H and gq), `gc_ga` (gc, gA and the
cluster barrier), `tail` (softmax and coefficient-net adjoints, the Kalman
update's adjoint).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("scalar", "bm", "expm", "ge", "bmt", "frechet", "h", "gc_ga", "tail")
STAMP = ("  if (tid == 0) { long long now = clock64(); prof_acc[{i}] += now - prof_last;"
         " prof_last = now; }")
# (line of the source, what goes before it or after it)
EDITS = (
    ("int a_in_smem) {\n  using Team",
     "int a_in_smem, long long* prof) {\n  long long prof_acc[9] = {0}, prof_last = clock64();\n"
     "  using Team"),
    ("    if (tid < 32) cru::coefficients(pm, W_s, b_s, coeff, lsd, K);\n    __syncthreads();\n",
     "    if (tid < 32) cru::coefficients(pm, W_s, b_s, coeff, lsd, K);\n    __syncthreads();\n"
     + STAMP.replace("{i}", "0") + "\n"),
    ("    expm::expm_inplace<Team>(e, red, max_squarings);\n",
     STAMP.replace("{i}", "1") + "\n    expm::expm_inplace<Team>(e, red, max_squarings);\n"
     + STAMP.replace("{i}", "2") + "\n"),
    ("    Team::sync();  // E is used up in every CTA\n",
     "    Team::sync();  // E is used up in every CTA\n" + STAMP.replace("{i}", "3") + "\n"),
    ("    expm::frechet_inplace<Team>(e, red, max_squarings);\n",
     STAMP.replace("{i}", "4") + "\n    expm::frechet_inplace<Team>(e, red, max_squarings);\n"
     + STAMP.replace("{i}", "5") + "\n"),
    ("    if (tid < lsd) gq_s[tid] += e1[tid * expm::kLd + lsd + tid] * dt;\n"
     "    __syncthreads();\n",
     "    if (tid < lsd) gq_s[tid] += e1[tid * expm::kLd + lsd + tid] * dt;\n"
     "    __syncthreads();\n" + STAMP.replace("{i}", "6") + "\n"),
    ("    Team::sync();  // gc complete in every CTA; gBm and H read before the next step writes\n",
     "    Team::sync();  // gc complete in every CTA; gBm and H read before the next step writes\n"
     + STAMP.replace("{i}", "7") + "\n"),
    ("      gcs[i] = gcs_p;\n    }\n    __syncthreads();\n  }\n",
     "      gcs[i] = gcs_p;\n    }\n    __syncthreads();\n" + STAMP.replace("{i}", "8")
     + "\n  }\n  if (tid == 0 && blockIdx.x == 0)\n"
     "    for (int i = 0; i < 9; ++i) prof[i] = prof_acc[i];\n"),
    ("int lod, int K, int max_squarings, int cluster, void* stream) {",
     "int lod, int K, int max_squarings, int cluster, void* stream, long long* prof) {"),
    ("gW, gb, gA, gq, gicu, gicl, T, lod, K, max_squarings, a_flag",
     "gW, gb, gA, gq, gicu, gicl, T, lod, K, max_squarings, a_flag, prof"),
)


def build() -> str:
    csrc = os.path.join(REPO, "imm_tsf_torch", "csrc")
    src = open(os.path.join(csrc, "cru_scan_bwd.cu")).read()
    for line, new in EDITS:
        if src.count(line) != 1:
            raise RuntimeError(f"cru_scan_bwd.cu changed: no single line {line!r} to instrument")
        src = src.replace(line, new)
    out = os.path.join(REPO, "imm_tsf_torch", "_build", "phases")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "cru_scan_bwd_phases.cu"), "w") as f:
        f.write(src)
    nvcc = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "nvcc")
    lib = os.path.join(out, "libcru_scan_bwd_phases.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", f"-I{csrc}", "-o", lib,
                    os.path.join(out, "cru_scan_bwd_phases.cu")], check=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=72)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_bwd_phases: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from imm_tsf_torch.kernels import cru_scan

    lib = ctypes.CDLL(build())
    fn = lib.cru_scan_backward
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    B, T, lod, K = args.batch, args.steps, 16, 15
    ins = cs.scan_inputs(B, T, lod, K, gen, dev)
    residuals, g = cs.scan_bwd_case(ins, gen)
    kin = (cru_scan._kernel_inputs(list(ins.values()))[:8]
           + [t.contiguous() for t in (*residuals, g)])
    empty = lambda *s: torch.empty(s, device=dev)
    outs = [empty(B, T, lod), empty(B, T, lod), empty(B, 2 * lod, K), empty(B, K),
            empty(B, K, 2 * lod, 2 * lod), empty(B, 2 * lod), empty(B, lod), empty(B, lod)]
    stream = torch.cuda.current_stream().cuda_stream
    for C in cru_scan.CLUSTER_SIZES:
        prof = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
        for _ in range(3):  # the last call's clocks and time are kept
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*(t.data_ptr() for t in kin + outs), B, T, lod, K, cs.MAX_SQUARINGS, C,
                    stream, prof.data_ptr())
            end.record()
            torch.cuda.synchronize()
            if rc != 0:
                raise RuntimeError(f"cru_scan_backward (instrumented): cudaError_t {rc}")
        cycles = prof.tolist()
        print(json.dumps({"batch": B, "steps": T, "cluster": C, "ms": start.elapsed_time(end),
                          "cycles_per_step": {p: c / T for p, c in zip(PHASES, cycles)},
                          "share": {p: c / sum(cycles) for p, c in zip(PHASES, cycles)}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
