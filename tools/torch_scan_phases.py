#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's fused CRU scan (kernel #6,
`imm_tsf_torch/csrc/cru_scan.cu`) spends a step, on one CUDA card.

    python tools/torch_scan_phases.py [--root DIR] [--batch 64] [--steps 72]

Builds an instrumented copy of the kernel of the checkout at DIR (default:
the one this script lies in; clock64() read by thread 0 of the first CTA
at the phase boundaries below, summed over the steps) into
`<this checkout>/imm_tsf_torch/_build/phases/`, runs it at the CRU
preset's widths (lod 16, K 15) on chip_smoke's scan inputs, and prints
the card's name and power limit, then one JSON line: the call's device
ms, each phase's SM cycles per step and its share of the first block's
cycles (when every block runs at once, that block spans the call, and
share x ms is the phase's time). The compiler may move work across the
clock reads, so the split between neighbouring phases is approximate. The
copy is made by inserting the reads at lines of the source; the script
knows two forms of the kernel (256 threads with the dense expm, and 128
threads with the block-triangular expm) and raises if neither matches.

Phases: `scalar` (residuals, Kalman update, softmax), `bm` (Van Loan
assembly), `expm`, `cov` (the mean and the three covariance diagonals).
The triangular form also splits `scalar` (`fine`): `top` (from the last
step's end to the step's observations, staged every 32 steps), `update`
(residuals, Kalman update and its barrier) and `softmax`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PHASES = ("scalar", "bm", "expm", "cov")
FINE_PHASES = ("top", "update", "softmax", "bm", "expm", "cov")  # the first three: scalar


def stamp(i: int) -> str:
    return ("  if (threadIdx.x == 0) { long long now = clock64(); "
            f"prof_acc[{i}] += now - prof_last; prof_last = now; }}\n")


def prologue(n: int) -> str:
    return f"  long long prof_acc[{n}] = {{0}}, prof_last = clock64();\n"


def epilogue(n: int) -> str:
    return ("  if (threadIdx.x == 0 && blockIdx.x == 0)\n"
            f"    for (int i = 0; i < {n}; ++i) prof[i] = prof_acc[i];\n")


BARRIER = "    __syncthreads();\n"
OUT = "    if (tid < lsd) out"  # after the Kalman update's barrier
SOFTMAX = "    __syncthreads();  // the coefficients\n"
E_LINE = "    const float* E = expm::expm_tri_inplace(e, red, max_squarings);\n"
CARRY = "    __syncthreads();  // the carry\n  }\n"
TOP = "    const float* ob = obs + (t % kChunk) * ow;  // valid, dt, y, yv of step t\n"
ENDS = (
    ("int max_squarings, void* stream) {",
     "int max_squarings, void* stream, long long* prof) {"),
    ("res_cu, res_cl, res_cs, T, lod, K,\n      max_squarings);",
     "res_cu, res_cl, res_cs, T, lod, K,\n      max_squarings, prof);"),
)

# (line of the source, what replaces it), for each form of the kernel
FORMS = {
    # one 256-thread block a sample, dense expm (the design before the triangular form)
    "block": dict(phases=PHASES, edits=(
        ("int T, int lod, int K, int max_squarings) {\n  extern __shared__",
         "int T, int lod, int K, int max_squarings, long long* prof) {\n" + prologue(4)
         + "  extern __shared__"),
        ("    if (tid < 32) cru::coefficients(pm, W_s, b_s, coeff, lsd, K);\n" + BARRIER,
         "    if (tid < 32) cru::coefficients(pm, W_s, b_s, coeff, lsd, K);\n" + BARRIER
         + stamp(0)),
        ("    expm::expm_inplace(e, red, max_squarings);\n",
         stamp(1) + "    expm::expm_inplace(e, red, max_squarings);\n" + stamp(2)),
        ("      (which == 0 ? cu : which == 1 ? cl : cs)[i] = next;\n    }\n" + BARRIER + "  }\n",
         "      (which == 0 ? cu : which == 1 ? cl : cs)[i] = next;\n    }\n" + BARRIER
         + stamp(3) + "  }\n" + epilogue(4)),
    ) + ENDS),
    # one 128-thread block a sample, block-triangular expm
    "triangular": dict(phases=FINE_PHASES, edits=(
        ("int T, int lod, int K, int max_squarings) {\n  constexpr int kT",
         "int T, int lod, int K, int max_squarings, long long* prof) {\n" + prologue(6)
         + "  constexpr int kT"),
        (TOP, TOP + stamp(0)),
        (BARRIER + OUT, BARRIER + stamp(1) + OUT),
        (SOFTMAX, SOFTMAX + stamp(2)),
        (BARRIER + E_LINE, BARRIER + stamp(3) + E_LINE + stamp(4)),
        (CARRY, CARRY[:-4] + stamp(5) + "  }\n" + epilogue(6)),
    ) + ENDS),
}


def instrument(src: str) -> tuple[str, str]:
    """(form, instrumented source) of the first form whose lines all match
    once (the last, the launch, at least once)."""
    for form, spec in FORMS.items():
        edits = spec["edits"]
        counts = [src.count(line) for line, _ in edits[:-1]]
        if all(c == 1 for c in counts) and src.count(edits[-1][0]) >= 1:
            for line, new in edits:
                src = src.replace(line, new)
            return form, src
    raise RuntimeError("cru_scan.cu matches no known form: no lines to instrument")


def build(root: str) -> tuple[str, str]:
    csrc = os.path.join(root, "imm_tsf_torch", "csrc")
    form, src = instrument(open(os.path.join(csrc, "cru_scan.cu")).read())
    out = os.path.join(REPO, "imm_tsf_torch", "_build", "phases")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"cru_scan_phases_{form}.cu")
    with open(path, "w") as f:
        f.write(src)
    nvcc = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "nvcc")
    lib = os.path.join(out, f"libcru_scan_phases_{form}.so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", f"-I{csrc}", "-o", lib, path], check=True)
    return form, lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=72)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_phases: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from imm_tsf_torch.kernels import cru_scan

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    form, path = build(root)
    phases = FORMS[form]["phases"]
    fn = ctypes.CDLL(path).cru_scan_forward
    fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    B, T, lod, K = args.batch, args.steps, 16, 15
    ins = cs.scan_inputs(B, T, lod, K, gen, dev)
    kin = cru_scan._kernel_inputs(list(ins.values()))
    empty = lambda *s: torch.empty(s, device=dev)
    outs = [empty(B, T, 2 * lod), empty(B, T, 2 * lod), empty(B, T, lod), empty(B, T, lod),
            empty(B, T, lod)]
    stream = torch.cuda.current_stream().cuda_stream
    prof = torch.zeros(len(phases), dtype=torch.int64, device=dev)
    for _ in range(3):  # the last call's clocks and time are kept
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        rc = fn(*(t.data_ptr() for t in kin + outs), B, T, lod, K, cs.MAX_SQUARINGS, stream,
                prof.data_ptr())
        end.record()
        torch.cuda.synchronize()
        if rc != 0:
            raise RuntimeError(f"cru_scan_forward (instrumented): cudaError_t {rc}")
    cycles = dict(zip(phases, prof.tolist()))
    fine = None
    if phases == FINE_PHASES:
        fine = cycles
        cycles = {"scalar": sum(cycles[p] for p in FINE_PHASES[:3]),
                  **{p: cycles[p] for p in PHASES[1:]}}
    total = sum(cycles.values())
    row = {"root": root, "form": form, "batch": B, "steps": T, "ms": start.elapsed_time(end),
           "cycles_per_step": {p: c / T for p, c in cycles.items()},
           "share": {p: c / total for p, c in cycles.items()}}
    if fine:
        row["fine_cycles_per_step"] = {p: c / T for p, c in fine.items()}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
