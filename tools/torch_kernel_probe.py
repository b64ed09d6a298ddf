#!/usr/bin/env python3
"""What bounds kernels #1 (the recency average), #2 (the fused encoder
FFN), #4 (the expm's Frechet derivative) and #5 (the batched expm) of the
PyTorch/CUDA port, on one CUDA card.

    python tools/torch_kernel_probe.py [--only recavg]

Prints one JSON line with:

- `recavg`: #1 at the serving shape [B 64, N 8, T 24, d 768] and the
  PatchTST training shape [32, 8, 36, 768], at each launch config
  (threads a block 32, 64, 128; T cut into 1, 2, 3, 4 or 6 blocks of
  times), each beside an empty kernel launched on the same grid (the
  launch floor), `launch_config`'s choice, the previous design
  (`recavg.tiled_forward`) and `fill_ms`, torch's fill of an E-sized
  tensor (a kernel that only writes E's bytes), and copies of
  `csrc/recavg.cu` built with parts of the work taken out
  (`RECAVG_VARIANTS`: streaming stores; no weights, so no loads of tau,
  t_hat, mask or sigma and no exps; no loads of V; both; the loop over times
  unrolled by 2 or 8 instead of 4; programmatic dependent
  launch, which lets each launch start while the one before it runs),
  each at the default config beside its empty kernel. `--only recavg` stops there.

- `mma_sync_tflops`: the rate of `mma.sync.m16n8k8` TF32 on the card, from
  a kernel that runs nothing else (528 blocks of 8 warps, 8 independent
  accumulators a warp; built from the source below into
  `imm_tsf_torch/_build/probe/`). 3 x 34.4 GFLOP at this rate is the
  floor of #2's 3xTF32 products at M 8192, D 512, F 2048.
- `ffn_ms` and `ffn_without_products_ms`: #2 at that shape (gelu, no
  dropout), and a copy of `csrc/ffn.cu` built with its mma calls taken out
  (weight tiles still streamed, h still written, the epilogue still run):
  the time of everything but the products.
- `frechet_us`: #4 at [B, 64, 64] for B 32 and 64, at inf-norms 0.01, 6 and
  80 (5, 8 and 12 pair products a matrix), at each cluster size: the
  slope over the norms is the time of one pair product and its barrier.
- `expm_us`: #5 at the served [64, 64, 64], dense and block triangular
  draws (its two forms), at inf-norms 0.01, 0.5, 6 and 80 (2, 5, 8 and 12
  products a matrix); `expm_us_per_product`, the least-squares slope over
  those products: one product and its barrier.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MMA_RATE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "tf32x3.cuh"
__global__ void mma_rate(float* out, int iters) {
  float c[8][4];
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = tf32x3::to_tf32(threadIdx.x * 0.001f + i);
  for (int i = 0; i < 2; ++i) b[i] = tf32x3::to_tf32(threadIdx.x * 0.002f + i);
  for (int n = 0; n < 8; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int n = 0; n < 8; ++n) tf32x3::mma_tf32(c[n], a, b);
  }
  float s = 0.f;
  for (int n = 0; n < 8; ++n) s += c[n][0] + c[n][1] + c[n][2] + c[n][3];
  if (s == 12345.f) out[0] = s;  // keeps the products
}
// TFLOP/s of `iters` rounds on 528 blocks of 256 threads
extern "C" double mma_rate_tflops(int iters) {
  float* out;
  cudaMalloc(&out, 4);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  mma_rate<<<528, 256>>>(out, 16);
  cudaEventRecord(e0);
  mma_rate<<<528, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  if (cudaGetLastError() != cudaSuccess) return -1.0;
  return 528.0 * 8 * iters * 8 * 2048.0 / ms / 1e9;
}
"""

# the mma calls of csrc/ffn.cu, taken out of the copy
FFN_PRODUCTS = ("        mma_block<kNT1, kNT1>(acc1, 0, ah, al, bh, bl);\n",
                "          mma_block<4, kNT2>(acc2, n0, ah, al, bh, bl);\n")


def nvcc(src_path: str, out: str, csrc: str) -> None:
    from imm_tsf_torch.kernels import _build

    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-o", out, src_path]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def expm_probe(cs, expm, gen, dev) -> dict:
    """#5 by form and norm, and the slope over products."""
    times, slopes = {}, {}
    products = {0.01: 2, 0.5: 5, 6.0: 8, 80.0: 12}
    for form, inputs in (("dense", cs.expm_inputs), ("triangular", cs.expm_tri_inputs)):
        xs, ys = [], []
        for norm, n in products.items():
            sets = [[inputs(64, 64, norm, gen, dev), cs.MAX_SQUARINGS] for _ in range(2)]
            us = cs.device_ms(expm.batched_expm, sets) * 1e3
            times[f"{form} norm {norm}"] = us
            xs.append(n)
            ys.append(us)
        mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
        slopes[form] = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
                        / sum((x - mx) ** 2 for x in xs))
    return {"expm_us": times, "expm_us_per_product": slopes}


# copies of csrc/recavg.cu with parts of its work taken out or changed, by
# (text, replacement)
RECAVG_STORE = "        *out = acc;\n"
RECAVG_WEIGHTS = ("      const float z = fmaxf(th - tau_k, 0.f) / sigma;\n",
                  "      const float w = expf(-(z * z)) * mask_k;\n")
RECAVG_V = "      if (live && j < nc) v[j] = ldg("
# programmatic dependent launch: each launch may start while the one before
# it runs; the kernel waits for it (griddepcontrol.wait) before touching memory
RECAVG_PDL_LAUNCH = r"""
template <typename... KArgs, typename... Args>
void pdl_launch(dim3 grid, int threads, cudaStream_t stream, void (*kernel)(KArgs...),
                Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <int W>
void launch("""
RECAVG_VARIANTS = {
    "streaming stores": [(RECAVG_STORE, "        __stcs(out, acc);\n")],
    "no weights": [(RECAVG_WEIGHTS[0], ""), (RECAVG_WEIGHTS[1], "      const float w = 0.125f;\n")],
    "no V loads": [(RECAVG_V, "      if (false) v[j] = ldg(")],
    **{f"times unrolled by {u}": [("#pragma unroll 4\n      for (int t = 0; t < nt; ++t) {",
                                   f"#pragma unroll {u}\n      for (int t = 0; t < nt; ++t) {{")]
       for u in (2, 8)},
    "PDL": [("  for (int n0 = 0;; n0 += NC) {\n",
             '  asm volatile("griddepcontrol.wait;" ::: "memory");\n'
             '  asm volatile("griddepcontrol.launch_dependents;");\n'
             "  for (int n0 = 0;; n0 += NC) {\n"),
            ("\ntemplate <int W>\nvoid launch(", RECAVG_PDL_LAUNCH),
            *[(f"recavg_kernel<W, {t}><<<grid, threads, 0, stream>>>(",
               f"pdl_launch(grid, threads, stream, recavg_kernel<W, {t}>, ")
              for t in ("8, false", "16, false", "32, false", "32, true")],
            ("empty_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>();",
             "pdl_launch(grid, threads, static_cast<cudaStream_t>(stream), empty_kernel);")],
}
RECAVG_VARIANTS["stores only"] = RECAVG_VARIANTS["no weights"] + RECAVG_VARIANTS["no V loads"]


def recavg_variant_libs(recavg, out_dir: str, csrc: str) -> dict:
    """Build each RECAVG_VARIANTS copy (all nvcc processes at once) and
    load it with the kernel's signatures."""
    from imm_tsf_torch.kernels import _build

    text, procs = open(os.path.join(csrc, "recavg.cu")).read(), {}
    for name, edits in RECAVG_VARIANTS.items():
        src = text
        for line, repl in edits:
            if src.count(line) != 1:
                raise RuntimeError(f"recavg.cu changed: no single line {line!r} to replace")
            src = src.replace(line, repl)
        tag = name.replace(" ", "_")
        path = os.path.join(out_dir, f"recavg_{tag}.cu")
        with open(path, "w") as f:
            f.write(src)
        lib = os.path.join(out_dir, f"librecavg_{tag}.so")
        procs[name] = (lib, subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}",
                                              "-o", lib, path]))
    libs = {}
    for name, (path, proc) in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the recavg variant {name!r}")
        libs[name] = ctypes.CDLL(path)
        for fn, (argtypes, restype) in recavg._SIGNATURES.items():
            getattr(libs[name], fn).argtypes = argtypes
            getattr(libs[name], fn).restype = restype
    return libs


def recavg_probe(cs, recavg, gen, dev, variants: dict) -> dict:
    """#1 by launch config, beside the empty kernel on each grid; and each
    variant of `variants` (name -> library) at the default config."""
    import torch

    lib, out = recavg._library(), {}
    stream = torch.cuda.current_stream(dev).cuda_stream
    for B, N, T, d in ((64, 8, 24, 768), (32, 8, 36, 768)):
        sets = [cs.recavg_inputs(B, N, T, d, gen, dev) for _ in range(4)]
        E = torch.empty((B, T, d), device=dev)
        res = {"launch_config": recavg.launch_config(T),
               "ms": cs.device_ms(recavg.recency_weighted_average, sets, per_rep=200),
               "previous_design_ms": cs.device_ms(recavg.tiled_forward, sets, per_rep=200),
               "fill_ms": cs.device_ms(lambda: E.fill_(1.0), [[]], per_rep=200),
               "by_config": {}}
        for threads in (32, 64, 128):
            for splits in (1, 2, 3, 4, 6):
                tpb = -(-T // splits)
                run = lambda *a, c=(threads, tpb): recavg._forward(*a, config=c)
                empty = lambda c=(threads, tpb): lib.recavg_empty(B, T, d, *c, stream)
                blocks = B * -(-d // (4 * threads)) * -(-T // tpb)
                res["by_config"][f"threads {threads} times {tpb}"] = {
                    "blocks": blocks, "ms": cs.device_ms(run, sets, per_rep=200),
                    "empty_ms": cs.device_ms(empty, [[]], per_rep=200)}
        library = recavg._library
        for name, vlib in variants.items():
            recavg._library = lambda vlib=vlib: vlib
            try:
                res[f"{name} ms"] = cs.device_ms(recavg._forward, sets, per_rep=200)
                res[f"{name} empty ms"] = cs.device_ms(
                    lambda: recavg.empty_launch(B, T, d, dev), [[]], per_rep=200)
            finally:
                recavg._library = library
        out[str([B, N, T, d])] = res
    return out


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=["recavg"], default=None)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("torch_kernel_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from imm_tsf_torch.kernels import expm, ffn, recavg
    from imm_tsf_torch.layers.fast_dropout import _thresh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    csrc = os.path.join(REPO, "imm_tsf_torch", "csrc")
    out_dir = os.path.join(REPO, "imm_tsf_torch", "_build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    out = {"device": torch.cuda.get_device_name(0),
           "power": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], capture_output=True, text=True,
                                   check=True).stdout.strip()}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    out["recavg"] = recavg_probe(cs, recavg, gen, dev,
                                 recavg_variant_libs(recavg, out_dir, csrc))
    if args.only == "recavg":
        print(json.dumps(out), flush=True)
        return 0

    src = os.path.join(out_dir, "mma_rate.cu")
    with open(src, "w") as f:
        f.write(MMA_RATE_SRC)
    nvcc(src, os.path.join(out_dir, "libmma_rate.so"), csrc)
    lib = ctypes.CDLL(os.path.join(out_dir, "libmma_rate.so"))
    lib.mma_rate_tflops.argtypes, lib.mma_rate_tflops.restype = [ctypes.c_int], ctypes.c_double
    out["mma_sync_tflops"] = lib.mma_rate_tflops(20000)

    text = open(os.path.join(csrc, "ffn.cu")).read()
    for line in FFN_PRODUCTS:
        if text.count(line) != 1:
            raise RuntimeError(f"ffn.cu changed: no single line {line!r} to take out")
        text = text.replace(line, "")
    src = os.path.join(out_dir, "ffn_without_products.cu")
    with open(src, "w") as f:
        f.write(text)
    nvcc(src, os.path.join(out_dir, "libffn_without_products.so"), csrc)
    bare = ctypes.CDLL(os.path.join(out_dir, "libffn_without_products.so")).ffn_forward
    bare.argtypes, bare.restype = ffn._SIGNATURES["ffn_forward"]

    def without_products(x, w1, b1, w2, b2, gamma, beta, salts):
        w1t, w2t, y = w1.t().contiguous(), w2.t().contiguous(), torch.empty_like(x)
        rc = bare(x.data_ptr(), w1t.data_ptr(), b1.data_ptr(), w2t.data_ptr(), b2.data_ptr(),
                  gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), None, None, x.shape[0],
                  x.shape[1], w1.shape[1], cs.KEEP, _thresh(cs.KEEP), None, 1, 0, 1,
                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ffn without products: cudaError_t {rc}")
        return y

    sets = [cs.ffn_inputs(8192, 512, 2048, gen, dev) for _ in range(2)]
    out["ffn_ms"] = cs.device_ms(lambda *a: ffn.fused_encoder_ffn(*a, cs.KEEP, "gelu", False),
                                 sets, per_rep=10)
    out["ffn_without_products_ms"] = cs.device_ms(without_products, sets, per_rep=10)

    out["frechet_us"] = {}
    for B in (32, 64):
        for norm in (0.01, 6.0, 80.0):
            fs = [list(cs.frechet_inputs(B, 64, norm, gen, dev)) + [cs.MAX_SQUARINGS]
                  for _ in range(2)]
            for C in (1, 2, 4):
                ms = cs.device_ms(lambda *a, C=C: expm.batched_expm_frechet(*a, cluster=C), fs)
                out["frechet_us"][f"B {B} norm {norm} C {C}"] = ms * 1e3
    out.update(expm_probe(cs, expm, gen, dev))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
