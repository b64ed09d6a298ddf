#!/usr/bin/env python3
"""What bounds kernels #2 (the fused encoder FFN), #4 (the expm's Frechet
derivative) and #5 (the batched expm) of the PyTorch/CUDA port, on one
CUDA card.

    python tools/torch_kernel_probe.py

Prints one JSON line with:

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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from imm_tsf_torch.kernels import expm, ffn
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
                  x.shape[1], w1.shape[1], cs.KEEP, _thresh(cs.KEEP), 0, 0, 0, 0, 1, 0, 1,
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
