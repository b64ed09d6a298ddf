"""imm_tsf_torch: the PyTorch/CUDA port of imm_tsf_tpu.

Modules keep the JAX package's file and public names. Plain tensor code
is PyTorch; every TPU (Pallas) kernel on a ported path is a CUDA C++
kernel for sm_90a under `csrc/`, built at first use by
`kernels/_build.py`. Entry points run on `cuda` unless the caller passes
`device="cpu"`.
"""
