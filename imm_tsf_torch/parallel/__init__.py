"""Data parallelism over torch.distributed (after imm_tsf_tpu/parallel/)."""
