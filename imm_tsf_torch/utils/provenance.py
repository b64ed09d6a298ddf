"""Resolved-config provenance for result artifacts (after
imm_tsf_tpu/utils/provenance.py).

Every writer of a result artifact (main_all.py's result files, main.py's
run log) attaches `provenance(cfg)`: the code's identity (package
version, git revision), the framework and the device it ran on, and the
resolved config fields that change the numbers, so that a result stays
tied to the defaults and the kernel route that produced it.
"""

from __future__ import annotations

import subprocess
import time
from pathlib import Path

_REPO_ROOT = Path(__file__).resolve().parents[2]


def git_rev() -> str:
    """Short git rev of the repo, '+dirty' if the worktree has changes;
    'unknown' outside a git checkout."""
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=_REPO_ROOT, capture_output=True, text=True, timeout=10,
        )
        if rev.returncode != 0:
            return "unknown"
        dirty = subprocess.run(
            ["git", "status", "--porcelain", "--untracked-files=no"],
            cwd=_REPO_ROOT, capture_output=True, text=True, timeout=10,
        )
        suffix = "+dirty" if dirty.stdout.strip() else ""
        return rev.stdout.strip() + suffix
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def provenance(cfg=None) -> dict:
    """Provenance dict for a result artifact: package and code identity,
    torch, the CUDA runtime and the card (None without one), plus the
    resolved config fields that change the numbers."""
    import torch

    from .. import __version__

    cuda = torch.cuda.is_available()
    out = {
        "framework_version": __version__,
        "git_rev": git_rev(),
        "torch_version": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "device_name": torch.cuda.get_device_name(0) if cuda else None,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }
    if cfg is not None:
        out.update({k: getattr(cfg, k, None) for k in (
            "dropout_impl", "rng_impl", "compute_dtype", "frozen_param_dtype", "use_pallas",
            "use_fused_ffn", "use_fused_attn", "device_loop", "seed", "lr")})
    return out
