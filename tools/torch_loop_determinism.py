"""Are the training loops bit for bit equal on the card, and where not, why?

    python tools/torch_loop_determinism.py [--model Informer] [--epochs 3]

Trains chip_smoke's full-width experiment for `--model` (phase 9's
Informer on the kernel route by default) through imm_tsf_torch.main five
times: streaming twice (`--device_loop false`), on the epoch loop with
captured steps twice, and on the epoch loop with eager steps; first with
cuDNN's default algorithms, then with its deterministic ones (what
`device.resolve_device` sets). Prints, for each setting, each run's
largest relative per-step loss gap to the first streaming run and the step
where it starts, as one JSON line. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from imm_tsf_torch.training import graphs, trainer  # noqa: E402

RUNS = ("streaming", "streaming again", "captured", "captured again", "eager")


def run(mode: str, args: list, root: str, exp: str, deterministic: bool) -> np.ndarray:
    resolve, reason = trainer.resolve_device, graphs.eager_reason

    def resolve_with(device):
        dev = resolve(device)
        torch.backends.cudnn.deterministic = deterministic
        return dev

    trainer.resolve_device = resolve_with
    if mode == "eager":
        graphs.eager_reason = lambda cfg, model: "the eager side of the comparison"
    try:
        res = cs.train_main.main(list(args) + (cs.STREAM if mode.startswith("streaming") else [])
                                 + ["--data_root", root, "--save", exp, "--device", "cuda"])
    finally:
        trainer.resolve_device, graphs.eager_reason = resolve, reason
        shutil.rmtree(exp, ignore_errors=True)
    return np.asarray([x for h in res["history"] for x in h["step_losses"]])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="Informer")
    ap.add_argument("--epochs", type=int, default=3)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_loop_determinism: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = [a if a != "CRU" else opts.model for a in cs.TRAIN_ARGS]
    args = base + cs.PATCH_ROUTES["kernel"] + ["--epoch", str(opts.epochs)]
    root = os.path.join(cs.REPO, "experiments", f"loop_determinism_{os.getpid()}")
    exp = root + "_exp"
    out = {"card": torch.cuda.get_device_name(0), "model": opts.model}
    try:
        cs.make_synthetic_dataset(os.path.join(root, "EPA-Air"), **cs.TRAIN_DATA)
        for deterministic in (False, True):
            losses = {m: run(m.split()[0], args, root, exp, deterministic) for m in RUNS}
            ref = losses["streaming"]
            out[f"cudnn_deterministic={deterministic}"] = {
                m: {"max_rel_gap": float(np.max(np.abs(v - ref) / np.abs(ref))),
                    "first_differing_step": (int(np.argmax(v != ref)) if (v != ref).any()
                                             else None)}
                for m, v in losses.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(exp, ignore_errors=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
