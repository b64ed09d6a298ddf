"""Hold TimesNet's exported program against its live service on one card.

    python tools/torch_timesnet_artifact_probe.py

Prints the card (`nvidia-smi` name and power limit), then one JSON line.
chip_smoke's TimesNet experiment (mts_cfg: the preset at full width
behind TTF_RecAvg + MMF_GR_Add, seeded weights) is exported at B 8 and
served live at max_batch 8; 64 requests (chip_smoke.make_requests) go
through both in dispatches of 8:

- "dispatches": each dispatch's max |artifact - live| over its answers;
- "repeat": the first differing dispatch (or the first) again on each
  side: is each side deterministic by itself;
- "paths": that dispatch's predictions before `gather_results` four ways
  (the live `_predict` on its collate, the program on the artifact's
  collate as `forecast` runs it, the live forward on the artifact's batch,
  the program on the live batch), each pair's max |diff|;
- "by_module": the program run node by node (torch.fx Interpreter) on the
  artifact's batch: the output of the last node of each backbone and
  fusion submodule (`nn_module_stack`) against that submodule's output in
  the eager forward (forward hooks; the shared LayerNorm's first call),
  max |diff| each, in call order;
- "predict_linear": the eager predict_linear on its input as the forward
  hands it (strides printed) against the same input made contiguous.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


class LastNodeOfModule(torch.fx.Interpreter):
    """Runs a program and keeps, for each module path of `nn_module_stack`,
    the tensor output of the last node that ran inside it."""

    def __init__(self, gm):
        super().__init__(gm)
        self.last: dict = {}

    def run_node(self, n):
        res = super().run_node(n)
        if isinstance(res, torch.Tensor):
            for entry in (n.meta.get("nn_module_stack") or {}).values():
                self.last[entry[0]] = res.detach().clone()
        return res


def max_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)))) if np.size(a) else 0.0


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_timesnet_artifact_probe: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from imm_tsf_torch.export import ExportedForecaster, _Forecast, export_experiment
    from imm_tsf_torch.serving import ForecastService, _build_chunk, collate_chunks

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    root = os.path.join(HERE, "experiments", f"timesnet_probe_{os.getpid()}")
    exp, art = os.path.join(root, "exp"), os.path.join(root, "art")
    out: dict = {"device": torch.cuda.get_device_name(0)}
    try:
        cfg = cs.make_experiment(exp, cs.mts_cfg("TimesNet"), cs.SEED)
        export_experiment(exp, art, batch_sizes=(8,), device="cuda")
        fc = ExportedForecaster(art, device="cuda")
        svc = ForecastService(exp, max_batch=8, device="cuda")
        try:
            reqs = cs.make_requests(cfg, 64, cs.SEED)
            batches = [reqs[i:i + 8] for i in range(0, 64, 8)]
            flat = lambda answers: np.concatenate([np.ravel(a["prediction"]) for a in answers])
            live = lambda b: flat(svc._infer([_build_chunk(r, svc.cfg, svc.d_txt) for r in b]))
            program = lambda b: flat(fc.forecast(b))
            out["dispatches"] = [max_diff(program(b), live(b)) for b in batches]
            b = batches[next((i for i, d in enumerate(out["dispatches"]) if d > 0), 0)]
            out["repeat"] = {"artifact": max_diff(program(b), program(b)),
                             "live": max_diff(live(b), live(b))}

            built = [c for c, _, _ in (_build_chunk(r, fc.cfg, fc.d_txt) for r in b)]
            host = collate_chunks(fc.cfg, built, fc.d_txt, fc.time_max, 8, n_notes=fc.notes_cap)
            dev = svc.to_device({k: host[k] for k in fc._keys[8]})
            live_dev = svc.to_device(svc._collate(built))
            module, prog = _Forecast(svc), fc._programs[8]
            with torch.inference_mode():
                preds = {"live": svc._predict(svc._collate(built)),
                         "program": prog(dev).cpu().numpy(),
                         "live_on_artifact_batch": module(dev).cpu().numpy(),
                         "program_on_live_batch": prog(
                             {k: live_dev[k] for k in fc._keys[8]}).cpu().numpy()}
            names = list(preds)
            out["paths"] = {f"{x} vs {y}": max_diff(preds[x], preds[y])
                            for i, x in enumerate(names) for y in names[i + 1:]}

            named = [(f"model.{n}" if n else "model", m) for n, m in svc.model.named_modules()]
            named += [(f"fusion.{n}" if n else "fusion", m)
                      for n, m in svc.fusion.named_modules()]
            eager_in, eager_out = {}, {}

            def keep(name):
                def pre(mod, args):
                    eager_in.setdefault(name, args)

                def post(mod, args, res):
                    res = res[0] if isinstance(res, tuple) else res
                    eager_out.setdefault(name, res.detach().clone())
                return pre, post

            hooks = []
            for name, m in named:
                pre, post = keep(name)
                hooks += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
            interp = LastNodeOfModule(prog)
            with torch.inference_mode():
                module(dev)
                for h in hooks:
                    h.remove()
                interp.run(*[dev[k] for k in fc._keys[8]])
            out["by_module"] = {path: max_diff(eager_out[path].cpu(), t.cpu())
                                for path, t in interp.last.items()
                                if path in eager_out and eager_out[path].shape == t.shape}

            x = eager_in["model.predict_linear"][0]
            linear = svc.model.predict_linear
            with torch.inference_mode():
                out["predict_linear"] = {"input_strides": list(x.stride()),
                                         "as_handed_vs_contiguous": max_diff(
                                             linear(x).cpu(), linear(x.contiguous()).cpu())}
        finally:
            svc.close()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
