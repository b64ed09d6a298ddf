"""Deployment artifacts on `torch.export` (after imm_tsf_tpu/export.py).

`export_experiment` traces a trained experiment's served forward
(training/trainer.make_forward, as a ForecastService builds it) at fixed
batch sizes with `torch.export`, the trained weights inside each program,
and saves one program a batch size with `torch.export.save`. Loading the
artifact (`ExportedForecaster`) needs no model code, no module
construction and no checkpoint: only the request collate (serving.py)
runs in Python, then the program.

The kernels reach the programs as operators: `kernels/ops.py` registers
each served-path kernel as a `torch.library` custom op (`imm_tsf::*`),
so a program traced on the card, or on the CPU, records the op, and
running it on the card launches the hand-written kernel (on the CPU, its
plain version). This is the one departure from the JAX package, whose
Pallas calls lower into the StableHLO artifact: loading an artifact needs
`imm_tsf_torch.kernels.ops` imported, so that the `imm_tsf::*` ops
resolve (this module imports it).

Artifact layout:
    meta.json            version, model, batch sizes, caps, input specs, the
                         device traced on, torch version, compute dtype,
                         kernel route
    config.json          the Config the programs were exported with
    forecast_b{B}.pt2    one torch.export program a batch size

As in the JAX package: the notes axis is pinned to `notes_cap`,
tPatchGNN's per-patch axis to `patch_cap` and the LatentODE's union axes
to `ode_caps` (request bounds enforced by serving._build_chunk and the
collates); a LatentODE is dispatched one request at a time, as the live
service does; raw-text notes are embedded on the host by the frozen LLM
before the program runs.

A model that `torch.export` cannot trace is refused, with the cause.

On cuda an `ExportedForecaster` replays each program as a CUDA graph
(training/graphs.ForwardGraphs, one key a batch size: the programs'
shapes are static), the counterpart of calling the JAX artifact's
compiled program.
"""

from __future__ import annotations

import json
import os
import threading
import time

import torch

from .config import Config, load_saved_config
from .device import resolve_device
from .kernels import ops as _ops  # noqa: F401  registers the imm_tsf::* ops a program calls
from .serving import _MetricsMixin
from .training.graphs import ForwardGraphs

ARTIFACT_VERSION = 1


class _Forecast(torch.nn.Module):
    """A service's backbone and fusion stack as one module: forward(batch)
    is the served forward."""

    def __init__(self, svc):
        super().__init__()
        from .training.trainer import make_forward

        self.model, self.fusion = svc.model, svc.fusion
        self._forward = make_forward(svc.cfg, svc.model, svc.fusion)

    def forward(self, batch: dict) -> torch.Tensor:
        return self._forward(batch)


def op_counts(ep) -> dict:
    """The `imm_tsf::*` op nodes of an exported program, by op; a node
    whose `one_pass` argument is true (compute_dtype="bfloat16") counts
    under "<op>:one_pass", the form it launches."""
    counts: dict = {}
    for node in ep.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("imm_tsf."):
            op = name.split(".")[1]
            if _one_pass(node):
                op += ":one_pass"
            counts[op] = counts.get(op, 0) + 1
    return counts


def _one_pass(node) -> bool:
    """The `one_pass` argument of an `imm_tsf::*` node (False where its op
    has none or the call left it at its default)."""
    names = [a.name for a in node.target._schema.arguments]
    if "one_pass" not in names:
        return False
    i = names.index("one_pass")
    return bool(node.args[i] if i < len(node.args) else node.kwargs.get("one_pass", False))


def export_experiment(checkpoint_dir: str, out_dir: str, cfg: Config | None = None,
                      batch_sizes=(1, 8, 32), device=None, max_notes: int = 8) -> dict:
    """Export a trained experiment to an artifact directory on `device`
    (cuda unless the caller asks for the CPU); returns the meta dict
    written to meta.json. `max_notes` pins the notes axis of a text
    experiment (to its bucket)."""
    from .data import collate as C
    from .serving import ForecastService, collate_chunks

    batch_sizes = sorted({int(b) for b in batch_sizes})
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError("batch_sizes must be positive ints")
    if cfg is None:
        cfg = load_saved_config(os.path.join(checkpoint_dir, "config.json"))

    svc = ForecastService(checkpoint_dir, cfg=cfg, max_batch=max(batch_sizes), device=device)
    try:
        for mod in (svc.model, svc.fusion):
            if mod is not None:
                mod.requires_grad_(False)  # the served (eval) forms of the kernels
        notes_cap = C.pad_to_bucket(max(int(max_notes), 1)) if cfg.enable_text else 0
        # tPatchGNN's per-patch axis: a patch never holds more observed
        # points than the history window (input_len, a request bound)
        patch_cap = C.pad_to_bucket(cfg.input_len) if cfg.model == "tPatchGNN" else 0
        # the LatentODE's union axes: a request contributes at most input_len
        # observed and pred_len forecast times, and dispatches alone
        ode_caps = ((C.pad_to_bucket(cfg.input_len), C.pad_to_bucket(cfg.pred_len))
                    if cfg.model == "LatentODE" else None)
        module = _Forecast(svc)
        os.makedirs(out_dir, exist_ok=True)
        input_specs, op_nodes, seconds = {}, {}, {}
        for B in batch_sizes:
            svc._proxy.batch = collate_chunks(cfg, [svc._dummy_chunk()], svc.d_txt,
                                              svc.time_max, B, n_notes=notes_cap,
                                              max_patch_len=patch_cap or None,
                                              ode_caps=ode_caps)
            host = next(iter(svc._stage_top))
            batch = svc.to_device({k: host[k] for k in sorted(host)})
            t0 = time.perf_counter()
            try:
                ep = torch.export.export(module, (batch,), strict=False)
            except Exception as e:
                raise NotImplementedError(
                    f"cannot export {cfg.model}: torch.export could not trace its forward "
                    f"({type(e).__name__}: {e})") from e
            seconds[str(B)] = time.perf_counter() - t0
            torch.export.save(ep, os.path.join(out_dir, f"forecast_b{B}.pt2"))
            op_nodes[str(B)] = op_counts(ep)
            input_specs[str(B)] = {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                                   for k, v in batch.items()}

        # the config the programs were exported with (the caller's overrides
        # included); platform is a machine-local knob, never artifact config
        with open(os.path.join(out_dir, "config.json"), "w") as f:
            f.write(cfg.replace(platform="auto").to_json())
        meta = {
            "artifact_version": ARTIFACT_VERSION,
            "model": cfg.model,
            "dataset": cfg.dataset,
            "enable_text": cfg.enable_text,
            "batch_sizes": batch_sizes,
            "device": str(next(iter(batch.values())).device),
            "notes_cap": notes_cap,
            "patch_cap": patch_cap,
            "ode_caps": list(ode_caps) if ode_caps else None,
            "d_txt": svc.d_txt,
            "best_epoch": int(svc.step),
            "torch_version": torch.__version__,
            "compute_dtype": cfg.compute_dtype,
            "kernel_route": {"use_pallas": cfg.use_pallas, "use_fused_ffn": cfg.use_fused_ffn,
                             "use_fused_attn": cfg.use_fused_attn,
                             "IMM_TSF_CRU_FUSED": os.environ.get("IMM_TSF_CRU_FUSED") == "1"},
            "ops": op_nodes,
            "export_s": seconds,
            "input_specs": input_specs,
        }
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return meta
    finally:
        svc.close()


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index is None or b.index is None or a.index == b.index)


class ExportedForecaster(_MetricsMixin):
    """Serve forecasts from an exported artifact: no model code, no weight
    restore; the programs carry the trained weights.

    `device` defaults to cuda and raises without a card; device="cpu" runs
    on the CPU. A program traced on another device is moved to this one
    (torch.export.passes.move_to_device_pass). The instance schema is
    ForecastService.forecast's (serving.py); calls are synchronous and
    serialize on a lock (batch your own requests: the artifact holds one
    program a batch size). It has serve.py's handler interface (cfg, step,
    device, max_batch, forecast, metrics, close), so `python -m
    imm_tsf_torch.serve --artifact <dir>` serves it."""

    def __init__(self, artifact_dir: str, device=None):
        from .serving import _OneBatchProxy
        from .training.trainer import make_loader_wrappers

        self.device = resolve_device(device)
        with open(os.path.join(artifact_dir, "meta.json")) as f:
            self.meta = json.load(f)
        if self.meta["artifact_version"] != ARTIFACT_VERSION:
            raise ValueError(f"artifact version {self.meta['artifact_version']} != "
                             f"supported {ARTIFACT_VERSION}")
        self.cfg = load_saved_config(os.path.join(artifact_dir, "config.json"))
        self.d_txt = int(self.meta["d_txt"])
        self.notes_cap = int(self.meta["notes_cap"])
        self.patch_cap = int(self.meta.get("patch_cap", 0))
        caps = self.meta.get("ode_caps")
        self.ode_caps = tuple(caps) if caps else None
        self.time_max = float(self.cfg.history + self.cfg.pred_window)
        traced_on = torch.device(self.meta["device"])
        self._programs, self._keys = {}, {}
        for B in self.meta["batch_sizes"]:
            ep = torch.export.load(os.path.join(artifact_dir, f"forecast_b{B}.pt2"))
            if not _same_device(traced_on, self.device):
                from torch.export.passes import move_to_device_pass

                ep = move_to_device_pass(ep, self.device)
            self._programs[int(B)] = ep.module()
            self._keys[int(B)] = list(self.meta["input_specs"][str(B)])

        # host loader stages (TimeLLM's exact prompts, raw-text note
        # embedding by the frozen LLM on this device)
        self._proxy = _OneBatchProxy()
        stage = self._proxy
        for wrap in make_loader_wrappers(self.cfg, self.device):
            stage = wrap(stage)
        self._stage_top = stage

        self.step = int(self.meta.get("best_epoch", 0))
        self.max_batch = max(self._programs)
        self._lock = threading.Lock()
        self._init_metrics()
        self._graphs = ForwardGraphs(self._run_program, self.device)

    def _run_program(self, batch: dict) -> torch.Tensor:
        """The program of the batch's size (every collate's observed_data
        leads with the batch axis)."""
        return self._programs[batch["observed_data"].shape[0]](batch)

    def forecast(self, instances: list[dict]) -> list[dict]:
        from .serving import _build_chunk, collate_chunks, gather_results

        built = [_build_chunk(inst, self.cfg, self.d_txt) for inst in instances]
        n = len(built)
        if n == 0:  # as ForecastService.forecast([])
            return []
        if self.ode_caps and n > 1:
            # the union time axis: one dispatch a request, as the live
            # service's no-coalesce rule (serving.py `_coalesce`)
            return [self.forecast([inst])[0] for inst in instances]
        sizes = [B for B in self._programs if B >= n]
        if not sizes:
            raise ValueError(f"{n} instances exceed the largest exported batch size "
                             f"{max(self._programs)}; split the request")
        B = min(sizes)
        if self.cfg.enable_text:
            worst = max(len(c.note_times) for c, _, _ in built)
            if worst > self.notes_cap:
                raise ValueError(f"{worst} notes exceed the artifact's notes_cap "
                                 f"{self.notes_cap} (re-export with a larger max_notes)")
        t0 = time.monotonic()
        err = 0
        with self._lock:  # the proxy and stage chain hold one batch
            try:
                self._proxy.batch = collate_chunks(
                    self.cfg, [c for c, _, _ in built], self.d_txt, self.time_max, B,
                    n_notes=self.notes_cap, max_patch_len=self.patch_cap or None,
                    ode_caps=self.ode_caps)
                out = next(iter(self._stage_top))
                with torch.inference_mode():
                    pred = self._graphs({k: out[k] for k in self._keys[B]}).cpu().numpy()
                results = gather_results(self.cfg, built, out, pred)
            except Exception:
                err = n
                raise
            finally:
                self._record_dispatch(n, err, time.monotonic() - t0)
        return results

    def metrics(self) -> dict:
        return {**super().metrics(), "artifact": True}

    def close(self):
        """serve.py's shutdown hook: the graphs' pool returns to the device."""
        with self._lock:
            self._graphs.clear()

