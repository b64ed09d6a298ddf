"""Online forecasting service: micro-batched inference on a trained
experiment (after imm_tsf_tpu/serving.py).

A `ForecastService` restores an experiment directory (the resolved
`config.json` and `best/weights.pt`), builds the backbone and fusion
stack on `device` (cuda unless the caller asks for the CPU), and serves
ragged client requests through the training-time collate of the model's
family (standard, CRU's raw repeat-padded times, tPatchGNN's patches or
the LatentODE's union time axes) and the trainer's loader stages
(raw-text note embedding, TimeLLM's exact prompts). Every batch is padded
to `max_batch`, and the obs/pred axes to the experiment's ceilings (the
standard and CRU collates) or to buckets (the patch and ODE collates).

Requests are micro-batched: a background thread coalesces concurrent
requests for up to `max_wait_ms` (or until `max_batch`), pads them into
one device dispatch, and fans results back out. LatentODE requests are
dispatched one at a time: the union time axis would otherwise make an
answer depend on the requests batched with it. Host batches reach the
device as pinned tensors copied with non_blocking=True.

Instance schema (all lists / nested lists, JSON-friendly):
  observed_tp    [n]     chunk-relative times in [0, history)
  observed_data  [n, D]  values; NaN/null = missing (mask derived)
  observed_mask  [n, D]  optional explicit mask (overrides NaN detection)
  tp_to_predict  [m]     requested forecast times in [history, history+pred_window]
  notes          optional list of {"tau": t, "embedding": [d_txt]} or,
                 for an experiment with use_text_embeddings=false,
                 {"tau": t, "text": "..."}: raw text is embedded by the
                 service's frozen GPT-2 on its device, with a per-string
                 cache (llm/loader.py, training/trainer.py)
  mean, std      optional [D] per-record stats: inputs are z-scored with
                 them and predictions de-normalized back. Without them
                 the service assumes model (z-scored) space, matching the
                 training data contract (reference lib/parse_datasets.py:103-111).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from .config import Config, load_saved_config
from .data import collate as C
from .data.dataset import Chunk
from .data.loader import _pad_batch_dim
from .device import resolve_run_device

logger = logging.getLogger("imm_tsf_torch.serving")


class _OneBatchProxy:
    """A one-batch loader, so the trainer's loader stages (raw-text note
    embedding) are built once and reused by every dispatch: their caches
    outlive the request."""

    def __init__(self):
        self.batch = None

    def __len__(self):
        return 1

    def __iter__(self):
        yield self.batch


def _build_chunk(inst: dict, cfg: Config, d_txt: int) -> tuple[Chunk, np.ndarray, np.ndarray]:
    """Validate one request instance -> (Chunk, mean, std). Every client
    input defect raises ValueError (mapped to HTTP 400 by serve.py)."""
    if not isinstance(inst, dict):
        raise ValueError("each instance must be a JSON object")
    for key in ("observed_tp", "observed_data", "tp_to_predict"):
        if inst.get(key) is None:
            raise ValueError(f"instance is missing required field {key!r}")
    try:
        tt = np.asarray(inst["observed_tp"], dtype=np.float32)
        vals = np.asarray(inst["observed_data"], dtype=np.float32)
        tp_pred = np.asarray(inst["tp_to_predict"], dtype=np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(f"non-numeric request arrays: {e}") from None
    if tt.ndim != 1 or tp_pred.ndim != 1:
        # a scalar (0-d) would make len() raise TypeError -> HTTP 500
        raise ValueError(
            "observed_tp and tp_to_predict must be 1-D lists of timestamps"
        )
    if len(tt) == 0 and vals.size == 0:
        # zero-observation (cold-start) request: JSON [] can't carry the
        # [0, D] shape — normalize it; models handle all-pad windows
        vals = vals.reshape(0, cfg.input_dim)
    if vals.ndim != 2 or len(tt) != len(vals):
        raise ValueError("observed_data must be [n, D] aligned with observed_tp")
    D = vals.shape[1]
    if D != cfg.input_dim:
        raise ValueError(f"expected {cfg.input_dim} features, got {D}")
    if "observed_mask" in inst and inst["observed_mask"] is not None:
        mask = np.asarray(inst["observed_mask"], dtype=np.float32)
        if mask.shape != vals.shape:
            raise ValueError("observed_mask must match observed_data's shape")
    else:
        mask = np.isfinite(vals).astype(np.float32)
    vals = np.nan_to_num(vals, nan=0.0)
    time_max = float(cfg.history + cfg.pred_window)
    if len(tt) > cfg.input_len:
        raise ValueError(
            f"{len(tt)} observed points exceed the experiment's input_len "
            f"{cfg.input_len} (the static ceiling it was trained with)")
    if len(tp_pred) > cfg.pred_len:
        raise ValueError(
            f"{len(tp_pred)} forecast points exceed pred_len {cfg.pred_len}")
    if len(tp_pred) == 0:
        raise ValueError("tp_to_predict is empty")
    if len(tt) and ((tt < 0).any() or (tt >= cfg.history).any()):
        raise ValueError(f"observed_tp must lie in [0, history={cfg.history})")
    if (tp_pred < cfg.history).any() or (tp_pred > time_max).any():
        raise ValueError(
            f"tp_to_predict must lie in [history={cfg.history}, "
            f"history+pred_window={time_max}]")
    # duplicate times would collide in the collate's scatter (the response
    # would silently have fewer rows than tp) — reject them up front
    if len(np.unique(tp_pred)) != len(tp_pred):
        raise ValueError("tp_to_predict contains duplicate times")
    if len(np.unique(tt)) != len(tt):
        raise ValueError("observed_tp contains duplicate times")

    mean = std = None
    if inst.get("mean") is not None or inst.get("std") is not None:
        mean = np.asarray(inst["mean"] if inst.get("mean") is not None
                          else np.zeros(D), dtype=np.float32).reshape(1, D)
        std = np.asarray(inst["std"] if inst.get("std") is not None
                         else np.ones(D), dtype=np.float32).reshape(1, D)
        std = np.where(std == 0, 1.0, std)  # sigma=0 -> center only
        vals = (vals - mean) / std * mask

    # notes -> chunk payloads
    note_times, payloads = [], []
    for note in inst.get("notes") or []:
        if not isinstance(note, dict) or "tau" not in note:
            raise ValueError('each note must be {"tau", "embedding"|"text"}')
        if "embedding" not in note and "text" not in note:
            raise ValueError('note has neither "embedding" nor "text"')
        note_times.append(np.float32(note["tau"]))
        if "embedding" in note:
            if not cfg.use_text_embeddings:
                raise ValueError(
                    "this experiment embeds raw text at runtime "
                    "(use_text_embeddings=false): send notes as "
                    '{"tau", "text"}')
            emb = np.asarray(note["embedding"], dtype=np.float32)
            if emb.shape != (d_txt,):
                raise ValueError(f"note embedding must be [{d_txt}]")
            payloads.append(emb)
        else:
            if cfg.use_text_embeddings:
                raise ValueError(
                    "this experiment was trained on precomputed note "
                    'embeddings: send notes as {"tau", "embedding"}')
            payloads.append(str(note["text"]))
    # NB: empty `payloads` is legal even though the training data contract
    # drops no-text chunks (lib/parse_datasets.py:217-221) — the fusion
    # modules handle the no-note sample path (M_txt=0 -> identity)

    # pred rows: requested times with dummy values and mask=1 — the mask
    # marks which batch slots belong to this instance (the gather key);
    # values are never read at inference
    order = np.argsort(tt, kind="stable")
    tt_all = np.concatenate([tt[order], np.sort(tp_pred)])
    vals_all = np.concatenate([vals[order], np.zeros((len(tp_pred), D), np.float32)])
    mask_all = np.concatenate([mask[order], np.ones((len(tp_pred), D), np.float32)])
    chunk = Chunk(
        chunk_id="request_chunk0",
        tt=tt_all, vals=vals_all, mask=mask_all,
        note_times=np.asarray(note_times, dtype=np.float32),
        note_payloads=payloads,
    )
    return chunk, mean, std


def collate_chunks(cfg: Config, chunks: list[Chunk], d_txt: int,
                   time_max: float, pad_to: int,
                   n_notes: int | None = None) -> dict:
    """Collate request chunks through the training-time collate for cfg's
    model family (tPatchGNN: the patch collate; CRU: raw, repeat-padded
    times; LatentODE: the ODE collate's union axes; the others: the
    standard collate), batch-padded to the static size `pad_to`. n_notes
    pins the notes axis (None: the bucket of the batch's largest note
    count); the per-patch and ODE union axes take the buckets of the batch."""
    if cfg.model == "tPatchGNN":
        out = C.patch_collate(chunks, cfg.history, time_max, cfg.pred_len, cfg.patch_size,
                              cfg.patch_stride, cfg.npatch)
    elif cfg.model == "CRU":
        out = C.cru_collate(chunks, cfg.history, time_max,
                            cfg.input_len, cfg.pred_len)
    elif cfg.model == "LatentODE":
        out = C.ode_collate(chunks, cfg.history, time_max)
    else:
        out = C.standard_collate(chunks, cfg.history, time_max,
                                 cfg.input_len, cfg.pred_len)
    if n_notes is None:
        n_notes = max([len(c.note_times) for c in chunks], default=0)
        n_notes = C.pad_to_bucket(max(n_notes, 1)) if cfg.enable_text else 0
    out = C.add_multimodal(out, chunks, cfg.enable_text,
                           cfg.use_text_embeddings, n_notes, d_txt)
    return _pad_batch_dim(out, len(chunks), pad_to)


def gather_results(cfg: Config, built: list[tuple], out: dict,
                   pred: np.ndarray) -> list[dict]:
    """Fan a batched prediction back out to per-instance responses: the
    rows each instance's pred mask marks, de-normalized when the request
    carried stats."""
    pmask = out["mask_predicted_data"]  # [B, T, D]
    results = []
    for i, (chunk, mean, std) in enumerate(built):
        rows = np.nonzero(pmask[i].any(axis=-1))[0]
        tp = np.sort(chunk.tt[chunk.tt >= cfg.history])
        y = pred[i, rows][: len(tp)]
        if mean is not None:
            y = y * std + mean
        results.append({"tp": tp.tolist(),
                        "prediction": np.asarray(y, np.float64).tolist()})
    return results


class _MetricsMixin:
    """Observability counters + /metrics payload. Subclasses need
    `self.cfg` and `self.step`, call `_init_metrics()` in __init__ and
    `_record_dispatch` after every device dispatch."""

    def _init_metrics(self) -> None:
        self._t_start = time.monotonic()
        self._m_lock = threading.Lock()
        self._n_requests = 0
        self._n_errors = 0
        self._n_dispatches = 0
        self._lat_ring: list[float] = []  # last 1024 dispatch latencies (s)

    def _record_dispatch(self, n_requests: int, n_errors: int,
                         dt: float) -> None:
        with self._m_lock:
            self._n_requests += n_requests
            self._n_errors += n_errors
            self._n_dispatches += 1
            self._lat_ring.append(dt)
            if len(self._lat_ring) > 1024:
                del self._lat_ring[:512]

    def _queue_depth(self) -> int:
        return 0

    def metrics(self) -> dict:
        """Service counters for monitoring (serve.py exposes at /metrics).
        Dispatch latency includes host collate, the host->device copy, the
        forward and the device->host copy of the predictions."""
        with self._m_lock:
            lat = np.asarray(self._lat_ring, dtype=np.float64)
            n_req, n_err = self._n_requests, self._n_errors
            n_disp = self._n_dispatches
        out = {
            "uptime_s": round(time.monotonic() - self._t_start, 3),
            "requests_total": n_req,
            "request_errors_total": n_err,
            "dispatches_total": n_disp,
            "mean_batch_size": round(n_req / n_disp, 3) if n_disp else None,
            "queue_depth": self._queue_depth(),
            "model": self.cfg.model,
            "best_epoch": int(self.step),
        }
        if len(lat):
            out["dispatch_latency_ms"] = {
                "p50": round(float(np.percentile(lat, 50)) * 1e3, 3),
                "p95": round(float(np.percentile(lat, 95)) * 1e3, 3),
                "max": round(float(lat.max()) * 1e3, 3),
            }
        return out


class ForecastService(_MetricsMixin):
    """Restores one experiment and serves micro-batched forecasts.

    Use `forecast(instances)` for a synchronous call, `submit(instance)`
    for a Future-based async call, and `close()` to stop the batcher.
    `device` defaults to cuda (the card the experiment's `gpu` names,
    device.resolve_run_device) and raises when CUDA is absent; pass
    device="cpu" to run on the CPU.
    """

    def __init__(self, checkpoint_dir: str, cfg: Config | None = None,
                 max_batch: int = 32, max_wait_ms: float = 5.0,
                 device: str | torch.device | None = None):
        if cfg is None:
            cfg = load_saved_config(os.path.join(checkpoint_dir, "config.json"))
        self.cfg = cfg
        # the experiment's --gpu picks the card, as JAX predict.py:68-77 does
        self.device = resolve_run_device(device, cfg.gpu, cfg.mesh_shape)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3

        from .fusion.fusion_model import FusionModel
        from .llm.loader import get_d_model
        from .models import get_model
        from .training.checkpoint import load_weights
        from .training.optim import cast_frozen
        from .training.trainer import make_forward, make_loader_wrappers

        d_txt = 0
        if cfg.enable_text:
            # same resolution rule as FusionModel: explicit cfg.d_txt wins,
            # else the fusion LLM's hidden size
            d_txt = cfg.d_txt if cfg.d_txt is not None else get_d_model(cfg.llm_model_fusion)
        self.d_txt = d_txt
        self.time_max = float(cfg.history + cfg.pred_window)

        state = load_weights(os.path.join(checkpoint_dir, "best"),
                             map_location=self.device)
        self.model = get_model(cfg).to(self.device).eval()
        cast_frozen(self.model, cfg.frozen_param_dtype)  # TimeLLM's bf16 GPT-2, if asked
        self.model.load_state_dict(state["model"])
        self.fusion = None
        if cfg.enable_text:
            # the notes' width the experiment was trained on, as its input_proj
            # holds it; a request's embeddings must still be d_txt wide
            # (_build_chunk), the JAX package's rule
            d_notes = state["fusion"]["ttf.input_proj.weight"].shape[1]
            if cfg.use_text_embeddings and d_notes != d_txt:
                raise ValueError(
                    f"this experiment was trained on notes {d_notes} wide, but a request's "
                    f"note embedding must be d_txt={d_txt} wide: neither package can serve "
                    "it (ROADMAP.md, Queue 3)")
            self.fusion = FusionModel(cfg, d_notes=d_notes).to(self.device).eval()
            self.fusion.load_state_dict(state["fusion"])
        self.step = int(state["step"])
        self._forward = make_forward(cfg, self.model, self.fusion)
        # the LatentODE's batch shares one union time grid: coalescing
        # requests would make a request's ODE discretization, and so its
        # answer, depend on its batch neighbours. It is dispatched one
        # request at a time (imm_tsf_tpu/serving.py:346-350)
        self._coalesce = cfg.model != "LatentODE"

        # loader stages (raw-text embedding with its cache), built once
        # over a one-batch proxy; the frozen LLM lives on self.device
        self._proxy = _OneBatchProxy()
        stage = self._proxy
        for wrap in make_loader_wrappers(cfg, self.device):
            stage = wrap(stage)
        self._stage_top = stage

        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._lock = threading.Lock()  # orders submit() vs close()

        self._init_metrics()  # serve.py's /metrics counters

        # the worker's first dispatch is a warmup on a dummy request: it
        # builds the CUDA kernels and warms the device libraries on the
        # thread that serves, so no client waits on either; a failure
        # there raises here
        self._warm: Future = Future()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self._warm.result()

    # ------------------------------------------------------------- data
    def _dummy_chunk(self) -> Chunk:
        cfg, D = self.cfg, self.cfg.input_dim
        n, m = min(4, cfg.input_len), min(2, cfg.pred_len)
        tt = np.linspace(0, cfg.history * 0.9, n, dtype=np.float32)
        tp = np.linspace(cfg.history, self.time_max, m, dtype=np.float32)
        payloads: list = []
        note_times = np.zeros(0, np.float32)
        if cfg.enable_text:
            note_times = np.asarray([0.0], np.float32)
            payloads = ([np.ones(self.d_txt, np.float32)]
                        if cfg.use_text_embeddings else ["service warmup note"])
        return Chunk(
            chunk_id="warmup_chunk0",
            tt=np.concatenate([tt, tp]),
            vals=np.zeros((n + m, D), np.float32),
            mask=np.ones((n + m, D), np.float32),
            note_times=note_times, note_payloads=payloads,
        )

    def _collate(self, chunks: list[Chunk], pad_to: int | None = None) -> dict:
        """Host batch of `chunks`, through the loader stages (raw-text
        notes are embedded here)."""
        self._proxy.batch = collate_chunks(self.cfg, chunks, self.d_txt, self.time_max,
                                           pad_to or self.max_batch)
        return next(iter(self._stage_top))

    def to_device(self, out: dict) -> dict:
        """Host batch -> tensors on the service's device (pinned host
        memory and non_blocking copies on cuda)."""
        dev = {}
        for k, v in out.items():
            if not isinstance(v, np.ndarray):
                continue
            t = torch.from_numpy(v)
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            dev[k] = t
        return dev

    def _predict(self, out: dict) -> np.ndarray:
        with torch.inference_mode():
            return self._forward(self.to_device(out)).cpu().numpy()

    # -------------------------------------------------------------- api
    def submit(self, instance: dict) -> Future:
        """Validate + enqueue one instance. Validation happens HERE, per
        instance, so a malformed request can never fail the concurrent
        requests it would have been micro-batched with."""
        built = _build_chunk(instance, self.cfg, self.d_txt)
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            self._q.put((built, fut))
        return fut

    def forecast(self, instances: list[dict]) -> list[dict]:
        # validate ALL instances before enqueuing ANY: a malformed instance
        # late in the list must not leave earlier ones dispatched to the
        # device with results nobody reads
        built = [_build_chunk(i, self.cfg, self.d_txt) for i in instances]
        futs: list[Future] = []
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            for b in built:
                fut: Future = Future()
                self._q.put((b, fut))
                futs.append(fut)
        return [f.result() for f in futs]

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)
        self._worker.join(timeout=30)
        if self._worker.is_alive():
            # still mid-dispatch: do NOT drain — we would race the live
            # worker for queued items and could steal its shutdown sentinel
            # (deadlocking it). It will serve the remaining queue and exit
            # on the sentinel.
            logger.warning("ForecastService.close(): worker still busy "
                           "after 30s; queued requests will be served "
                           "before the worker exits")
            return
        # worker is gone (popped the sentinel mid-queue, or crashed) —
        # resolve anything still queued so no client future is stranded
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[1].done():
                item[1].set_exception(RuntimeError("service closed"))

    # ------------------------------------------------------------ worker
    def _loop(self):
        try:
            self._predict(self._collate([self._dummy_chunk()]))
        except Exception as e:
            self._warm.set_exception(e)
            return
        self._warm.set_result(None)
        while True:
            item = self._q.get()
            if item is None:
                return
            batch = [item]
            deadline = time.monotonic() + self.max_wait_s
            while self._coalesce and len(batch) < self.max_batch:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=rem)
                except queue.Empty:
                    break
                if nxt is None:
                    self._run(batch)
                    return
                batch.append(nxt)
            self._run(batch)

    def _run(self, batch):
        t0 = time.monotonic()
        # claim the futures: a client-cancelled future would make
        # set_result raise InvalidStateError and poison its batchmates
        batch = [(b, f) for b, f in batch if f.set_running_or_notify_cancel()]
        if not batch:
            return
        try:
            results = self._infer([built for built, _ in batch])
            for (_, fut), res in zip(batch, results):
                fut.set_result(res)
            err = 0
        except Exception as e:  # fan the failure out; keep serving
            logger.exception("dispatch of %d requests failed", len(batch))
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(e)
            err = len(batch)
        self._record_dispatch(len(batch), err, time.monotonic() - t0)

    def _queue_depth(self) -> int:
        return self._q.qsize()

    # ----------------------------------------------------------- compute
    def _infer(self, built: list[tuple]) -> list[dict]:
        out = self._collate([b[0] for b in built])
        return gather_results(self.cfg, built, out, self._predict(out))
