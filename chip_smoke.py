#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

 1. the card: `nvidia-smi` name and power limit, torch's device name;
    TF32 off for matmuls and cuDNN (every comparison here is float32);
 2. build both CUDA kernels from `imm_tsf_torch/csrc/` with nvcc (one
    process per source, in parallel) and print the build time;
 3. hold each kernel against its plain PyTorch version on the card:
      recency average at the serving shape (B=64, N=8, T=24, d=768) and a
      ragged case (B=3, N=5, T=7, one sample without notes), to
      |err| <= 1e-5 + 1e-5|ref| (float32, N-term sums in another order);
      fused FFN at M=8192, D=512, F=2048 (gelu, no dropout), relu with
      dropout (keep 0.9) and a ragged M=1000, to |err| <= 1e-4 + 1e-4|ref|
      (float32, K=2048 sums in another order); with dropout the zero
      patterns of both hash-dropout sites must equal the hash bits
      exactly (structured inputs make them visible in the output);
 4. serve: a full-width PatchTST (d_model 512, d_ff 2048, 2 heads, one
    layer) + TTF_RecAvg + MMF_GR_Add (d_txt 768, GPT2) experiment with
    seeded random weights, through `ForecastService(max_batch=64,
    device="cuda")`, answering 1024 ragged requests from 8 threads;
    every answer must be finite with the requested rows, both kernels'
    launch counts (zeroed just before) must grow, and one dispatch's batch
    through the same modules with both kernels swapped for their plain
    versions must agree to |err| <= 1e-4 + 1e-4|ref|; then one
    uncontended dispatch is traced with torch.profiler (host ms, device
    busy ms, idle share, kernel launches, top device ops);
 5. time each kernel and its plain version at the serving shapes and
    print one JSON line {"kernels": [...]} with the bound each is held to.

The last line is {"ok": true, "device": {...}}. Without CUDA, or without
the repository beside it (imm_tsf_torch does not import), the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
from torch import nn

from imm_tsf_torch.config import Config
from imm_tsf_torch.fusion.fusion_model import FusionModel
from imm_tsf_torch.kernels import _build, ffn, recavg
from imm_tsf_torch.layers.fast_dropout import _keep_mask
from imm_tsf_torch.layers.transformer import EncoderLayer
from imm_tsf_torch.models import get_model
from imm_tsf_torch.serving import ForecastService, _build_chunk
from imm_tsf_torch.training.checkpoint import save_experiment

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense, without sparsity)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12

SEED = 0  # weights, requests and kernel inputs
N_REQUESTS = 1024
KEEP = 0.9
RECAVG_TOL = (1e-5, 1e-5)  # (atol, rtol)
FFN_TOL = (1e-4, 1e-4)
SERVE_TOL = (1e-4, 1e-4)

SERVE_CFG = dict(
    model="PatchTST", dataset="EPA-Air", history=7, pred_window=7, stride=7,
    time_unit="days", d_model=512, d_ff=2048, n_heads=2, e_layers=1,
    input_dim=8, input_len=48, pred_len=24, enable_text=True,
    use_text_embeddings=True, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
    llm_model_fusion="GPT2", d_txt=768, use_pallas=True, use_fused_ffn=True,
)


def log(msg: str) -> None:
    print(msg, flush=True)


def max_err(got, want, tol) -> float:
    """Max |got - want|; raises unless |err| <= atol + rtol*|want| everywhere."""
    atol, rtol = tol
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{int(bad.sum())} elements outside atol={atol} rtol={rtol}; "
            f"max |err| {float(err.max()):.3e}; finite={bool(torch.isfinite(got).all())}")
    return float(err.max())


# ----------------------------------------------------------------- inputs
def recavg_inputs(B, N, T, d, gen, device, empty_sample=False):
    tau = torch.rand((B, N), generator=gen, device=device) * 7.0   # raw note days
    t_hat = 0.5 + 0.5 * torch.rand((B, T), generator=gen, device=device)
    V = torch.randn((B, N, d), generator=gen, device=device)
    mask = (torch.rand((B, N), generator=gen, device=device) < 0.8).float()
    if empty_sample:
        mask[-1] = 0.0
    sigma = torch.tensor(0.6, device=device)
    return tau, t_hat, V, mask, sigma


def ffn_inputs(M, D, F, gen, device):
    """A layer's weights at torch.nn.Linear init scale, x ~ N(0, 1) like a
    LayerNorm output; W1 [D, F], W2 [F, D] as views of [out, in] weights."""
    def u(shape, fan_in):
        b = 1.0 / math.sqrt(fan_in)
        return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * b

    x = torch.randn((M, D), generator=gen, device=device)
    w1 = u((F, D), D).t()
    w2 = u((D, F), F).t()
    b1, b2 = u((F,), D), u((D,), F)
    gamma = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=device)
    beta = 0.1 * torch.randn((D,), generator=gen, device=device)
    salts = torch.randint(0, 2**32, (2, 2), generator=gen, device=device, dtype=torch.int64)
    return [x, w1, b1, w2, b2, gamma, beta, salts]


def dropout_probe_inputs(M, D, F, site, salts, device):
    """Inputs whose LayerNorm output is > 0 exactly where dropout kept the
    element: x = 0, gamma = 1, beta = 0, relu.
      site "output": W2 = 0, b2 = 1 -> r = drop_b(1), so out > 0 <=> keep_b.
      site "hidden": W1 = 0, b1 = 1, W2 = [I; 0], b2 = 0 -> r[:, c] =
        drop_b(drop_a(1)[:, c]), so out > 0 <=> keep_a[:, :D] & keep_b.
    Returns (args, expected bool mask) from the plain hash bits."""
    z = lambda *s: torch.zeros(s, device=device)
    x, gamma, beta = z(M, D), torch.ones(D, device=device), z(D)
    s = salts.to(torch.int64).reshape(2, 2)
    keep_b = _keep_mask(s[1, 0], s[1, 1], KEEP, (M, D), device)
    if site == "output":
        w1, b1, w2, b2 = z(D, F), z(F), z(F, D), torch.ones(D, device=device)
        expect = keep_b
    else:
        w1, b1 = z(D, F), torch.ones(F, device=device)
        w2 = torch.eye(F, D, device=device)
        b2 = z(D)
        keep_a = _keep_mask(s[0, 0], s[0, 1], KEEP, (M, F), device)
        expect = keep_a[:, :D] & keep_b
    return [x, w1, b1, w2, b2, gamma, beta, salts], expect


# ---------------------------------------------------------------- phase 3
def check_kernels(device, shapes, gen) -> dict:
    """Each kernel against its plain version; returns max errors by case."""
    errs = {}
    for case, (B, N, T, d), empty in (("recavg serving", shapes["recavg"], False),
                                      ("recavg ragged", (3, 5, 7, 300), True)):
        args = recavg_inputs(B, N, T, d, gen, device, empty_sample=empty)
        got = recavg.recency_weighted_average(*args)
        want = recavg.recavg_reference(*args)
        errs[case] = max_err(got, want, RECAVG_TOL)
        if empty:
            assert bool((got[-1] == 0).all()), "no-notes sample must give E = 0"
        log(f"# check {case} {tuple(args[2].shape)} T={T}: max|err| {errs[case]:.3e}")

    M, D, F = shapes["ffn"]
    for case, m, act, drop in (("ffn serving", M, "gelu", False),
                               ("ffn dropout", M, "relu", True),
                               ("ffn ragged", 1000, "gelu", False)):
        args = ffn_inputs(m, D, F, gen, device)
        got = ffn.fused_encoder_ffn(*args, KEEP, act, drop)
        want = ffn.ffn_reference(*args, KEEP, act, drop)
        errs[case] = max_err(got, want, FFN_TOL)
        log(f"# check {case} M={m} D={D} F={F} {act} dropout={drop}: "
            f"max|err| {errs[case]:.3e}")
    salts = ffn_inputs(8, 8, 8, gen, device)[-1]
    for site in ("output", "hidden"):
        args, expect = dropout_probe_inputs(M, D, F, site, salts, device)
        # a row that dropped nothing is constant: its sign says nothing
        rows = ~expect.all(dim=1)
        got = (ffn.fused_encoder_ffn(*args, KEEP, "relu", True) > 0)[rows]
        want = (ffn.ffn_reference(*args, KEEP, "relu", True) > 0)[rows]
        expect = expect[rows]
        if not (torch.equal(got, expect) and torch.equal(want, expect)):
            raise AssertionError(
                f"dropout zero pattern at the {site} site differs: kernel "
                f"{int((got != expect).sum())}, plain {int((want != expect).sum())} "
                f"of {expect.numel()} elements")
        log(f"# check ffn {site}-site dropout zeros: identical to the hash bits "
            f"({int((~expect).sum())} dropped of {expect.numel()})")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------- phase 4
def seeded_weights(module, gen) -> None:
    """Fill every parameter from `gen`: Linear at torch's init scale,
    LayerNorm near identity, GRU tensors U(+/-1/sqrt(H)), sigma near 1."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                b = 1.0 / math.sqrt(m.in_features)
                m.weight.copy_((torch.rand(m.weight.shape, generator=gen) * 2 - 1) * b)
                if m.bias is not None:
                    m.bias.copy_((torch.rand(m.bias.shape, generator=gen) * 2 - 1) * b)
            elif isinstance(m, nn.LayerNorm):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape, generator=gen))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=gen))
        for name, p in module.named_parameters():
            if name.split(".")[-1].startswith("gru_"):
                H = p.shape[-1] // 3
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) / math.sqrt(H))
            elif name.endswith("log_recency_sigma"):
                p.fill_(math.log(1.5))


def make_experiment(exp_dir: str, cfg_kw: dict, seed: int):
    cfg = Config(**cfg_kw)
    gen = torch.Generator().manual_seed(seed)
    model, fusion = get_model(cfg), FusionModel(cfg)
    seeded_weights(model, gen)
    seeded_weights(fusion, gen)
    save_experiment(exp_dir, cfg, model.state_dict(), fusion.state_dict(), step=0)
    return cfg


def make_requests(cfg, n: int, seed: int) -> list[dict]:
    """Ragged requests: 0..input_len observations with NaN holes,
    1..pred_len forecast times, 0-8 notes, every third with mean/std."""
    rng = np.random.default_rng(seed)
    D, hist = cfg.input_dim, float(cfg.history)
    tmax = hist + cfg.pred_window
    out = []
    for i in range(n):
        k = int(rng.integers(0, cfg.input_len + 1))
        m = int(rng.integers(1, cfg.pred_len + 1))
        tt = np.sort(rng.choice(np.linspace(0, hist * 0.999, 4 * cfg.input_len), k, replace=False))
        vals = rng.standard_normal((k, D))
        vals[rng.random(vals.shape) < 0.2] = np.nan
        tp = np.sort(rng.choice(np.linspace(hist, tmax, 4 * cfg.pred_len), m, replace=False))
        inst = {"observed_tp": tt.tolist(), "observed_data": vals.tolist(),
                "tp_to_predict": tp.tolist(),
                "notes": [{"tau": float(rng.uniform(0, hist)),
                           "embedding": rng.standard_normal(cfg.d_txt).tolist()}
                          for _ in range(int(rng.integers(0, 9)))]}
        if i % 3 == 0:
            inst["mean"] = rng.standard_normal(D).tolist()
            inst["std"] = (0.5 + rng.random(D)).tolist()
        out.append(inst)
    return out


def serve_requests(svc, requests, n_threads: int = 8) -> list[dict]:
    """Submit from `n_threads` client threads; answers in request order."""
    results: list = [None] * len(requests)
    errors: list = []

    def client(idx):
        try:
            futs = [(i, svc.submit(requests[i])) for i in idx]
            for i, f in futs:
                results[i] = f.result(timeout=600)
        except Exception as e:  # reported below; the phase fails
            errors.append(e)

    threads = [threading.Thread(target=client, args=(range(t, len(requests), n_threads),))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"serving failed: {errors[:1] or 'client thread hung'}")
    return results


def set_kernels(svc, on: bool) -> None:
    """Route the service's modules through the kernels (on) or their plain
    versions (off); the parameters are the same tensors either way."""
    for m in svc.model.modules():
        if isinstance(m, EncoderLayer):
            m.use_fused_ffn = on
    svc.fusion.ttf.use_pallas = on


def run_serving(device, n_requests: int, seed: int, exp_dir: str) -> dict:
    cfg = make_experiment(exp_dir, SERVE_CFG, seed)
    t0 = time.monotonic()
    svc = ForecastService(exp_dir, max_batch=64, max_wait_ms=5.0, device=device)
    log(f"# service up in {time.monotonic() - t0:.2f} s (includes one warmup dispatch)")
    try:
        requests = make_requests(cfg, n_requests, seed)
        d0 = svc.metrics()["dispatches_total"]
        ffn.launches = recavg.launches = 0
        t0 = time.monotonic()
        answers = serve_requests(svc, requests)
        wall = time.monotonic() - t0
        launches = {"fused_encoder_ffn": ffn.launches,
                    "recency_weighted_average": recavg.launches}
        metrics = svc.metrics()
        dispatches = metrics["dispatches_total"] - d0
        for name, n in launches.items():
            if n == 0 and device.type == "cuda":  # CPU tensors take the plain versions
                raise AssertionError(f"{name} was never launched while serving")
        for inst, ans in zip(requests, answers):
            y = np.asarray(ans["prediction"])
            if y.shape != (len(inst["tp_to_predict"]), cfg.input_dim) or not np.isfinite(y).all():
                raise AssertionError(f"bad answer shape {y.shape} or non-finite values")
        log(f"# served {len(requests)} requests in {dispatches} dispatches, "
            f"{wall:.3f} s: {len(requests) / wall:.1f} requests/s, dispatch p50 "
            f"{metrics['dispatch_latency_ms']['p50']} ms p95 "
            f"{metrics['dispatch_latency_ms']['p95']} ms; launches {launches}")
        log("# dispatch latencies in order (ms): "
            + " ".join(f"{t * 1e3:.1f}" for t in list(svc._lat_ring)[-dispatches:]))

        # one full dispatch's batch, kernels vs plain versions, same modules

        built = [_build_chunk(r, cfg, svc.d_txt) for r in requests[:64]]
        out = svc._collate([b[0] for b in built])
        batch = svc.to_device(out)
        with torch.inference_mode():
            got = svc._forward(batch)
            set_kernels(svc, False)
            try:
                want = svc._forward(batch)
            finally:
                set_kernels(svc, True)
        err = max_err(got, want, SERVE_TOL)
        pm = svc.model  # PatchTST: rows reaching the FFN = batch * channels * patches
        n_patches = (3 * cfg.input_len + pm.stride - pm.patch_len) // pm.stride + 1
        log(f"# dispatch batch {tuple(batch['observed_data'].shape)} notes "
            f"{tuple(batch['notes_embeddings'].shape)}: kernels vs plain max|err| {err:.3e}")
        forward_ms, profile = {}, None
        if device.type == "cuda":
            for mode in ("plain", "kernels", "kernels", "plain"):  # in turns
                set_kernels(svc, mode == "kernels")
                # the first call after a switch warms up
                forward_ms.setdefault(mode, []).extend(wall_ms(svc._forward, batch, reps=11)[1:])
            set_kernels(svc, True)
            forward_ms = {k: float(np.median(v)) for k, v in forward_ms.items()}
            log(f"# one dispatch's forward (host clock to synchronize): {forward_ms} ms")
            profile = profile_dispatch(svc, built)
            log(f"# one uncontended dispatch of 64 requests: {json.dumps(profile)}")
        return {"launches": launches, "dispatches": dispatches,
                "requests_per_s": len(requests) / wall,
                "dispatch_ms": metrics["dispatch_latency_ms"], "serve_err": err,
                "forward_ms": forward_ms, "dispatch_profile": profile,
                "shapes": {"ffn": (64 * cfg.input_dim * n_patches, cfg.d_model, cfg.d_ff),
                           "recavg": tuple(batch["notes_embeddings"].shape[:2])
                           + (cfg.pred_len, cfg.d_txt)}}
    finally:
        svc.close()


def profile_dispatch(svc, built, reps: int = 10) -> dict:
    """Where one uncontended dispatch of a full batch goes. Host clock
    (median of `reps`): the collate alone, and the whole dispatch
    (collate, H2D, forward, D2H, fan-out). Then `reps` dispatches under
    torch.profiler, whose host overhead makes them slower
    (`traced_dispatch_ms`): device-busy ms per dispatch is the union of
    the kernels' and copies' device intervals there, and the idle share
    is 1 - busy / the untraced dispatch ms. Raises when the trace holds
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    chunks = [b[0] for b in built]
    wall_ms(svc._infer, built, reps=1)  # warm
    collate_ms = float(np.median(wall_ms(svc._collate, chunks, reps=reps)))
    dispatch_ms = float(np.median(wall_ms(svc._infer, built, reps=reps)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = float(np.median(wall_ms(svc._infer, built, reps=reps)))
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise AssertionError("torch.profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, (s0, e0) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > e0:
            busy_us, s0 = busy_us + e0 - s0, s
        e0 = max(e0, e)
    busy_ms = (busy_us + e0 - s0) / reps / 1e3
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    by_name: dict = {}  # [us, count], summed over template and argument variants
    for e in dev:
        acc = by_name.setdefault(re.sub(r"(?<=\w)[<(].*", "", e.name), [0.0, 0])
        acc[0] += e.time_range.end - e.time_range.start
        acc[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"reps": reps, "collate_ms": collate_ms, "dispatch_ms": dispatch_ms,
            "traced_dispatch_ms": traced_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / dispatch_ms,
            "kernel_launches": len(kernels) / reps,
            "top_device": {n: {"ms": us / reps / 1e3, "launches": c / reps}
                           for n, (us, c) in top}}


def wall_ms(fn, *args, reps: int = 10) -> list[float]:
    """Host-clock ms of each of `reps` calls fn(*args), each ending in a
    synchronize; the caller warms up."""
    out = []
    with torch.inference_mode():
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


# ---------------------------------------------------------------- phase 5
def device_ms(fn, arg_sets, reps: int = 7, per_rep: int = 20) -> float:
    """Median over `reps` of the mean device time of `per_rep` back-to-back
    calls, cycling through `arg_sets`. A sleep kernel queued first keeps
    the card busy while the host enqueues, so host overhead is not timed."""
    for args in arg_sets:  # warm up
        fn(*args)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for i in range(per_rep):
            fn(*arg_sets[i % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return float(np.median(times))


def measure(device, shapes, gen, errs, serving) -> list[dict]:
    B, N, T, d = shapes["recavg"]
    rsets = [recavg_inputs(B, N, T, d, gen, device) for _ in range(4)]
    r_bytes = 4 * (B * N * 2 + B * T + B * N * d + 1 + B * T * d)
    r_flops = B * N * T * 8 + 2 * B * N * T * d + B * T * d
    M, D, F = shapes["ffn"]
    fsets = [ffn_inputs(M, D, F, gen, device) for _ in range(3)]
    f_bytes = 4 * (2 * M * D + 2 * D * F + F + 3 * D)
    f_flops = 4 * M * D * F + 10 * M * F + 10 * M * D
    rows = []
    per_dispatch = max(serving["dispatches"], 1)
    for name, src, replaces, fn, plain, sets, nbytes, flops, err, per_rep in (
        ("recency_weighted_average", "imm_tsf_torch/csrc/recavg.cu",
         "imm_tsf_tpu/ops/pallas/fusion_kernels.py:73",
         recavg.recency_weighted_average, recavg.recavg_reference, rsets,
         r_bytes, r_flops, errs["recavg serving"], 200),
        ("fused_encoder_ffn", "imm_tsf_torch/csrc/ffn.cu",
         "imm_tsf_tpu/ops/pallas/ffn_kernel.py:118",
         lambda *a: ffn.fused_encoder_ffn(*a, KEEP, "gelu", False),
         lambda *a: ffn.ffn_reference(*a, KEEP, "gelu", False), fsets,
         f_bytes, f_flops, errs["ffn serving"], 10),
    ):
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOP_PER_S * 1e3
        launches = serving["launches"][name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "ok": True, "launches": launches,
            "launches_per_dispatch": launches / per_dispatch,
            "max_abs_err": err,
            "ms": device_ms(fn, sets, per_rep=per_rep),
            "plain_ms": device_ms(plain, sets, per_rep=per_rep),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None,
            "bytes": nbytes, "flops": flops,
        })
    return rows


# ------------------------------------------------------------------- main
def main() -> int:

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2

    t_start = time.monotonic()
    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    # phase 2: build
    t0 = time.monotonic()
    secs = _build.build(["ffn", "recavg"])
    log(f"# built {sorted(secs)} in {time.monotonic() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in sorted(secs.items()))})")

    # phase 3: kernels against their plain versions
    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes = {"recavg": (64, 8, 24, 768), "ffn": (8192, 512, 2048)}
    errs = check_kernels(device, shapes, gen)

    # phase 4: serving
    exp_dir = os.path.join(REPO, "experiments", f"chip_smoke_{os.getpid()}")
    try:
        serving = run_serving(device, N_REQUESTS, SEED, exp_dir)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    if serving["shapes"] != shapes:
        raise AssertionError(f"serving shapes {serving['shapes']} != checked {shapes}")

    # phase 5: timings
    rows = measure(device, shapes, gen, errs, serving)
    log(f"# service: {serving['requests_per_s']:.1f} requests/s, dispatch p50 "
        f"{serving['dispatch_ms']['p50']} ms, total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": rows, "power": smi,
                      "requests_per_s": serving["requests_per_s"],
                      "dispatch_ms": serving["dispatch_ms"],
                      "forward_ms": serving["forward_ms"],
                      "dispatch_profile": serving["dispatch_profile"]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
