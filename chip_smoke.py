#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and no phase is skipped:

 1. the card: `nvidia-smi` name and power limit, torch's device name;
    TF32 off for matmuls and cuDNN (every comparison here is float32),
    cuDNN's deterministic algorithms (as the port's device setup has them);
 2. build the seven CUDA kernels from `imm_tsf_torch/csrc/` with nvcc
    (one process per source, in parallel) and print the build time;
 3. hold each kernel against its plain PyTorch version on the card:
      recency average at the serving shape (B=64, N=8, T=24, d=768), a
      ragged case (B=3, N=5, T=7, one sample without notes), the PatchTST
      training shape (B=32, N=8, T=36), V 4 bytes off 16-byte alignment,
      d=1024, d=767 (4k+3), N=0 (E exactly 0) and N=70 (several chunks of
      notes), to |err| <= 1e-5 + 1e-5|ref| (float32, N-term sums in another
      order);
      fused FFN at M=8192, D=512, F=2048 (gelu, no dropout), relu with
      dropout (keep 0.9) and a ragged M=1000, to |err| <= 1e-4 + 1e-4|ref|
      (float32 by three TF32 passes, K=2048 sums in another order); its
      training form at M=8192 with dropout (gelu): out, a1 and r to the
      same; with dropout the zero patterns of both hash-dropout sites must
      equal the hash bits exactly, in both forms (structured inputs make
      them visible in the output and in r); and at Informer's three FFN
      sites (M 3072, 1600, 1536), eval form and training form with dropout;
      causal attention at the shape of each embed_notes bucket call at the
      token budget (T 32-1024: [1024,12,32,64] ... [64,12,1024,64],
      right-padded notes) and a ragged [3,2,13,64] (token 0 padded in one
      sample, every token in another: exact zeros there), to |err| <= 2e-5
      + 1e-5|ref| (float32 by three TF32 passes, online softmax against the
      two-pass plain version); its backward (the kernel's forward, the plain
      hand backward) at TimeLLM's trained shapes [32,12,68,64] and
      [32,12,160,64] and the ragged case, g ~ N(0, 1), dq, dk and dv against
      autograd of the plain forward to the same tolerance (exact zeros where
      nothing is kept);
      batched expm at [64,64,64] with inf-norms 0.01, 0.5, 6 and 80 (each
      tier: Taylor-4, Taylor-12, 3 and 7 squarings), a ragged [3,24,24]
      and an all-zero batch that must give exactly I, to 1e-5 of each
      matrix's largest entry (tiered Taylor against Taylor-12); then at
      norms 0.5 and 80 on dense draws, block upper triangular ones (the
      triangular form) and triangular ones with one lower-left entry set
      (the dense form);
      fused CRU scan at the serving shape (B 64, T 72, lod 16, K 15) with
      repeat-padded tails and invalid steps, on post-means and all four
      residuals, against its plain version run in float64: within 2.5 x
      (1e-4 + 1e-4|ref|) (`check_scan`: float32 rounding alone reaches
      1.25 x there); then at lod 12 (lsd 24, the Van Loan block laid out
      at 32-offsets) on a draw of its own;
      the expm's Frechet derivative at the trained [32,64,64] with
      inf-norms 0.01-80, a ragged [3,24,24], M = 0 (exactly E) and each
      cluster size (1, 2, 4 CTAs a matrix) at norm 80, to 2e-5 of each
      matrix's largest entry; the scan's backward at the trained
      (B 32, T 72, lod 16, K 15) on #6's residuals and g ~ N(0, 1),
      against its plain version run in float64 on the same residuals,
      within SCAN_BWD_SCORE_MAX x (1e-5 max|ref| + 1e-5|ref|) on every cotangent
      but the ill-conditioned initial covariances', held relative to the
      float32 plain version's own score (`check_scan_bwd`);
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
 4b. serve raw text: the same experiment with use_text_embeddings=false
    and use_fused_attn, whose notes go through a frozen GPT-2 (768 wide,
    12 heads, 6 layers, seeded random weights, hash tokenizer) on the
    card: 256 ragged requests from 8 threads, 0-8 text notes each in a
    synthetic mix made to cover every length bucket from 32 to 1024
    (log-uniform word counts over 1-1000, a quarter of the strings
    repeated, some empty; not a traffic baseline); every answer
    finite with the requested rows, all three kernels' launch counts
    (zeroed just before) must grow, and one dispatch's notes embedded
    with the attention kernel and with the plain attention through the
    same GPT-2 must agree to |err| <= 1e-4 + 1e-4|ref|; prints real
    tokens/s of the embedding stage, requests/s, dispatch p50/p95 and one
    traced dispatch whose notes are all new (the cache cleared first);
 6. serve CRU: the CRU preset at full width (cru_lsd 32: 64 x 64 Van Loan
    blocks, hidden 32, K 15) + TTF_RecAvg + MMF_GR_Add (d_txt 768), EPA-Air
    48 + 24 steps, seeded random weights (bases N(0, 0.2^2)), in two
    services: the default route, then IMM_TSF_CRU_FUSED=1 around the
    second service's whole life; each answers 512 ragged requests from 8
    threads; every answer finite with the requested rows; launch counts
    (zeroed just before) exactly 72 expm launches a dispatch on the
    default route, one fused-scan launch a dispatch on the fused route,
    one recency average a dispatch on both; one dispatch's batch through
    kernels vs plain versions to |err| <= 1e-4 + 1e-4|ref|, the two routes
    to each other to the same; each tier's share of that dispatch's Van
    Loan blocks (all three must occur); one uncontended dispatch of each
    route traced;
 7. train: the CRU experiment of phase 6 through
    `imm_tsf_torch.main.main([...])` (TRAIN_ARGS: the presets, batch 32,
    two epochs) on the EPA-Air fixture the port's generator writes
    (TRAIN_DATA, T = 72), the default route, then IMM_TSF_CRU_FUSED=1;
    prints each epoch's train loss, val MSE and windows/s, each step's
    forward / backward / optimizer device ms (CUDA events) and the
    launches; every loss finite, and the launch counts (zeroed just
    before each run) exact: #5 T times a forward (evaluation too) and #4
    T - 1 times a step (expected_counts says why), #6 once a forward and
    #7 once a step, #1 once a forward; then one step from seeded
    weights on a validation batch (`compare_step`): exact launches of one
    step, loss and every gradient of each route's kernel path against the
    plain path and a float64 plain run, #4 and #7 held to their plain
    versions on that step's own inputs, and one traced step per route;
    the trained shapes must equal those phase 3 checked;
 8. train the main path: PatchTST + TTF_RecAvg + MMF_GR_Add through
    `imm_tsf_torch.main.main([...])` (PATCH_TRAIN_ARGS: the PatchTST preset
    at full width, d_model 512, d_ff 2048, 2 heads, 1 layer, dropout 0.1
    hash, batch 32, two epochs) on phase 7's fixture, the kernel route
    (`--use_pallas --use_fused_ffn`: #1 and #2) then the plain route
    (`--use_pallas false`); each epoch's train loss, val MSE and windows/s
    and each step's forward / backward / optimizer device ms printed;
    every loss finite; launch counts exact (#1 once a forward, #2 once a
    forward an encoder layer, its training form in the steps; nothing on
    the plain route); then one step from seeded weights at the bench
    headline's shape (B 64, L 48, Lp 24, C 8: the FFN at M 8192) three
    ways under the same salts (`compare_patchtst_step`): the kernel route,
    the plain route and a float64 plain run, loss to 1e-5 and every
    gradient within GRAD_FACTOR x the plain route's distance from float64;
    a traced step of each route and the time of #2's mask re-derivation;
    then the fusion stack on GPT2M's 1024-wide notes into d_txt 768
    (`compare_wide_notes`): one forward and backward at the serving shape
    on the kernel route (#1 once) against the plain route, outputs to
    |err| <= 1e-4 + 1e-4|ref| and gradients as the step's;
 9. Informer and the default fusion pair: (a) serve the Informer preset
    at full width (d_model 512, d_ff 2048, 2 heads, e_layers 2 with distil,
    d_layers 1, factor 3) + TTF_RecAvg + MMF_GR_Add (d_txt 768), seeded
    weights and BatchNorm statistics away from (0, 1), 512 requests from 8
    threads on the kernel route: answers finite with their rows, launch
    counts exact (3 of #2's eval form and 1 of #1 a dispatch), one
    dispatch kernels vs plain to |err| <= 1e-4 + 1e-4|ref|, one traced;
    (b) train it through `imm_tsf_torch.main.main([...])`
    (INFORMER_TRAIN_ARGS: hash dropout 0.1, batch 32, two epochs on phase
    7's fixture) on the kernel route and the plain route, counts exact (#2
    3 a forward, its training form in the steps, #1 once a forward, nothing
    plain), the trained checkpoint carrying moved BatchNorm statistics;
    then `compare_informer_step`: one step at B 64, L 48, Lp 24 kernel vs
    plain vs float64 under the same salts, ProbSparse samples and max-pool
    choices (`pinned_pools`), loss to 1e-5, gradients by `held_grads`,
    running statistics across routes to 1e-5, a traced step per route;
    (c) DLinear + TTF_T2V_XAttn + MMF_XAttn_Add (the config's default pair;
    no kernel): 256 requests on the card (no launch, one dispatch against
    the same modules on the CPU to 1e-4 + 1e-4|ref|) and two epochs of
    training, every answer and loss finite;
10. TimeLLM and raw-text training: (a) serve the TimeLLM preset at full
    width (d_model 32, d_ff 128, patches of 16, 6 GPT-2 blocks 768 wide,
    ts_vocab_size 1000) + TTF_RecAvg + MMF_GR_Add (d_txt 768), seeded
    weights, 256 ragged requests from 8 threads on the kernel route: answers
    finite with their rows, launch counts exact (#3 once a GPT-2 block and
    #1 once a dispatch), one dispatch kernels vs plain to 1e-4 + 1e-4|ref|,
    one traced; (b) train it through `imm_tsf_torch.main.main([...])`
    (TIMELLM_TRAIN_ARGS: hash dropout 0.1, batch 32, two epochs on phase 7's
    fixture) on the kernel route, the plain route and the kernel route with
    the exact prompt: every loss finite, counts exact (#3 once a block a
    forward, its backward once a block a step, #1 once a forward, nothing
    plain), the frozen GPT-2 bit for bit as drawn; (c)
    `compare_timellm_step`: one step at B 32 kernel vs plain vs float64
    under the same salts and lags (`pinned_lags`), loss to 1e-5, gradients
    by `held_grads`, a traced step per route; (d) PatchTST + TTF_RecAvg +
    MMF_GR_Add on raw-text notes (RAW_TEXT_TRAIN_ARGS) on the attention
    kernel's route and the plain attention: #3 launched in the embedding
    stage on the kernel route only, the first epoch's losses of the two
    routes to 1e-4 relative;
11. TimesNet, TimeMixer and TTM, and resume: (a) serve each preset at
    full width (MTS_MODELS, mts_cfg: TimesNet d_model 16, d_ff 32, top_k 5,
    2 blocks; TimeMixer d_model 16, d_ff 32, 3 avg downsamplings; TTM
    d_model 1024, 3 adaptive-patch levels of 3 layers, a 2-layer decoder 64
    wide, patches of 1 at the dataset stride 7) + TTF_RecAvg + MMF_GR_Add
    (d_txt 768), seeded weights, 256 ragged requests from 8 threads: answers
    finite with their rows, #1 exactly once a dispatch and nothing else,
    one dispatch kernels vs plain to 1e-4 + 1e-4|ref|, one traced; (b)
    train each through `imm_tsf_torch.main.main([...])` (MTS_TRAIN_ARGS:
    hash dropout 0.1, batch 32, two epochs on phase 7's fixture, #1 on):
    every loss finite, #1 exactly once a forward; (c) `compare_mts_step`:
    one step at B 32 kernel vs plain vs float64 under the same salts,
    TimesNet's routes on the float64 run's frequency bins
    (`pinned_periods`, flips printed), loss to 1e-5, gradients by
    `held_grads`, a traced step per route; (d) `run_resume`: phase 8's
    kernel route as `--load resume --epoch 1` (nothing to resume: trained
    from scratch), then `--load resume --epoch 2`, launches exact a run,
    held to phase 8's uninterrupted two epochs bit for bit (per-step
    losses, val MSEs, test metrics, final weights); the ops torch's
    deterministic mode names over one step are printed, and only such an
    op may explain a gap, within RESUME_RTOL;
12. LatentODE, NeuralFlow and tPatchGNN, and the LatentODE's resume: (a)
    serve each preset (IMTS_MODELS, imts_cfg: LatentODE rec / units / gru
    32, 4 rk4 substeps; NeuralFlow coupling, 2 flow layers, hidden 3 x 32,
    rec 40, latents 20; tPatchGNN hid 32, te 10, node 10, 1 head, 1 layer,
    patched as SERVED_PATCHING: 4 patches of 2 days, each holding points)
    + TTF_RecAvg + MMF_GR_Add (d_txt 768), seeded weights, 256 ragged
    requests from 8 threads (the LatentODE 64, a request a dispatch, its
    union time axis): answers finite with their rows, #1 exactly once a
    dispatch and nothing else, one dispatch kernels vs plain to 1e-4 +
    1e-4|ref|, one traced; (b) train each through
    `imm_tsf_torch.main.main([...])` (IMTS_TRAIN_ARGS: hash dropout 0.1,
    batch 32, two epochs on phase 7's fixture, #1 on; tPatchGNN's npatch
    the reference's derivation from the flags before the presets, printed
    with the patches holding points): every loss finite, #1 exactly once a
    forward; (c) `compare_imts_step`: one step at B 32 on requests through
    the service's collate, kernel vs plain vs float64 under the same salts
    and one pinned z0 noise (`pinned_z0`), loss to 1e-5, gradients by
    `held_grads`, a traced step per route; (e) `check_ode_drift`: the
    LatentODE's eval forward over a union axis of the trained length (768
    times, B 32, a seeded batch), float32 against float64 on the card,
    within 4x the JAX package's own distance on the CPU plus 1e-6
    (ODE_DRIFT_MAX, from tools/torch_ode_drift.py); (d) `run_resume`: the
    LatentODE's run resumed with `--load resume --epoch 2` from (b)'s own
    epoch-0 train state, its second epoch bit for bit against (b)'s (the z0
    generator in the state); then #1 at each union
    prediction axis the LatentODE trained on, with the 1-D t_hat expanded
    as TTF_RecAvg expands it, against its plain version;
13. BERT, Llama-3.1-8B and DeepSeek-7B as frozen LLMs, full width at the
    config's depth (6 layers), random weights drawn on the card from a
    seed: (a) phase 4b's raw-text experiment with each as its fusion LLM
    (BERT at 512 tokens), 64 requests each: answers finite, #1 once and #2
    once an encoder layer a dispatch, #3 never; one dispatch kernels vs
    plain to 1e-4 + 1e-4|ref|; that dispatch's notes in float32 and in
    bfloat16 (embed_notes' compute_dtype), real tokens/s of each and the
    bfloat16 notes within 0.05 x scale; one bucket call at full width and
    2 layers (`llm_drift_case`) in float32 against float64 on the card,
    within 4 x the JAX package's own distance on the CPU plus 1e-6
    (LLM_DRIFT_MAX, from tools/torch_llm_drift.py); (b) one 1024-token
    bucket call at the token budget (64 rows) through the 6-layer Llama,
    then one short-note call through the full 32-layer Llama-3.1-8B (7.50
    B parameters), each in float32 and in bfloat16: peak device memory
    and real tokens/s (an out-of-memory is reported); (c) the embedding
    stage (`imm_tsf_torch.compute_text_embeddings`) on phase 7's fixture
    with the 6-layer Llama in float32 and in bfloat16, its steady tokens/s,
    the bfloat16 artifacts within 0.05 x scale; then phase 8's kernel
    route trained on the float32 artifacts (4096-wide notes into d_txt
    768), #1 and #2 exact; (d) TimeLLM with BERT and with Llama (6 layers,
    4096 wide), trained through `imm_tsf_torch.main` (BERT two epochs,
    Llama one; the frozen LLM bit for bit as drawn; each checkpoint
    write's seconds printed), the trained experiment served (64 requests,
    #1 once a dispatch, nothing else), one compared step kernels vs plain
    vs float64 (`compare_model_step`); each run's peak device memory;
14. the default training path, the device-resident epoch loop
    (`training/device_loop.py`) with each step a CUDA graph replay
    (`training/graphs.py`), through `imm_tsf_torch.main` without
    `--device_loop false` (phases 7-13 pin it, STREAM), against the
    streaming loop on the same flags, three epochs a run (epoch 0 warms up
    and captures, epoch 1 traced for the idle share, epoch 2 timed):
    (a) phase 8's PatchTST kernel route, (b) phase 7's CRU on each route,
    (c) phase 9's Informer kernel route: per-step losses and test metrics
    within LOOP_RTOL (1e-5) relative of the streaming run's, the same best
    epoch, launch counts exact in both loops (a replay counts the launches
    of its capture), each run's windows/s, step ms (a replay's by CUDA
    events), idle share, capture seconds and graph nodes printed; (d)
    TimesNet on eager resident steps (its periods are read on the host),
    held the same way, and the LatentODE on the staged loop (phase 12's 4
    entities), against phase 12's streaming run (printed: the hash masks
    over its longer staged union axes differ); (e) 14a's run resumed on
    the epoch loop from its epoch-0 state (`--load`), bit for bit;
 5. (after 6-14) time each kernel and its plain version at the shapes
    of its path (#1 also at the training shape, beside its previous design
    and an empty kernel launched on its grid, the launch floor; the
    attention at every bucket shape, beside
    scaled_dot_product_attention with the same boolean mask; the expm on
    the 72 Van Loan blocks of a served dispatch, beside
    torch.linalg.matrix_exp; the fused scan on that dispatch's scan
    inputs; the Frechet derivative on a training step's 72 [32,64,64]
    calls, beside matrix_exp of the 128-square block; the scan backward
    on that step's inputs; #2's training form and its plain backward at
    M 8192, and both forms at Informer's three sites) and print one JSON
    line {"kernels": [...]}
    (seven rows) with the bound each is held to (#4-#7 from the data's
    own tiers and squarings; #2 and #3 at 3 x their products' FLOPs on
    the TF32 tensor cores, the fp32-FMA bound beside it as bound_fma_ms,
    which #4 gives too; #4 and #7 with their cluster size, the clusters
    the card holds at once and the SMs in use, and their time at each
    cluster size; #5 with the share of the served blocks that take its
    triangular form; #3 also over the raw-text run's own launches, each
    launched shape timed and bounded; at TimeLLM's two shapes its forward,
    its plain backward (bound: five products to the forward's two) and
    SDPA's autograd backward beside it).

The last line is {"ok": true, "device": {...}}. Without CUDA, or without
the repository beside it (imm_tsf_torch does not import), the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
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

from imm_tsf_torch import compute_text_embeddings as embed_stage
from imm_tsf_torch import main as train_main
from imm_tsf_torch.config import (DATASET_PRESETS, MODEL_PRESETS, Config, apply_presets,
                                  load_saved_config, resolve_max_length)
from imm_tsf_torch.data.dataset import embeddings_filename
from imm_tsf_torch.data.loader import parse_datasets
from imm_tsf_torch.data.synthetic import make_synthetic_dataset
from imm_tsf_torch.fusion.fusion_model import FusionModel
from imm_tsf_torch.kernels import _build, attn, cru_scan, expm, ffn, recavg
from imm_tsf_torch.kernels._cluster import CLUSTER_SIZES
from imm_tsf_torch.layers.fast_dropout import Dropout, _keep_mask
from imm_tsf_torch.layers import transformer as transformer_layers
from imm_tsf_torch.layers.prob_attention import ProbAttention
from imm_tsf_torch.layers.transformer import BatchNorm, DecoderLayer, EncoderLayer
from imm_tsf_torch.llm.gpt2 import GPT2Block
from imm_tsf_torch.llm import loader as llm_loader
from imm_tsf_torch.llm.loader import EMBED_BUCKETS, embed_notes, get_d_model
from imm_tsf_torch.models import get_model
from imm_tsf_torch.models import timellm, timesnet
from imm_tsf_torch.models.cru import CRU
from imm_tsf_torch.ops import cru_scan as cru_ops
from imm_tsf_torch.ops import expm as ops_expm
from imm_tsf_torch.ops.expm import expm_frechet_taylor12, expm_taylor12
from imm_tsf_torch.serving import ForecastService, _build_chunk
from imm_tsf_torch.training.checkpoint import save_experiment
from imm_tsf_torch.training.optim import FROZEN_SUBTREE, make_optimizer, trainable_parameters
from imm_tsf_torch.training.trainer import make_forward, make_grad_step, make_loss_fn, to_device

REPO = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data-sheet peaks (dense, without sparsity)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12  # tensor cores; #3 runs 3 TF32 passes a product

SEED = 0  # weights, requests and kernel inputs
N_REQUESTS = 1024
N_TEXT_REQUESTS = 256
KEEP = 0.9
RECAVG_TOL = (1e-5, 1e-5)  # (atol, rtol)
FFN_TOL = (1e-4, 1e-4)
ATTN_TOL = (2e-5, 1e-5)
SERVE_TOL = (1e-4, 1e-4)
EMBED_TOL = (1e-4, 1e-4)  # pooled notes after 6 layers, kernel vs plain attention
EXPM_RTOL = 1e-5  # per matrix, max|err| <= 1e-5 max|ref| (tests/test_ops_expm.py:55-67)
# 72 Kalman steps, each an expm in another summation order; held against the
# float64 plain run (check_scan), since float32 rounding alone reaches it
SCAN_TOL = (1e-4, 1e-4)
# check_scan's limit in units of SCAN_TOL: on the check's inputs the float32
# plain version itself scores 1.25 and the kernel 1.73 on the H100 (PERF.md);
# twice the plain version's reading
SCAN_SCORE_MAX = 2.5
FRECHET_RTOL = 2e-5  # per matrix, max|err| <= 2e-5 max|ref| (tests/test_ops_expm.py:117)
# the scan's backward, held like the forward to its plain version run in
# float64 on the same residuals (check_scan_bwd); atol relative to each
# cotangent's largest entry
SCAN_BWD_TOL = (1e-5, 1e-5)
# twice the float32 plain version's largest score on the card (0.728, gW on
# phase 3's third draw; the kernel's largest 0.723), PERF.md
SCAN_BWD_SCORE_MAX = 1.5
# the initial covariances' cotangents sum small per-sample values of both
# signs over the batch (the initial variance 10 makes the first gains
# nearly 1), so their float32 error against their own scale depends on how
# far the sum cancels: the float32 plain version scored 217 and 1646 on
# gicu of two training steps (the kernel 277 and 936), PERF.md. No fixed
# limit holds there: gicu and gicl may score at most this many times the
# float32 plain version's own score, plus SCAN_BWD_SCORE_MAX
SCAN_BWD_ICOV_FACTOR = 2.0
CRU_SERVE_TOL = (1e-4, 1e-4)
N_CRU_REQUESTS = 512
# phase 7: one step's loss, kernel path vs plain path (float32, 72 Kalman
# steps through expms of another algorithm); each gradient's error against
# the float64 plain path at most GRAD_FACTOR times the float32 plain
# path's plus GRAD_FLOOR (some gradients are ill-conditioned in float32: the
# initial covariances' stray by percent, and by different amounts for
# algorithms of equal accuracy, tests/test_torch_cru_grad.py)
TRAIN_LOSS_RTOL = 1e-5
GRAD_FACTOR = 4.0
# the initial covariances' gradients (log_icu, log_icl) are the
# ill-conditioned ones: on the card the kernel path's log_icu error was
# 3.6 x the plain path's (0.028 vs 0.0078 of its largest entry, the card
# test's fixture), PERF.md
ICOV_GRAD_FACTOR = 10.0
# a gradient reduced over 32 x 72 x 768 float32 terms (TTF's sigma) is good
# to about 1e-5 of its largest entry in any summation order
GRAD_FLOOR = 1e-5
MAX_SQUARINGS = 7  # ops.expm / ops.cru_scan default, as in the JAX package
BASIS_STD = 0.2  # the CRU's banded bases, N(0, 0.2^2) (tests/test_cru_fused_scan.py:37-38)

SERVE_CFG = dict(
    model="PatchTST", dataset="EPA-Air", history=7, pred_window=7, stride=7,
    time_unit="days", d_model=512, d_ff=2048, n_heads=2, e_layers=1,
    input_dim=8, input_len=48, pred_len=24, enable_text=True,
    use_text_embeddings=True, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
    llm_model_fusion="GPT2", d_txt=768, use_pallas=True, use_fused_ffn=True,
)
# raw-text notes through the frozen GPT-2 (768 wide, 12 heads) at the
# config's depth, 6 layers (not cut)
TEXT_CFG = dict(SERVE_CFG, use_text_embeddings=False, use_fused_attn=True,
                llm_layers_fusion=6)
# the CRU preset (cru_lsd 32: a 64 x 64 Van Loan block; hidden 32; K 15 bases
# of bandwidth 3) behind the same fusion stack, EPA-Air 48 + 24 steps
CRU_CFG = dict(
    model="CRU", dataset="EPA-Air", history=7, pred_window=7, stride=7,
    time_unit="days", input_dim=8, input_len=48, pred_len=24, enable_text=True,
    use_text_embeddings=True, TTF_module="TTF_RecAvg", MMF_module="MMF_GR_Add",
    llm_model_fusion="GPT2", d_txt=768, use_pallas=True, **MODEL_PRESETS["CRU"],
)
# phase 7 trains that experiment through imm_tsf_torch.main as a user
# would (the CRU and EPA-Air presets, batch 32, lr 1e-3, w_decay 0.01,
# dropout 0.1 hash, patience 3), two epochs, on the EPA-Air fixture the
# port's generator writes: 8 entities, 8 features, 240 days, 3.25
# observations and 1 note a day, 768-wide note embeddings (T = 36 + 36)
TRAIN_DATA = dict(n_entities=8, n_features=8, n_days=240, obs_per_day=3.25, notes_per_day=1.0,
                  d_txt=768, seed=SEED)
TRAIN_ARGS = ["--dataset", "EPA-Air", "--model", "CRU", "--overwrite_args", "--enable_text",
              "--use_text_embeddings", "--TTF_module", "TTF_RecAvg", "--MMF_module",
              "MMF_GR_Add", "--llm_model_fusion", "GPT2", "--epoch", "2", "--seed", str(SEED)]
# phase 8 trains the bench headline experiment, PatchTST + TTF_RecAvg +
# MMF_GR_Add, the same way on the same fixture: the PatchTST preset (2
# heads, 1 layer) at the default full widths (d_model 512, d_ff 2048),
# dropout 0.1 hash; the kernel route (#1 and #2's training form), then the
# plain route (every kernel off, the FFN unfused: the JAX default)
PATCH_TRAIN_ARGS = [a if a != "CRU" else "PatchTST" for a in TRAIN_ARGS]
PATCH_ROUTES = {"kernel": ["--use_pallas", "true", "--use_fused_ffn", "true"],
                "plain": ["--use_pallas", "false"]}
PATCH_STEP_B = 64  # the compared step's batch: the FFN at M = 64 x 8 x 16 = 8192
# phase 9: Informer, the preset (e_layers 2 with distil, d_layers 1, factor
# 3) at the full widths of the first cell (d_model 512, d_ff 2048, 2 heads)
# behind TTF_RecAvg + MMF_GR_Add, EPA-Air 48 + 24 steps: #2 at three FFN
# sites a forward (M = 64 x 48, then 64 x 25 after the distilling conv, and
# the decoder's 64 x 24 at a full dispatch), #1 once
INFORMER_CFG = dict(SERVE_CFG, model="Informer", **MODEL_PRESETS["Informer"])
N_INFORMER_REQUESTS = 512
INFORMER_TRAIN_ARGS = [a if a != "CRU" else "Informer" for a in TRAIN_ARGS]
# the config's default fusion pair (TTF_T2V_XAttn + MMF_XAttn_Add) behind
# DLinear: no kernel runs on this path
DEFAULT_PAIR = {"TTF_RecAvg": "TTF_T2V_XAttn", "MMF_GR_Add": "MMF_XAttn_Add", "CRU": "DLinear"}
DEFAULT_PAIR_CFG = dict(SERVE_CFG, model="DLinear", TTF_module="TTF_T2V_XAttn",
                        MMF_module="MMF_XAttn_Add")
DEFAULT_PAIR_TRAIN_ARGS = [DEFAULT_PAIR.get(a, a) for a in TRAIN_ARGS]
N_DEFAULT_PAIR_REQUESTS = 256
# phase 10: TimeLLM, the preset (d_model 32, d_ff 128, patches of 16, 6 GPT-2
# blocks 768 wide, ts_vocab_size 1000) behind TTF_RecAvg + MMF_GR_Add (d_txt
# 768), EPA-Air 48 + 24 steps, on the attention kernel's route: #3 in each of
# GPT-2's 6 blocks, [B, 12, 36 + 6 x 8, 64] on the fast prompt and [B, 12,
# 128 + 48, 64] on the exact one; #1 once
TIMELLM_CFG = dict(SERVE_CFG, model="TimeLLM", use_fused_attn=True, **MODEL_PRESETS["TimeLLM"])
N_TIMELLM_REQUESTS = 256
TIMELLM_TRAIN_ARGS = [a if a != "CRU" else "TimeLLM" for a in TRAIN_ARGS]
ATTN_ROUTES = {"kernel": ["--use_pallas", "true", "--use_fused_attn", "true"],
               "plain": ["--use_pallas", "false"]}
EXACT_PROMPT = ["--timellm_exact_prompt", "true"]
# the windows TimeLLM trains on (phase 7's fixture, T = 36 + 36) and the
# compared step's batch: #3 at [32, 12, 68, 64] and [32, 12, 160, 64]
TIMELLM_TRAINED = dict(input_len=36, pred_len=36)
TIMELLM_STEP_B = 32
# PatchTST + TTF_RecAvg + MMF_GR_Add on raw-text notes (phase 8's run, the
# notes through the 6-block GPT-2 in the loader stage): the attention
# kernel's route against the plain attention, everything else alike
RAW_TEXT_TRAIN_ARGS = PATCH_TRAIN_ARGS + ["--use_text_embeddings", "false"]
RAW_TEXT_ROUTES = {"kernel": ["--use_pallas", "true", "--use_fused_attn", "true"],
                   "plain attention": ["--use_pallas", "true", "--use_fused_attn", "false"]}
RAW_TEXT_LOSS_RTOL = 1e-4  # the first epoch's losses, notes embedded by either attention
# phase 11: TimesNet, TimeMixer and TTM, each its preset (config.py:372-397:
# TimesNet d_model 16, d_ff 32, top_k 5, 2 blocks; TimeMixer d_model 16, d_ff
# 32, 3 avg downsamplings by 2, 2 blocks; TTM d_model 1024, 3 adaptive-patch
# levels of 3 layers, a 2-layer decoder 64 wide, patches of history // 4)
# behind TTF_RecAvg + MMF_GR_Add (d_txt 768), EPA-Air 48 + 24 steps served
# and 36 + 36 trained; #1 once a forward and nothing else
MTS_MODELS = ("TimesNet", "TimeMixer", "TTM")
N_MTS_REQUESTS = 256
MTS_TRAIN_ARGS = {m: [a if a != "CRU" else m for a in TRAIN_ARGS] + ["--use_pallas", "true"]
                  for m in MTS_MODELS}
MTS_STEP_B = 32
# phases 7-13 train on the streaming loop, as PRs 7-14 did; phase 14 on the
# default one, the device-resident epoch loop
STREAM = ["--device_loop", "false"]
LOOP_EPOCHS = 3  # phase 14: epoch 0 warms up and captures, 1 is traced, 2 is timed
LOOP_RTOL = 1e-5  # phase 14: per-step losses and test metrics, epoch loop vs streaming
# phase 11d resumes phase 8's kernel route as experiment "resume": one epoch,
# then --load resume --epoch 2, held to phase 8's two epochs bit for bit
RESUME_ARGS = PATCH_TRAIN_ARGS + PATCH_ROUTES["kernel"] + ["--load", "resume"]
RESUME_RTOL = 1e-6  # only where an op with atomics (named by the run) breaks bitwise equality
# phase 12: the IMTS backbones, each its preset (config.py:407-432: LatentODE
# rec / units / gru 32; NeuralFlow coupling, 2 flow layers, hidden 3 x 32, rec
# 40, latents 20; tPatchGNN hid 32, te 10, node 10, 1 head, 1 layer) behind
# TTF_RecAvg + MMF_GR_Add (d_txt 768). The LatentODE is served a request a
# dispatch (its union time axis), so it takes fewer requests
IMTS_MODELS = ("LatentODE", "NeuralFlow", "tPatchGNN")
N_IMTS_REQUESTS = {"LatentODE": 64, "NeuralFlow": 256, "tPatchGNN": 256}
# tPatchGNN's served and compared patching: the preset's 24 (days here) spans
# EPA-Air's whole 7-day history in one patch; patches of 2 days give 4, each
# holding points. The trained run keeps the reference's own derivation
SERVED_PATCHING = dict(patch_size=2, patch_stride=2, npatch=4)
IMTS_TRAIN_ARGS = {m: [a if a != "CRU" else m for a in TRAIN_ARGS] + ["--use_pallas", "true"]
                   for m in IMTS_MODELS}
# the LatentODE trains on 4 of the fixture's 8 entities: its scan runs every
# union time step on the host (~8 s a step at 768 union times on the H100),
# and half the windows halve phases 12b and 12d; a batch keeps 32 windows
# and its union axes their 768 times
IMTS_TRAIN_ARGS["LatentODE"] += ["--rec_ids"] + [f"entity{i:03d}" for i in range(4)]
IMTS_STEP_B = 32
# phase 12e holds the LatentODE's float32 forward over a union axis of the
# trained length (768 times) to its float64 run: within 4x the JAX package's
# own distance plus 1e-6, JAX's distance being the one tools/torch_ode_drift.py
# prints on the CPU for the same batch and weights (ode_drift_case)
ODE_DRIFT_JAX = 1.220954874703306e-07
ODE_DRIFT_MAX = 4 * ODE_DRIFT_JAX + 1e-6
# phase 12d resumes the LatentODE run of phase 12b as experiment "resume"
ODE_RESUME_ARGS = IMTS_TRAIN_ARGS["LatentODE"] + ["--load", "resume"] + STREAM
# phase 13: BERT, Llama-3.1-8B and DeepSeek-7B as frozen LLMs at full width
# and the config's depth (6 layers), random weights from seeds
LLM_ALIASES = ("BERT", "Llama", "DeepSeek")
N_LLM_REQUESTS = 64
LLM_BF16_RTOL = 0.05  # bfloat16 notes within 0.05 x scale of float32 (tests/test_llm_stack.py:128)
# 13a's drift case: one bucket call of 16 notes (1-64 tokens) through each LLM
# at full width and 2 layers (vocab cut to 1024: only the lookup reads it),
# float32 against float64 on the card, within 4 x the JAX package's own
# distance on the CPU plus 1e-6 (`JAX_PLATFORMS=cpu python
# tools/torch_llm_drift.py` prints each `jax_from_float64`)
LLM_DRIFT_LAYERS, LLM_DRIFT_VOCAB, LLM_DRIFT_ROWS, LLM_DRIFT_TOKENS = 2, 1024, 16, 64
LLM_DRIFT_JAX = {"BERT": 1.3658808308683601e-05, "Llama": 2.8013404822502253e-06,
                 "DeepSeek": 3.0309202581069172e-06}
LLM_DRIFT_MAX = {alias: 4 * d + 1e-6 for alias, d in LLM_DRIFT_JAX.items()}
# 13b: an embed_notes bucket call at the token budget (rows, tokens), and a
# short-note call through the full-depth model
LLM_BUCKET_CALL, LLM_SHORT_CALL = (64, 1024), (64, 32)
# 13c trains phase 8's kernel route on the stage's 6-layer Llama notes
STAGE_TRAIN_ARGS = ([a if a != "GPT2" else "Llama" for a in PATCH_TRAIN_ARGS]
                    + PATCH_ROUTES["kernel"])
# 13d: each TimeLLM checkpoint holds its frozen LLM (the 6-layer Llama 7.4 GB)
TIMELLM_LLM_EPOCHS = {"BERT": 2, "LLAMA": 1}


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
def recavg_inputs(B, N, T, d, gen, device, empty_sample=False, offset=0):
    """offset: V is a contiguous view that many floats into its storage
    (1: 4 bytes off 16-byte alignment)."""
    tau = torch.rand((B, N), generator=gen, device=device) * 7.0   # raw note days
    t_hat = 0.5 + 0.5 * torch.rand((B, T), generator=gen, device=device)
    V = torch.randn((B * N * d + offset,), generator=gen, device=device)[offset:].view(B, N, d)
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


def attn_inputs(B, H, T, D, gen, device, lo=None):
    """q, k, v ~ N(0, 1) [B, H, T, D] and a right-padded pad [B, T]: each
    sample's length uniform in [lo, T], as embed_notes' buckets give them
    (lo=None: no padding)."""
    q, k, v = (torch.randn((B, H, T, D), generator=gen, device=device) for _ in range(3))
    pad = torch.ones((B, T), device=device)
    if lo is not None:
        n = torch.randint(lo, T + 1, (B,), generator=gen, device=device)
        pad = (torch.arange(T, device=device)[None] < n[:, None]).float()
    return [q, k, v, pad]


def bucket_lo(T: int) -> int:
    """The shortest note in embed_notes' length bucket T (32 is the first)."""
    return 1 if T <= 32 else T // 2 + 1


def bucket_rows(T: int, token_batch: int = 64, token_budget: int = 32768) -> int:
    """Rows of one embed_notes call at bucket T and its default budget."""
    rows = max(token_batch, token_budget // T)
    return 1 << (rows - 1).bit_length()


def attn_ragged_inputs(gen, device):
    """[3, 2, 13, 64]: token 0 padded in sample 0 (its row 0 sees no key),
    every token padded in sample 1, sample 2 right-padded at 9."""
    q, k, v, pad = attn_inputs(3, 2, 13, 64, gen, device)
    pad[0, 0] = 0.0
    pad[1] = 0.0
    pad[2, 9:] = 0.0
    return [q, k, v, pad]


def attn_work(pad, H, D) -> tuple[int, int]:
    """(bytes, FLOPs) one attention call needs on these inputs. Only the
    keys up to each sample's last real token are needed (the kernel skips
    the rest): q and pad read once, k and v read once up to that token,
    out written once; QK^T and PV over the keys each row keeps (causal,
    up to that token)."""
    B, T = pad.shape
    idx = torch.arange(1, T + 1, device=pad.device)
    kv_len = ((pad > 0) * idx).amax(dim=1)  # one past the last real token
    kept = torch.minimum(idx[None], kv_len[:, None]).sum()
    kv_rows = int(kv_len.sum())
    return 4 * (2 * B * H * T * D + 2 * H * D * kv_rows + B * T), 4 * H * D * int(kept)


def attn_grads(args, g, kernel: bool) -> list:
    """dq, dk, dv of sum(out * g): through fused_causal_attention (the
    kernel's forward and its hand backward) or autograd of the plain
    forward."""
    q, k, v, pad = args
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    fn = attn.fused_causal_attention if kernel else attn.attention_reference
    fn(*leaves, pad).backward(g)
    return [t.grad for t in leaves]


def check_attn_backward(args, g) -> tuple[dict, list]:
    """#3's backward against autograd of the plain forward, to ATTN_TOL:
    ({"dq", "dk", "dv": max |err|}, the kernel route's gradients)."""
    got, want = attn_grads(args, g, True), attn_grads(args, g, False)
    return {n: max_err(a, b, ATTN_TOL) for n, a, b in zip(("dq", "dk", "dv"), got, want)}, got


def attn_backward_work(pad, H, D) -> tuple[int, int]:
    """(bytes, FLOPs) of #3's backward: q, k, v, g and pad read once, dq,
    dk and dv written once; five products over the kept (query, key) pairs
    (the probabilities recomputed, dV, dP, dQ, dK) against the forward's
    two."""
    B, T = pad.shape
    _, fwd_flops = attn_work(pad, H, D)
    return 4 * (7 * B * H * T * D + B * T), fwd_flops * 5 // 2


def expm_inputs(B, n, norm, gen, device):
    """[B, n, n] Gaussian matrices scaled to inf-norm `norm` each."""
    M = torch.randn((B, n, n), generator=gen, device=device)
    return M / M.abs().sum(-1).amax(-1)[:, None, None] * norm


def expm_tiers(M, max_squarings: int = MAX_SQUARINGS):
    """Per matrix of M [..., n, n]: (Taylor-4?, squarings k, products the
    kernel runs: 2 for Taylor-4, 5 + k for Taylor-12), as csrc/expm.cuh
    chooses them."""
    norm = M.abs().sum(-1).amax(-1)
    k = torch.ceil(torch.log2(norm.clamp(min=1.0))).clamp(max=max_squarings)
    t4 = norm <= 1.0 / 32.0
    return t4, torch.where(t4, 0.0, k), torch.where(t4, 2.0, 5.0 + k)


def tier_shares(M) -> dict:
    t4, k, _ = expm_tiers(M)
    n = t4.numel()
    return {"taylor4": int(t4.sum()) / n, "taylor12": int((~t4 & (k == 0)).sum()) / n,
            "taylor12_squared": int((k > 0).sum()) / n,
            "mean_squarings_when_squared": float(k[k > 0].mean()) if bool((k > 0).any()) else 0.0}


def expm_tri_inputs(B, n, norm, gen, device):
    """expm_inputs with the lower-left 32 x 32 block zeroed: block upper
    triangular matrices, which #5 takes in its triangular form."""
    M = torch.randn((B, n, n), generator=gen, device=device)
    M[:, 32:, :32] = 0.0
    return M / M.abs().sum(-1).amax(-1)[:, None, None] * norm


def expm_work(M) -> tuple[int, int]:
    """(bytes, FLOPs) one batched_expm call needs on M [B, n, n]: M read
    and exp(M) written once; each matrix's products at n^3 FLOPs where it
    takes the block-triangular form (expm.takes_triangular: three of the
    four (n/2)^3 block products are nonzero, as scan_work counts the Van
    Loan blocks), 2n^3 otherwise."""
    B, n, _ = M.shape
    per_product = torch.where(expm.takes_triangular(M), n ** 3, 2 * n ** 3)
    return 8 * B * n * n, int((expm_tiers(M)[2] * per_product).sum())


def expm_rel_err(got, want) -> float:
    """Max over matrices of max|got - want| / max|want|; raises above
    EXPM_RTOL or on a non-finite value."""
    err = (got - want).abs().amax(dim=(1, 2)) / want.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    worst = float(err.max())
    if worst > EXPM_RTOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"expm: relative error {worst:.3e} > {EXPM_RTOL} "
                             f"(finite={bool(torch.isfinite(got).all())})")
    return worst


def scan_inputs(B, T, lod, K, gen, device) -> dict:
    """CRU scan inputs as cru_collate and the encoder give them: each
    sample has 1..T real steps at sorted times in [0, 14) days, its tail
    repeat-padded (dt = 0, invalid), 30 % of its real steps invalid, the
    final dt 1; bases N(0, BASIS_STD^2). Few real steps mean long dt: the
    Van Loan blocks then reach the squaring tier."""
    lsd = 2 * lod
    u = lambda *s: torch.rand(s, generator=gen, device=device)
    n_real = torch.randint(1, T + 1, (B,), generator=gen, device=device)
    step = torch.arange(T, device=device)[None]
    tp = torch.sort(u(B, T) * 14.0, dim=1).values
    real = step < n_real[:, None]
    last = tp.gather(1, (n_real - 1)[:, None])
    tp = torch.where(real, tp, last)
    dts = torch.cat([tp[:, 1:] - tp[:, :-1], torch.ones((B, 1), device=device)], dim=1)
    return dict(
        y_mean=torch.randn((B, T, lod), generator=gen, device=device),
        y_var=0.1 + u(B, T, lod), valid=((u(B, T) > 0.3) & real).float(), dts=dts,
        coeff_w=torch.randn((lsd, K), generator=gen, device=device) * 0.3,
        coeff_b=torch.randn((K,), generator=gen, device=device) * 0.1,
        dense_basis=torch.randn((4, K, lod, lod), generator=gen, device=device) * BASIS_STD,
        trans_var=0.05 + u(lsd) * 0.1, init_cu=1.0 + u(lod), init_cl=1.0 + u(lod))


def check_scan(got, ins) -> dict:
    """Hold fused_cru_scan's (post_means, residuals) `got` on `ins` to its
    plain version. The scan's state grows over its steps, and its float32
    rounding alone passes SCAN_TOL: on the card the plain version in
    float32 strays from its own float64 run by 1.25x SCAN_TOL on
    scan_inputs' data, by 1.03x on a served dispatch's (PERF.md). So each
    output is held to the plain version run in float64: the kernel's
    score there (max |err| / (atol + rtol|ref|)) must be at most
    SCAN_SCORE_MAX. Returns, by output, max |kernel - float32 plain| and
    the kernel's and the float32 plain version's scores; raises
    otherwise."""
    want = cru_ops.cru_scan_reference(**ins, max_squarings=MAX_SQUARINGS)
    ref = cru_ops.cru_scan_reference(**{k: v.double() for k, v in ins.items()},
                                     max_squarings=MAX_SQUARINGS)
    atol, rtol = SCAN_TOL
    score = lambda x, r: float(((x.double() - r).abs() / (atol + rtol * r.abs())).max())
    out = {}
    for name, g, w, r in zip(("post_means", "pm", "pcu", "pcl", "pcs"), (got[0], *got[1]),
                             (want[0], *want[1]), (ref[0], *ref[1])):
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"fused_cru_scan {name}: shape {tuple(g.shape)} or non-finite")
        kernel, plain = score(g, r), score(w, r)
        if kernel > SCAN_SCORE_MAX:
            raise AssertionError(f"fused_cru_scan {name}: score {kernel:.3f} > {SCAN_SCORE_MAX} "
                                 f"against the float64 plain run (float32 plain {plain:.3f})")
        out[name] = {"max_abs_err": float((g - w).abs().max()), "score": kernel,
                     "plain_score": plain}
    return out


def frechet_inputs(B, n, norm, gen, device):
    """(M, E): M as expm_inputs gives it, E ~ N(0, 1) [B, n, n]."""
    return expm_inputs(B, n, norm, gen, device), torch.randn((B, n, n), generator=gen,
                                                             device=device)


def frechet_rel_err(got, want) -> float:
    """Max over matrices of max|got - want| / max|want|; raises above
    FRECHET_RTOL or on a non-finite value."""
    err = (got - want).abs().amax(dim=(1, 2)) / want.abs().amax(dim=(1, 2)).clamp(min=1e-30)
    worst = float(err.max())
    if worst > FRECHET_RTOL or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"expm_frechet: relative error {worst:.3e} > {FRECHET_RTOL} "
                             f"(finite={bool(torch.isfinite(got).all())})")
    return worst


def frechet_work(M) -> tuple[int, int]:
    """(bytes, FLOPs) one batched_expm_frechet call needs on M [B, n, n]:
    M and E read and L written once; each matrix's 3 (5 + k) products at
    2n^3 FLOPs (k from M's own norm, as csrc/frechet.cuh chooses it)."""
    B, n, _ = M.shape
    norm = M.abs().sum(-1).amax(-1)
    k = torch.ceil(torch.log2(norm.clamp(min=1.0))).clamp(max=MAX_SQUARINGS)
    return 12 * B * n * n, int((3 * (5 + k)).sum()) * 2 * n ** 3


SCAN_BWD_NAMES = ("gy", "gyv", "gW", "gb", "gA", "gq", "gicu", "gicl")


def scan_bwd_case(ins: dict, gen):
    """The forward's residuals on `ins` and a cotangent g ~ N(0, 1) of the
    post-means: the backward's inputs beside `ins`."""
    out, residuals = cru_scan.fused_cru_scan(**ins, max_squarings=MAX_SQUARINGS)
    return residuals, torch.randn(out.shape, generator=gen, device=out.device)


def check_scan_bwd(got, ins, residuals, g) -> dict:
    """Hold fused_cru_scan_backward's cotangents `got` on (ins, residuals,
    g) to its plain version run in float64 on the same residuals, as
    check_scan holds the forward: each tensor's score max |err| / (atol +
    rtol|ref|) must be at most SCAN_BWD_SCORE_MAX (plus SCAN_BWD_ICOV_FACTOR
    times the float32 plain version's score for the initial covariances),
    with (atol, rtol) = SCAN_BWD_TOL and atol taken relative to the
    tensor's largest entry: the adjoint grows over the steps, and a
    tensor's float32 rounding scales with its largest entry. Returns, by cotangent, max |kernel -
    float32 plain| and both scores."""
    want = cru_ops.cru_scan_bwd_reference(**ins, residuals=residuals, g=g,
                                          max_squarings=MAX_SQUARINGS)
    ref = cru_ops.cru_scan_bwd_reference(
        **{k: v.double() for k, v in ins.items()}, residuals=[r.double() for r in residuals],
        g=g.double(), max_squarings=MAX_SQUARINGS)
    atol, rtol = SCAN_BWD_TOL

    def score(x, r):  # an exact zero against a zero reference scores 0
        err = (x.double() - r).abs()
        den = atol * r.abs().max() + rtol * r.abs()
        return float(torch.where(err > 0, err / den, torch.zeros_like(err)).max())

    out, bad = {}, []
    for name, x, w, r in zip(SCAN_BWD_NAMES, got, want, ref):
        if x.shape != w.shape or not bool(torch.isfinite(x).all()):
            raise AssertionError(f"fused_cru_scan_backward {name}: shape {tuple(x.shape)} "
                                 "or non-finite")
        kernel, plain = score(x, r), score(w, r)
        limit = SCAN_BWD_SCORE_MAX
        if name in ("gicu", "gicl"):
            limit += SCAN_BWD_ICOV_FACTOR * plain
        if not kernel <= limit:
            bad.append(f"{name} {kernel:.3f} > {limit:.3f}")
        out[name] = {"max_abs_err": float((x - w).abs().max()), "score": kernel,
                     "plain_score": plain, "max_abs_ref": float(r.abs().max())}
    if bad:
        raise AssertionError(f"fused_cru_scan_backward scores against the float64 plain run: "
                             f"{bad}; all: {json.dumps(out)}")
    return out


def van_loan_blocks(ins: dict) -> list:
    """The Van Loan block Bm of every step of the scan over `ins` (the
    default route's loop with the plain expm), [B, 2lsd, 2lsd] each."""
    blocks = []

    def record(M, max_squarings):
        blocks.append(M)
        return expm_taylor12(M, max_squarings)

    cru_ops._scan_steps(**ins, max_squarings=MAX_SQUARINGS, expm_fn=record)
    return blocks


def scan_work(ins: dict, blocks) -> tuple[int, int]:
    """(bytes, FLOPs) one fused_cru_scan call needs: its inputs read and
    post-means and residuals written once; per step the expm's products
    (by each block's own tier), the Bm assembly (K FMAs on the lsd^2
    entries of A; -A^T is the same sum), the coefficient net, E_A post_m
    and the three covariance diagonals (3 lod dot products of lsd terms,
    3 FLOPs a term for Cm). The Van Loan block [[A, Q], [0, -A^T]] is
    block upper triangular, and so are its powers: a product of two is
    four (n/2)^3 block products, n^3 FLOPs."""
    B, T, lod = ins["y_mean"].shape
    lsd, K = 2 * lod, ins["coeff_w"].shape[1]
    n = 2 * lsd
    nbytes = 4 * (B * T * (2 * lod + 2) + lsd * K + K + 4 * K * lod * lod + lsd + 2 * lod
                  + B * T * (2 * lsd + 3 * lod))
    products = sum(int(expm_tiers(M)[2].sum()) for M in blocks)
    per_step = 2 * K * lsd * lsd + 2 * lsd * K + 2 * lsd * lsd + 3 * lod * lsd * 5 + 15 * lod
    return nbytes, products * n ** 3 + B * T * per_step


# ---------------------------------------------------------------- phase 3
def check_kernels(device, shapes, gen) -> dict:
    """Each kernel against its plain version; returns max errors by case."""
    errs = {}
    for case, (B, N, T, d), empty, offset in (
            ("recavg serving", shapes["recavg"], False, 0),
            ("recavg ragged", (3, 5, 7, 300), True, 0),
            ("recavg training", shapes["recavg_train"], False, 0),
            ("recavg unaligned", shapes["recavg"], False, 1),  # V 4 bytes off 16-byte alignment
            ("recavg d 1024", (64, 8, 24, 1024), False, 0),
            ("recavg d 4k+3", (64, 8, 24, 767), True, 0),
            ("recavg no notes", (8, 0, 24, 768), False, 0),
            ("recavg 70 notes", (4, 70, 24, 768), True, 0)):
        args = recavg_inputs(B, N, T, d, gen, device, empty_sample=empty, offset=offset)
        got = recavg.recency_weighted_average(*args)
        want = recavg.recavg_reference(*args)
        errs[case] = max_err(got, want, RECAVG_TOL)
        if empty:
            assert bool((got[-1] == 0).all()), "a sample without notes must give E = 0"
        if N == 0:
            assert bool((got == 0).all()), "N = 0 must give E = 0"
        log(f"# check {case} {tuple(args[2].shape)} T={T} (V at byte "
            f"{args[2].data_ptr() % 16} of 16): max|err| {errs[case]:.3e}")

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
    # the training form (out, a1 and r) with dropout, on a draw of its own so
    # the checks after it keep theirs
    args = ffn_inputs(M, D, F, torch.Generator(device=device).manual_seed(SEED + 5), device)
    got = ffn._forward(*args, KEEP, "gelu", True, with_residuals=True)
    want = ffn.ffn_forward_reference(*args, KEEP, "gelu", True, with_residuals=True)
    errs["ffn training form"] = {name: max_err(g, w, FFN_TOL)
                                 for name, g, w in zip(("out", "a1", "r"), got, want)}
    log(f"# check ffn training form M={M} D={D} F={F} gelu dropout=True: max|err| "
        f"{json.dumps(errs['ffn training form'])}")
    # the end buckets and the ragged case draw from gen as they always did, the
    # buckets between them from a generator of their own: so every later check
    # sees the draws its limit was set on (PERF.md)
    ends, middle = (shapes["attn"][0], shapes["attn"][-1]), shapes["attn"][1:-1]
    gen_mid = torch.Generator(device=device).manual_seed(SEED + 1)
    for case, shape, g in ([(f"attn bucket-{x[2]}", x, gen) for x in ends]
                           + [("attn ragged", None, gen)]
                           + [(f"attn bucket-{x[2]}", x, gen_mid) for x in middle]):
        args = (attn_inputs(*shape, g, device, bucket_lo(shape[2])) if shape
                else attn_ragged_inputs(g, device))
        got = attn.fused_causal_attention(*args)
        want = attn.attention_reference(*args)
        errs[case] = max_err(got, want, ATTN_TOL)
        if shape is None:
            assert bool((got[0, :, 0] == 0).all()), "a row with no kept key must give 0"
            assert bool((got[1] == 0).all()), "a sample without tokens must give 0"
        log(f"# check {case} {tuple(args[0].shape)}: max|err| {errs[case]:.3e}")
    # #3's backward (the plain hand backward behind the kernel's forward) at
    # TimeLLM's two shapes (no pad: GPT-2 gets no mask there) and the ragged
    # case, against autograd of the plain forward (a generator of its own)
    gen_b = torch.Generator(device=device).manual_seed(SEED + 11)
    for shape in (*shapes.get("attn_timellm", ()), None):
        case = f"attn backward {list(shape)}" if shape else "attn backward ragged"
        args = attn_inputs(*shape, gen_b, device) if shape else attn_ragged_inputs(gen_b, device)
        g = torch.randn(args[0].shape, generator=gen_b, device=device)
        if shape:
            errs[f"attn {list(shape)}"] = max_err(attn.fused_causal_attention(*args),
                                                  attn.attention_reference(*args), ATTN_TOL)
        calls = attn.backward_calls
        errs[case], (dq, dk, dv) = check_attn_backward(args, g)
        if attn.backward_calls != calls + 1:
            raise AssertionError(f"{case}: the backward ran {attn.backward_calls - calls} times")
        if shape is None:
            assert all(bool((d[0, :, 0] == 0).all()) for d in (dq, dk, dv)), \
                "a row or key with nothing kept must give exact zeros"
            assert all(bool((d[1] == 0).all()) for d in (dq, dk, dv)), \
                "a sample without tokens must give exact zeros"
        log(f"# check {case} {tuple(args[0].shape)}, g ~ N(0, 1): max|err| "
            f"{json.dumps(errs[case])}")
    salts = ffn_inputs(8, 8, 8, gen, device)[-1]
    for site in ("output", "hidden"):
        args, expect = dropout_probe_inputs(M, D, F, site, salts, device)
        # a row that dropped nothing is constant: its sign says nothing
        rows = ~expect.all(dim=1)
        got = (ffn.fused_encoder_ffn(*args, KEEP, "relu", True) > 0)[rows]
        want = (ffn.ffn_reference(*args, KEEP, "relu", True) > 0)[rows]
        # the training form: its out, and r = drop_b(...) itself (x = 0)
        train_out, _, train_r = ffn._forward(*args, KEEP, "relu", True, with_residuals=True)
        forms = {"kernel": got, "plain": want, "kernel training form": (train_out > 0)[rows],
                 "kernel training form r": (train_r > 0)[rows]}
        expect = expect[rows]
        wrong = {k: int((v != expect).sum()) for k, v in forms.items()}
        if any(wrong.values()):
            raise AssertionError(f"dropout zero pattern at the {site} site differs: {wrong} "
                                 f"of {expect.numel()} elements")
        log(f"# check ffn {site}-site dropout zeros, eval and training forms: identical to the "
            f"hash bits ({int((~expect).sum())} dropped of {expect.numel()})")

    B, n = shapes["expm"]
    for case, M in ([(f"expm norm {norm}", expm_inputs(B, n, norm, gen, device))
                     for norm in (0.01, 0.5, 6.0, 80.0)]
                    + [("expm ragged", expm_inputs(3, 24, 3.0, gen, device)),
                       ("expm zeros", torch.zeros((B, n, n), device=device))]):
        got = expm.batched_expm(M, MAX_SQUARINGS)
        want = expm_taylor12(M, MAX_SQUARINGS)
        errs[case] = expm_rel_err(got, want)
        if case == "expm zeros":
            eye = torch.eye(n, device=device).expand(B, n, n)
            assert torch.equal(got, eye), "exp(0) must be exactly I (the CRU's pad steps)"
        log(f"# check {case} {tuple(M.shape)}: tiers {tier_shares(M)}, "
            f"max|err|/max|ref| {errs[case]:.3e}")
    # each form (dense, block triangular, one nonzero lower-left entry: the
    # dense form), at one and at the most squarings (draws of their own, so
    # the checks after these keep theirs)
    gen_x = torch.Generator(device=device).manual_seed(SEED + 3)
    for norm in (0.5, 80.0):
        for form, make in (("dense", expm_inputs), ("triangular", expm_tri_inputs),
                           ("one lower entry", expm_tri_inputs)):
            case = f"expm {form} norm {norm}"
            M = make(B, n, norm, gen_x, device)
            if form == "one lower entry":
                M[:, 40, 7] = norm / 8
            want_tri = form == "triangular"
            if bool((expm.takes_triangular(M) != want_tri).any()):
                raise AssertionError(f"{case}: takes_triangular is not {want_tri}")
            errs[case] = expm_rel_err(expm.batched_expm(M, MAX_SQUARINGS),
                                      expm_taylor12(M, MAX_SQUARINGS))
            log(f"# check {case} {tuple(M.shape)}: max|err|/max|ref| {errs[case]:.3e}")

    Bs, T, lod, K = shapes["cru_scan"]
    ins = scan_inputs(Bs, T, lod, K, gen, device)
    scan = check_scan(cru_scan.fused_cru_scan(**ins, max_squarings=MAX_SQUARINGS), ins)
    errs["cru_scan"] = max(v["max_abs_err"] for v in scan.values())
    blocks = torch.cat(van_loan_blocks(ins))
    log(f"# check cru_scan B={Bs} T={T} lod={lod} K={K} (repeat-padded tails, "
        f"invalid steps; Van Loan tiers {tier_shares(blocks)}, triangular "
        f"{float(expm.takes_triangular(blocks).float().mean())}): {json.dumps(scan)}")
    # lsd 24: unpermuted, its -A^T block would cross row 32 (a draw of its own)
    gen_s = torch.Generator(device=device).manual_seed(SEED + 4)
    ins = scan_inputs(Bs, T, 12, K, gen_s, device)
    scan = check_scan(cru_scan.fused_cru_scan(**ins, max_squarings=MAX_SQUARINGS), ins)
    errs["cru_scan lod 12"] = max(v["max_abs_err"] for v in scan.values())
    log(f"# check cru_scan B={Bs} T={T} lod=12 K={K}: "
        f"{ {k: round(v['score'], 3) for k, v in scan.items()} }")

    B, n = shapes["frechet"]
    zero_point = torch.zeros((B, n, n), device=device)
    for case, (M, E) in ([(f"frechet norm {norm}", frechet_inputs(B, n, norm, gen, device))
                          for norm in (0.01, 0.5, 6.0, 80.0)]
                         + [("frechet ragged", frechet_inputs(3, 24, 3.0, gen, device)),
                            ("frechet at zero", (zero_point, frechet_inputs(B, n, 1.0, gen,
                                                                            device)[1]))]):
        got = expm.batched_expm_frechet(M, E, MAX_SQUARINGS)
        errs[case] = frechet_rel_err(got, expm_frechet_taylor12(M, E, MAX_SQUARINGS))
        if case == "frechet at zero":
            assert torch.equal(got, E), "L_exp(0)[E] must be exactly E (the CRU's pad steps)"
        log(f"# check {case} {tuple(M.shape)}: max|err|/max|ref| {errs[case]:.3e}")
    # each cluster size the wrapper may pick, at the most squarings (draws of
    # their own, so the checks after these keep theirs)
    gen_c = torch.Generator(device=device).manual_seed(SEED + 2)
    for C in CLUSTER_SIZES:
        case = f"frechet cluster {C}"
        M, E = frechet_inputs(B, n, 80.0, gen_c, device)
        errs[case] = frechet_rel_err(expm.batched_expm_frechet(M, E, MAX_SQUARINGS, cluster=C),
                                     expm_frechet_taylor12(M, E, MAX_SQUARINGS))
        log(f"# check {case} {tuple(M.shape)} norm 80: max|err|/max|ref| {errs[case]:.3e}")

    Bs, T, lod, K = shapes["cru_scan_bwd"]
    errs["cru_scan_bwd"] = 0.0
    for draw in range(3):
        ins = scan_inputs(Bs, T, lod, K, gen, device)
        residuals, g = scan_bwd_case(ins, gen)
        got = cru_scan.fused_cru_scan_backward(**ins, residuals=residuals, g=g,
                                               max_squarings=MAX_SQUARINGS)
        bwd = check_scan_bwd(got, ins, residuals, g)
        errs["cru_scan_bwd"] = max([errs["cru_scan_bwd"]] + [v["max_abs_err"]
                                                              for v in bwd.values()])
        log(f"# check cru_scan_bwd B={Bs} T={T} lod={lod} K={K} draw {draw} against float64, "
            f"g ~ N(0, 1): {json.dumps(bwd)}")

    # #2 at Informer's three FFN sites (phase 9), eval form and training form
    # with dropout (a generator of its own: the checks above keep their draws)
    gen_i = torch.Generator(device=device).manual_seed(SEED + 9)
    for m, D, F in shapes.get("ffn_informer", ()):
        args = ffn_inputs(m, D, F, gen_i, device)
        errs[f"ffn informer M {m}"] = max_err(ffn.fused_encoder_ffn(*args, KEEP, "gelu", False),
                                              ffn.ffn_reference(*args, KEEP, "gelu", False),
                                              FFN_TOL)
        got = ffn._forward(*args, KEEP, "gelu", True, with_residuals=True)
        want = ffn.ffn_forward_reference(*args, KEEP, "gelu", True, with_residuals=True)
        errs[f"ffn informer M {m} training form"] = {
            name: max_err(g, w, FFN_TOL) for name, g, w in zip(("out", "a1", "r"), got, want)}
        log(f"# check ffn at Informer's M={m} D={D} F={F} gelu: eval form max|err| "
            f"{errs[f'ffn informer M {m}']:.3e}, training form with dropout "
            f"{json.dumps(errs[f'ffn informer M {m} training form'])}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    return errs


# ---------------------------------------------------------------- phase 4
def seeded_weights(module, gen) -> None:
    """Fill every parameter from `gen`: Linear and Conv1d at torch's init
    scale, LayerNorm (and CRU's raw LayerNorm tensors) near identity, the
    distilling BatchNorm near identity with running statistics away from 0
    and 1 (so eval reads them), TTF_T2V_XAttn's query N(0, 1), GRU tensors
    U(+/-1/sqrt(H)), sigma near 1, CRU's banded bases N(0, BASIS_STD^2)
    (at their zero init every Van Loan block would be tiny and nilpotent,
    and only the Taylor-4 tier would run)."""
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
            elif isinstance(m, nn.Embedding):  # TimeLLM's frozen GPT-2 tables
                m.weight.copy_(torch.randn(m.weight.shape, generator=gen)
                               / math.sqrt(m.embedding_dim))
            elif isinstance(m, nn.Conv1d):
                b = 1.0 / math.sqrt(m.in_channels * m.kernel_size[0])
                m.weight.copy_((torch.rand(m.weight.shape, generator=gen) * 2 - 1) * b)
                if m.bias is not None:
                    m.bias.copy_((torch.rand(m.bias.shape, generator=gen) * 2 - 1) * b)
            elif isinstance(m, BatchNorm):
                n = m.weight.shape
                m.weight.copy_(1 + 0.1 * torch.randn(n, generator=gen))
                m.bias.copy_(0.1 * torch.randn(n, generator=gen))
                m.running_mean.copy_(0.3 * torch.randn(n, generator=gen))
                m.running_var.copy_(0.5 + torch.rand(n, generator=gen))
        for name, p in module.named_parameters():
            if name.split(".")[-1].startswith("gru_"):
                H = p.shape[-1] // 3
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) / math.sqrt(H))
            elif name.endswith("log_recency_sigma"):
                p.fill_(math.log(1.5))
            elif name.endswith("Q_param"):
                p.copy_(torch.randn(p.shape, generator=gen))
            elif re.fullmatch(r"tm_\d\d_basis", name):
                p.copy_(BASIS_STD * torch.randn(p.shape, generator=gen))
            elif re.fullmatch(r"\w+_ln\d_scale", name):
                p.copy_(1 + 0.1 * torch.randn(p.shape, generator=gen))
            elif re.fullmatch(r"\w+_ln\d_bias", name):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif re.fullmatch(r"conv\d_kernel_\d+", name.split(".")[-1]):  # TimesNet's
                k, _, c_in, _ = p.shape  # inception kernels, flax's [k, k, in, out]
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) / math.sqrt(k * k * c_in))
            elif re.fullmatch(r"conv\d_bias_\d+", name.split(".")[-1]):
                p.copy_(0.1 * (torch.rand(p.shape, generator=gen) * 2 - 1))
            elif name in ("T_bias", "nodevec1", "nodevec2"):  # tPatchGNN's, N(0, 1)
                p.copy_(torch.randn(p.shape, generator=gen))
            elif name.endswith("_time_w"):  # NeuralFlow's time nets, N(0, 0.1^2)
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))


def make_experiment(exp_dir: str, cfg_kw: dict, seed: int):
    """An experiment of cfg_kw with seeded weights, saved to exp_dir; a
    raw-text one takes notes as wide as its fusion LLM (input_proj)."""
    cfg = Config(**cfg_kw)
    gen = torch.Generator().manual_seed(seed)
    d_notes = None if cfg.use_text_embeddings else get_d_model(cfg.llm_model_fusion)
    model, fusion = get_model(cfg), FusionModel(cfg, d_notes=d_notes)
    seeded_weights(model, gen)
    seeded_weights(fusion, gen)
    save_experiment(exp_dir, cfg, model.state_dict(), fusion.state_dict(), step=0)
    return cfg


def make_requests(cfg, n: int, seed: int, note=None, oversample: int = 4) -> list[dict]:
    """Ragged requests: 0..input_len observations with NaN holes,
    1..pred_len forecast times, 0-8 notes, every third with mean/std.
    note(rng) gives a note's payload: a random embedding by default. The
    times are drawn from grids of oversample x input_len and oversample x
    pred_len points."""
    rng = np.random.default_rng(seed)
    if note is None:
        note = lambda rng: {"embedding": rng.standard_normal(cfg.d_txt).tolist()}
    D, hist = cfg.input_dim, float(cfg.history)
    tmax = hist + cfg.pred_window
    out = []
    for i in range(n):
        k = int(rng.integers(0, cfg.input_len + 1))
        m = int(rng.integers(1, cfg.pred_len + 1))
        tt = np.sort(rng.choice(np.linspace(0, hist * 0.999, oversample * cfg.input_len), k,
                                replace=False))
        vals = rng.standard_normal((k, D))
        vals[rng.random(vals.shape) < 0.2] = np.nan
        tp = np.sort(rng.choice(np.linspace(hist, tmax, oversample * cfg.pred_len), m,
                                replace=False))
        inst = {"observed_tp": tt.tolist(), "observed_data": vals.tolist(),
                "tp_to_predict": tp.tolist(),
                "notes": [{"tau": float(rng.uniform(0, hist)), **note(rng)}
                          for _ in range(int(rng.integers(0, 9)))]}
        if i % 3 == 0:
            inst["mean"] = rng.standard_normal(D).tolist()
            inst["std"] = (0.5 + rng.random(D)).tolist()
        out.append(inst)
    return out


class TextNotes:
    """note(rng) for raw-text requests, a synthetic mix for coverage (no
    measured note traffic stands behind it): word counts log-uniform over
    1..max_words (so every embed_notes bucket is hit), about a quarter of
    the notes repeat an earlier string, about one in twenty is empty."""

    def __init__(self, max_words: int = 1000):
        self.max_words = max_words
        self.vocab = np.asarray([f"w{i}" for i in range(5000)])
        self.seen: list[str] = []

    def __call__(self, rng) -> dict:
        r = rng.random()
        if self.seen and r < 0.25:
            return {"text": self.seen[int(rng.integers(len(self.seen)))]}
        if r < 0.30:
            return {"text": ""}
        n = int(np.exp(rng.uniform(0, np.log(self.max_words + 1))))
        text = " ".join(rng.choice(self.vocab, max(n, 1)))
        self.seen.append(text)
        return {"text": text}


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
        if isinstance(m, (EncoderLayer, DecoderLayer)):
            m.use_fused_ffn = on
        elif isinstance(m, CRU):
            m.use_pallas = on
        elif isinstance(m, GPT2Block):  # TimeLLM's frozen GPT-2
            m.use_fused_attn = on
    svc.fusion.ttf.use_pallas = on
    llm = getattr(svc._stage_top, "llm", None)
    if llm is not None:
        set_attention(llm, on)


def set_attention(llm, on: bool) -> None:
    for m in llm.modules():
        if isinstance(m, GPT2Block):
            m.use_fused_attn = on


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


def run_raw_text_serving(device, n_requests: int, seed: int, exp_dir: str,
                         cfg_kw: dict = TEXT_CFG, max_words: int = 1000) -> dict:
    """Phase 4b: raw-text notes through the frozen GPT-2 on `device`."""
    cfg = make_experiment(exp_dir, cfg_kw, seed)
    t0 = time.monotonic()
    svc = ForecastService(exp_dir, max_batch=64, max_wait_ms=5.0, device=device)
    log(f"# raw-text service up in {time.monotonic() - t0:.2f} s (GPT-2 init and "
        f"one warmup dispatch)")
    try:
        stage = svc._stage_top
        llm, tok = stage.llm, stage.tokenizer
        requests = make_requests(cfg, n_requests, seed, note=TextNotes(max_words))
        d0, calls0 = svc.metrics()["dispatches_total"], stage.llm_calls
        ffn.launches = recavg.launches = attn.launches = 0
        attn.launches_by_shape = {}
        t0 = time.monotonic()
        answers = serve_requests(svc, requests)
        wall = time.monotonic() - t0
        launches = {"fused_encoder_ffn": ffn.launches,
                    "recency_weighted_average": recavg.launches,
                    "fused_causal_attention": attn.launches}
        attn_shapes = [[list(k), n] for k, n in sorted(attn.launches_by_shape.items())]
        metrics = svc.metrics()
        dispatches = metrics["dispatches_total"] - d0
        for name, n in launches.items():
            if n == 0 and device.type == "cuda":  # CPU tensors take the plain versions
                raise AssertionError(f"{name} was never launched while serving raw text")
        for inst, ans in zip(requests, answers):
            y = np.asarray(ans["prediction"])
            if y.shape != (len(inst["tp_to_predict"]), cfg.input_dim) or not np.isfinite(y).all():
                raise AssertionError(f"bad answer shape {y.shape} or non-finite values")
        texts = [n["text"] for r in requests for n in r["notes"]]
        unique = set(texts)
        run_tokens = int(tok(sorted(unique), max_length=cfg.max_length)[1].sum())
        log(f"# served {len(requests)} raw-text requests ({len(texts)} notes, "
            f"{len(unique)} distinct strings, {run_tokens} real tokens) in {dispatches} "
            f"dispatches and {stage.llm_calls - calls0} LLM calls, {wall:.3f} s: "
            f"{len(requests) / wall:.1f} requests/s, dispatch p50 "
            f"{metrics['dispatch_latency_ms']['p50']} ms p95 "
            f"{metrics['dispatch_latency_ms']['p95']} ms; launches {launches}")
        log("# dispatch latencies in order (ms): "
            + " ".join(f"{t * 1e3:.1f}" for t in list(svc._lat_ring)[-dispatches:]))

        # one dispatch's notes through the same GPT-2, attention kernel vs plain
        notes = [[n["text"] for n in r["notes"]] for r in requests[:64]]
        stats: dict = {}
        embed = lambda: embed_notes(notes, llm, tok, max_length=cfg.max_length,
                                    stats_out=stats)[0]
        got = embed()
        set_attention(llm, False)
        try:
            want = embed()
            embed_ms = {}
            if device.type == "cuda":
                for mode in ("plain", "kernel", "kernel", "plain"):  # in turns
                    set_attention(llm, mode == "kernel")
                    embed_ms.setdefault(mode, []).extend(wall_ms(embed, reps=3))
                embed_ms = {k: float(np.median(v)) for k, v in embed_ms.items()}
        finally:
            set_attention(llm, True)
        err = max_err(torch.from_numpy(got), torch.from_numpy(want), EMBED_TOL)
        embed = {"notes": stats["n_notes"], "real_tokens": stats["real_tokens"],
                 "processed_tokens": stats["processed_tokens"], "max_abs_err": err,
                 "ms": embed_ms}
        if embed_ms:
            embed["real_tokens_per_s"] = {k: stats["real_tokens"] / (v / 1e3)
                                          for k, v in embed_ms.items()}
        log(f"# one dispatch's notes through GPT-2, attention kernel vs plain: {json.dumps(embed)}")
        profile = None
        if device.type == "cuda":
            built = [_build_chunk(r, cfg, svc.d_txt) for r in requests[:64]]
            profile = profile_dispatch(svc, built, reset=stage._cache.clear)
            log(f"# one uncontended raw-text dispatch of 64 requests, every note new: "
                f"{json.dumps(profile)}")
        return {"launches": launches, "attn_launches_by_shape": attn_shapes,
                "dispatches": dispatches,
                "requests_per_s": len(requests) / wall, "wall_s": wall,
                "run_real_tokens": run_tokens,
                "dispatch_ms": metrics["dispatch_latency_ms"], "embed": embed,
                "dispatch_profile": profile}
    finally:
        svc.close()


def run_cru_serving(device, n_requests: int, seed: int, exp_dir: str, cfg, fused: bool) -> dict:
    """Phase 6: serve the CRU experiment in `exp_dir` on one route, the
    default (kernel #5 once a scan step) or, with IMM_TSF_CRU_FUSED=1 set
    for the service's whole life, the fused (kernel #6 once a dispatch)."""
    route = "fused" if fused else "default"
    saved = os.environ.pop("IMM_TSF_CRU_FUSED", None)
    if fused:
        os.environ["IMM_TSF_CRU_FUSED"] = "1"
    try:
        t0 = time.monotonic()
        svc = ForecastService(exp_dir, max_batch=64, max_wait_ms=5.0, device=device)
        log(f"# CRU service ({route} route) up in {time.monotonic() - t0:.2f} s")
        try:
            return _serve_cru(svc, device, cfg, n_requests, seed, route)
        finally:
            svc.close()
    finally:
        os.environ.pop("IMM_TSF_CRU_FUSED", None)
        if saved is not None:
            os.environ["IMM_TSF_CRU_FUSED"] = saved


def _serve_cru(svc, device, cfg, n_requests, seed, route) -> dict:
    requests = make_requests(cfg, n_requests, seed)
    d0 = svc.metrics()["dispatches_total"]
    ffn.launches = recavg.launches = attn.launches = expm.launches = cru_scan.launches = 0
    t0 = time.monotonic()
    answers = serve_requests(svc, requests)
    wall = time.monotonic() - t0
    launches = {"recency_weighted_average": recavg.launches, "batched_expm": expm.launches,
                "fused_cru_scan": cru_scan.launches}
    metrics = svc.metrics()
    dispatches = metrics["dispatches_total"] - d0
    T = cfg.input_len + cfg.pred_len
    if device.type == "cuda":  # CPU tensors take the plain versions
        want = {"recency_weighted_average": dispatches,
                "batched_expm": T * dispatches if route == "default" else 0,
                "fused_cru_scan": dispatches if route == "fused" else 0}
        if launches != want:
            raise AssertionError(f"CRU {route} route launched {launches}, expected {want} "
                                 f"in {dispatches} dispatches")
    for inst, ans in zip(requests, answers):
        y = np.asarray(ans["prediction"])
        if y.shape != (len(inst["tp_to_predict"]), cfg.input_dim) or not np.isfinite(y).all():
            raise AssertionError(f"bad answer shape {y.shape} or non-finite values")
    log(f"# CRU {route} route: served {len(requests)} requests in {dispatches} dispatches, "
        f"{wall:.3f} s: {len(requests) / wall:.1f} requests/s, dispatch p50 "
        f"{metrics['dispatch_latency_ms']['p50']} ms p95 "
        f"{metrics['dispatch_latency_ms']['p95']} ms; launches {launches}")

    # one full dispatch's batch, kernels vs plain versions, same modules
    built = [_build_chunk(r, cfg, svc.d_txt) for r in requests[:64]]
    batch = svc.to_device(svc._collate([b[0] for b in built]))
    with torch.inference_mode():
        got = svc._forward(batch)
        set_kernels(svc, False)
        try:
            want = svc._forward(batch)
        finally:
            set_kernels(svc, True)
        ins = svc.model.scan_inputs(batch["tp_to_predict"], batch["observed_data"],
                                    batch["observed_tp"], batch["observed_mask"])
        blocks = van_loan_blocks(ins)
    # plain tensors that track no gradient, for phase 5's calls outside inference mode
    ins = {k: v.detach().clone() for k, v in ins.items()}
    err = max_err(got, want, CRU_SERVE_TOL)
    tiers = tier_shares(torch.cat(blocks))
    log(f"# CRU {route} route, one dispatch {tuple(batch['observed_data'].shape)}: kernels vs "
        f"plain max|err| {err:.3e}; its {len(blocks)} x {tuple(blocks[0].shape)} Van Loan "
        f"blocks by tier: {tiers}")
    if route == "default" and min(tiers["taylor4"], tiers["taylor12"],
                                  tiers["taylor12_squared"]) == 0:
        raise AssertionError(f"the served Van Loan blocks miss a tier: {tiers}")
    forward_ms, profile = {}, None
    if device.type == "cuda":
        for mode in ("plain", "kernels", "kernels", "plain"):  # in turns
            set_kernels(svc, mode == "kernels")
            forward_ms.setdefault(mode, []).extend(wall_ms(svc._forward, batch, reps=6)[1:])
        set_kernels(svc, True)
        forward_ms = {k: float(np.median(v)) for k, v in forward_ms.items()}
        log(f"# CRU {route} route, one dispatch's forward (host clock to synchronize): "
            f"{forward_ms} ms")
        profile = profile_dispatch(svc, built)
        log(f"# CRU {route} route, one uncontended dispatch of 64 requests: {json.dumps(profile)}")
    return {"launches": launches, "dispatches": dispatches,
            "requests_per_s": len(requests) / wall,
            "dispatch_ms": metrics["dispatch_latency_ms"], "serve_err": err,
            "forward_ms": forward_ms, "dispatch_profile": profile, "tiers": tiers,
            "out": got, "scan_inputs": ins, "blocks": blocks}


def profile_dispatch(svc, built, reps: int = 10, reset=None) -> dict:
    """Where one uncontended dispatch of a full batch goes. Host clock
    (median of `reps`): the collate alone (with the loader stages: for raw
    text, the note embedding), and the whole dispatch (collate, H2D,
    forward, D2H, fan-out). Then `reps` dispatches under torch.profiler
    (`trace`). `reset()` runs before every collate and dispatch (to empty
    the note cache)."""
    chunks = [b[0] for b in built]
    reset = reset or (lambda: None)
    collate = lambda: (reset(), svc._collate(chunks))
    dispatch = lambda: (reset(), svc._infer(built))
    wall_ms(dispatch, reps=1)  # warm
    collate_ms = float(np.median(wall_ms(collate, reps=reps)))
    dispatch_ms = float(np.median(wall_ms(dispatch, reps=reps)))
    traced = trace(dispatch, reps, dispatch_ms)
    return {"reps": reps, "collate_ms": collate_ms, "dispatch_ms": dispatch_ms,
            "traced_dispatch_ms": traced.pop("traced_ms"), **traced}


def trace(fn, reps: int, untraced_ms: float, inference: bool = True) -> dict:
    """`reps` calls of fn under torch.profiler, whose overhead makes them
    slower (`traced_ms`): device-busy ms per call is the union of the
    kernels' and copies' device intervals there, and the idle share is
    1 - busy / the untraced call's ms. Only device activity is recorded:
    the host's events would add nothing read here, and on the LatentODE's
    paths (~10^5 launches a step) reading them back takes minutes. Raises
    when the trace holds no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_ms = float(np.median(wall_ms(fn, reps=reps, inference=inference)))
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
    return {"traced_ms": traced_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / untraced_ms,
            "kernel_launches": len(kernels) / reps,
            "top_device": {n: {"ms": us / reps / 1e3, "launches": c / reps}
                           for n, (us, c) in top}}


def wall_ms(fn, *args, reps: int = 10, inference: bool = True) -> list[float]:
    """Host-clock ms of each of `reps` calls fn(*args), each ending in a
    synchronize (under torch.inference_mode unless `inference` is off);
    the caller warms up."""
    out = []
    with torch.inference_mode(inference):
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


# ---------------------------------------------------------------- phase 7
KERNEL_COUNTS = {  # kernel -> (module, its launch counter)
    "recency_weighted_average": (recavg, "launches"),
    "fused_encoder_ffn": (ffn, "launches"), "fused_encoder_ffn_train": (ffn, "train_launches"),
    "batched_expm": (expm, "launches"), "batched_expm_frechet": (expm, "frechet_launches"),
    "fused_cru_scan": (cru_scan, "launches"),
    "fused_cru_scan_backward": (cru_scan, "backward_launches"),
    "fused_causal_attention": (attn, "launches"),
    "fused_causal_attention_backward": (attn, "backward_calls")}


def zero_counts() -> None:
    for module, attr in KERNEL_COUNTS.values():
        setattr(module, attr, 0)


def read_counts() -> dict:
    return {name: getattr(module, attr) for name, (module, attr) in KERNEL_COUNTS.items()}


class cru_route:
    """IMM_TSF_CRU_FUSED=1 for the block when `fused`, unset otherwise."""

    def __init__(self, fused: bool):
        self.fused = fused

    def __enter__(self):
        self.saved = os.environ.pop("IMM_TSF_CRU_FUSED", None)
        if self.fused:
            os.environ["IMM_TSF_CRU_FUSED"] = "1"

    def __exit__(self, *exc):
        os.environ.pop("IMM_TSF_CRU_FUSED", None)
        if self.saved is not None:
            os.environ["IMM_TSF_CRU_FUSED"] = self.saved


def training_data(root: str, args=TRAIN_ARGS) -> dict:
    """The resolved config and loaders of the trained run, as
    imm_tsf_torch.main builds them from `args`."""
    cfg, _ = train_main.get_args_from_parser(list(args) + ["--data_root", root])
    cfg = resolve_max_length(apply_presets(cfg, train_main.fixed_params,
                                           train_main.tunable_params))
    return parse_datasets(cfg, verbose=False)


def expected_counts(route: str, T: int, steps: int, evals: int) -> dict:
    """Launches of a run of `steps` gradient steps and `evals` eval batches.
    The default route's backward runs T - 1 expm adjoints a step, not T:
    the last step's expm gives the prior of a step that does not exist, no
    output depends on it, and autograd never runs its backward (the JAX
    package's lax.scan runs it on a zero cotangent)."""
    fwd = steps + evals
    default = route == "default"
    return dict(dict.fromkeys(KERNEL_COUNTS, 0), recency_weighted_average=fwd,
                batched_expm=T * fwd if default else 0,
                batched_expm_frechet=(T - 1) * steps if default else 0,
                fused_cru_scan=0 if default else fwd,
                fused_cru_scan_backward=0 if default else steps)


def train_route(device, args, root: str, exp_dir: str, label: str, n_val: int, n_test: int,
                early_stop_delta: float, expected, free=(), inspect=None,
                streaming: bool = True) -> dict:
    """Train through imm_tsf_torch.main.main(args) with the launch counts
    zeroed just before; every loss and metric must be finite and, on cuda,
    the counts equal expected(steps, evals), but for the counters named in
    `free` (the caller checks those). Prints each epoch and the step
    phases' device ms. inspect(result), when given, sees trainable()'s
    result (the trained modules too). `streaming` pins the streaming loop
    (STREAM: phases 7-13 keep the per-phase step timings of PRs 7-14);
    phase 14 runs the default epoch loop with it off."""
    timings: dict = {}
    zero_counts()
    t0 = time.monotonic()
    res = train_main.main(list(args) + (STREAM if streaming else [])
                          + ["--data_root", root, "--save", exp_dir, "--device", device.type],
                          timings=timings)
    wall = time.monotonic() - t0
    launches = read_counts()
    hist = res["history"]
    losses = [x for h in hist for x in h["step_losses"]]
    metrics = [res[k] for k in ("mse", "mae", "rmse")] + [h["val"]["mse"] for h in hist]
    if not np.isfinite(losses + metrics).all():
        raise AssertionError(f"{label}: non-finite loss or metric")
    best, tested = np.inf, 0  # the epochs that improved ran the test split
    for h in hist:
        if best - h["val"]["mse"] > early_stop_delta:
            best, tested = h["val"]["mse"], tested + 1
    want = dict(expected(len(losses), len(hist) * n_val + tested * n_test),
                **{k: launches[k] for k in free})
    if device.type == "cuda" and launches != want:
        raise AssertionError(f"training {label} launched {launches}, expected {want}")
    if inspect is not None:
        inspect(res)
    epochs = [{"epoch": h["epoch"], "train_loss": h["train_loss"],
               "val_mse": h["val"]["mse"], "windows_per_s": h["windows_per_sec"]}
              for h in hist]
    step_ms = {k: float(np.median(v)) for k, v in timings.get("step_ms", {}).items()}
    per_step = {k: v / len(losses) for k, v in launches.items()}
    each = {k: [round(x, 3) for x in v] for k, v in timings.get("step_ms", {}).items()}
    save_s = timings.get("save", [])
    log(f"# trained {label}, {len(losses)} steps in {wall:.2f} s: epochs "
        f"{json.dumps(epochs)}; device ms of each step by CUDA events {each}, medians "
        f"{step_ms}; "
        f"launches {launches} ({per_step} a step, eval batches included); checkpoint "
        f"writes {[round(x, 2) for x in save_s]} s; test "
        f"{json.dumps({k: res[k] for k in ('mse', 'mae', 'best_iter')})}")
    return {"launches": launches, "steps": len(losses), "step_losses": losses,
            "wall_s": wall, "epochs": epochs, "save_s": save_s,
            "step_ms": step_ms, "step_ms_each": timings.get("step_ms", {}),
            "test": {k: res[k] for k in ("mse", "mae", "rmse", "best_iter")},
            "phase_s": {k: timings.get(k, []) for k in ("setup", "train", "val", "test")},
            "epoch_loop": timings.get("epoch_loop")}


def run_training(device, root: str, exp_dir: str) -> dict:
    """Phase 7: train the CRU experiment through imm_tsf_torch.main on each
    route, then one step held kernels vs plain (compare_step)."""
    data = training_data(root)
    cfg = data["cfg"]
    T = cfg.input_len + cfg.pred_len
    n_val, n_test = len(data["val_dataloader"]), len(data["test_dataloader"])
    out = {"T": T, "batches": {"train": len(data["train_dataloader"]), "val": n_val,
                               "test": n_test}, "routes": {}}
    log(f"# training data: T = {cfg.input_len} + {cfg.pred_len} = {T}, batches {out['batches']}")
    for route in ("default", "fused"):
        with cru_route(route == "fused"):
            out["routes"][route] = train_route(
                device, TRAIN_ARGS, root, exp_dir, f"the {route} route", n_val, n_test,
                cfg.early_stop_delta, lambda steps, evals: expected_counts(route, T, steps, evals))
    out["step"] = compare_step(cfg, data, device)
    return out


def compare_step(cfg, data, device) -> dict:
    """One gradient step of the trained configuration, seeded weights
    (phase 6's, bases N(0, BASIS_STD^2)) and one validation batch: loss
    and every parameter's gradient by the kernel path on each route and
    by the plain path, in float32, against the plain path in float64.
    Each gradient's error (max |g - g64| / max |g64|) on the kernel path
    must be at most GRAD_FACTOR (ICOV_GRAD_FACTOR for the initial
    covariances) times the float32 plain path's, plus GRAD_FLOOR; the
    losses agree to TRAIN_LOSS_RTOL; so the two routes agree through the
    float64 run. Launch counts are exact: #5 T and #4 T - 1 times on the
    default route, #6 and #7 once on the fused, #1 once on both. Captures #4's and #7's inputs for phase 5 and traces
    one full step (optimizer included) of each route."""
    gen = torch.Generator().manual_seed(SEED)
    model, fusion = get_model(cfg), FusionModel(cfg)
    seeded_weights(model, gen)
    seeded_weights(fusion, gen)
    batch = to_device(next(iter(data["val_dataloader"])), device)
    T = cfg.input_len + cfg.pred_len

    def grads(model, fusion, batch, route, kernels):
        model.use_pallas = fusion.ttf.use_pallas = kernels
        for m in [*model.modules(), *fusion.modules()]:
            if isinstance(m, Dropout):  # the same salts, so the same dropout masks
                m.generator = torch.Generator().manual_seed(SEED)
        model.zero_grad(set_to_none=True)
        fusion.zero_grad(set_to_none=True)
        with cru_route(route == "fused"):
            loss = make_loss_fn(make_forward(cfg, model, fusion))(batch)
            loss.backward()
        named = [*model.named_parameters(), *fusion.named_parameters()]
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in named}

    model64, fusion64 = (copy.deepcopy(m).double().to(device).train() for m in (model, fusion))
    batch64 = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
    loss64, g64 = grads(model64, fusion64, batch64, "default", False)
    model, fusion = model.to(device).train(), fusion.to(device).train()
    loss_p, g_p = grads(model, fusion, batch, "default", False)
    plain_err = {n: float((g_p[n].double() - r).abs().max() / r.abs().max().clamp(min=1e-30))
                 for n, r in g64.items()}
    out = {"loss_plain": loss_p, "loss_float64": loss64, "routes": {}}
    captured: dict = {"frechet": [], "scan_bwd": []}
    adjoint, scan_bwd = ops_expm.expm_adjoint, cru_scan.fused_cru_scan_backward

    def record_adjoint(M, G, max_squarings=MAX_SQUARINGS, kernel=True):
        captured["frechet"].append((M.detach().transpose(-1, -2).contiguous(), G.detach().clone()))
        return adjoint(M, G, max_squarings, kernel)

    def record_scan_bwd(*args):
        captured["scan_bwd"].append(args)
        return scan_bwd(*args)

    for route in ("default", "fused"):
        zero_counts()
        ops_expm.expm_adjoint, cru_scan.fused_cru_scan_backward = record_adjoint, record_scan_bwd
        try:
            loss_k, g_k = grads(model, fusion, batch, route, True)
        finally:
            ops_expm.expm_adjoint, cru_scan.fused_cru_scan_backward = adjoint, scan_bwd
        launches = read_counts()
        want = expected_counts(route, T, 1, 0)
        if device.type == "cuda" and launches != want:
            raise AssertionError(f"one {route} step launched {launches}, expected {want}")
        if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * abs(loss_p):
            raise AssertionError(f"{route} step loss {loss_k} vs plain {loss_p}")
        errs = {n: float((g_k[n].double() - r).abs().max() / r.abs().max().clamp(min=1e-30))
                for n, r in g64.items()}
        factor = lambda n: ICOV_GRAD_FACTOR if n in ("log_icu", "log_icl") else GRAD_FACTOR
        bad = {n: (e, plain_err[n]) for n, e in errs.items()
               if not e <= factor(n) * plain_err[n] + GRAD_FLOOR}
        if bad:
            raise AssertionError(f"{route} step gradients farther from float64 than "
                                 f"allowed against the plain path's: {bad}")
        worst = max(errs, key=lambda n: errs[n] / (plain_err[n] + 1e-6))
        out["routes"][route] = {"loss": loss_k, "launches": launches, "grads": g_k,
                                "worst_grad": {worst: (errs[worst], plain_err[worst])}}
    route_gap = max(float((out["routes"]["fused"]["grads"][n] - out["routes"]["default"]["grads"][n])
                          .abs().max() / g64[n].abs().max().clamp(min=1e-30)) for n in g64)
    for res in out["routes"].values():
        res.pop("grads")
    out["route_grad_gap"] = route_gap
    log(f"# one step, seeded weights, a validation batch: {json.dumps(out)}; the largest "
        f"gradient error vs float64 on the plain path {max(plain_err.values()):.3e}")

    # the captured inputs, held to their plain versions (phase 3's checks)
    pairs = captured["frechet"]
    out["frechet_err"] = max(frechet_rel_err(expm.batched_expm_frechet(M, G, MAX_SQUARINGS),
                                             expm_frechet_taylor12(M, G, MAX_SQUARINGS))
                             for M, G in pairs)
    args = captured["scan_bwd"][0]
    ins = dict(zip(("y_mean", "y_var", "valid", "dts", "coeff_w", "coeff_b", "dense_basis",
                    "trans_var", "init_cu", "init_cl"), (a.detach() for a in args[:10])))
    bwd = check_scan_bwd(cru_scan.fused_cru_scan_backward(*args), ins, args[10], args[11])
    log(f"# the step's {len(pairs)} x {tuple(pairs[0][0].shape)} Frechet derivatives: "
        f"max|err|/max|ref| {out['frechet_err']:.3e}; its scan backward against float64: "
        f"{json.dumps(bwd)}")
    out.update(captured=captured, scan_bwd_check=bwd, frechet_shape=tuple(pairs[0][0].shape),
               scan_shape=tuple(ins["y_mean"].shape) + (ins["coeff_w"].shape[1],))

    if device.type == "cuda":  # one whole step of each route, optimizer included, traced
        params = trainable_parameters(model, fusion)
        step = make_grad_step(make_loss_fn(make_forward(cfg, model, fusion)),
                              make_optimizer(params, cfg.lr, cfg.w_decay), params)
        out["profile"] = {}
        for route in ("default", "fused"):
            with cru_route(route == "fused"):
                wall_ms(step, batch, reps=1, inference=False)  # warm
                step_ms = float(np.median(wall_ms(step, batch, reps=5, inference=False)))
                out["profile"][route] = {"step_ms": step_ms,
                                         **trace(lambda: step(batch), 3, step_ms, inference=False)}
            log(f"# one traced {route} training step: {json.dumps(out['profile'][route])}")
    return out


# ---------------------------------------------------------------- phase 8
def held_grads(g_k, g_p, g64, what: str):
    """Hold the kernel route's gradients g_k to float64's g64 against the
    plain route's g_p: each error max |g - g64| / max |g64| at most
    GRAD_FACTOR times the plain route's plus GRAD_FLOOR. A gradient that
    vanishes in exact arithmetic (at most 1e-9 of the largest entry; the
    key projection's bias: the softmax over keys ignores a shift common to
    all keys) has no relative error: it must stay within GRAD_FLOOR of the
    largest entry on both routes. Returns (errs, plain_errs, vanishing)."""
    top = max(float(r.abs().max()) for r in g64.values())
    vanishing = sorted(n for n, r in g64.items() if float(r.abs().max()) <= 1e-9 * top)
    zero_err = {n: (float(g_k[n].abs().max()) / top, float(g_p[n].abs().max()) / top)
                for n in vanishing}
    rel = lambda g, r: float((g.double() - r).abs().max() / r.abs().max())
    plain_err = {n: rel(g_p[n], r) for n, r in g64.items() if n not in zero_err}
    errs = {n: rel(g_k[n], g64[n]) for n in plain_err}
    bad = {n: (e, plain_err[n]) for n, e in errs.items()
           if not e <= GRAD_FACTOR * plain_err[n] + GRAD_FLOOR}
    bad.update({n: e for n, e in zero_err.items() if not max(e) <= GRAD_FLOOR})
    if bad:
        raise AssertionError(f"{what} gradients farther from float64 than allowed "
                             f"against the plain route's: {bad}")
    return errs, plain_err, zero_err


def compare_wide_notes(device) -> dict:
    """The fusion stack on notes wider than d_txt: FusionModel of SERVE_CFG
    with GPT2M's 1024-wide note embeddings into d_txt 768, seeded weights,
    one forward and backward of sum(out * g) at the serving shape (B 64,
    N 8, T 24) on the kernel route (#1), the plain route and the plain
    route in float64: outputs to SERVE_TOL, gradients as held_grads holds
    a training step's, #1 launched once."""
    cfg = Config(**dict(SERVE_CFG, llm_model_fusion="GPT2M"))
    d_notes = get_d_model(cfg.llm_model_fusion)
    gen = torch.Generator().manual_seed(SEED + 7)
    fusion = FusionModel(cfg, d_notes=d_notes)
    seeded_weights(fusion, gen)
    B, N, T = PATCH_STEP_B, 8, cfg.pred_len
    nmask = (torch.rand((B, N), generator=gen) < 0.7).float()
    nmask[-1] = 0.0  # a sample without notes
    ins = [torch.randn((B, N, d_notes), generator=gen) * nmask[:, :, None],
           torch.rand((B, N), generator=gen),  # times where the weights vary
           0.5 + 0.5 * torch.sort(torch.rand((B, T), generator=gen), dim=1).values,
           torch.randn((B, T, cfg.input_dim), generator=gen), nmask]
    g = torch.randn((B, T, cfg.input_dim), generator=gen)

    def run(module, dtype, kernels):
        module.ttf.use_pallas = kernels
        module.zero_grad(set_to_none=True)
        out = module(*(x.to(device, dtype) for x in ins))
        (out * g.to(device, dtype)).sum().backward()
        return out.detach(), {n: p.grad.detach().clone() for n, p in module.named_parameters()}

    fusion64 = copy.deepcopy(fusion).double().to(device).eval()
    _, g64 = run(fusion64, torch.float64, False)
    fusion = fusion.to(device).eval()
    out_p, g_p = run(fusion, torch.float32, False)
    zero_counts()
    out_k, g_k = run(fusion, torch.float32, True)
    launches = read_counts()["recency_weighted_average"]
    if device.type == "cuda" and launches != 1:
        raise AssertionError(f"the wide-notes fusion forward launched #1 {launches} times")
    out = {"notes": [B, N, d_notes], "d_txt": cfg.d_txt, "launches": launches,
           "max_abs_err": max_err(out_k, out_p, SERVE_TOL)}
    errs, plain_err, _ = held_grads(g_k, g_p, g64, "wide-notes fusion")
    out["grad_err"] = {n: (errs[n], plain_err[n]) for n in errs}
    log(f"# fusion on {d_notes}-wide notes into d_txt {cfg.d_txt}, kernel vs plain route: "
        f"{json.dumps(out)}")
    return out


def ffn_counts(route: str, ffn_sites: int, steps: int, evals: int) -> dict:
    """Launches of a run of `steps` gradient steps and `evals` eval batches
    of a model with `ffn_sites` FFN layers behind TTF_RecAvg: on the kernel
    route #1 once a forward and #2 once a forward an FFN site (its training
    form in the steps); nothing on the plain route."""
    counts = dict.fromkeys(KERNEL_COUNTS, 0)
    if route == "kernel":
        counts.update(recency_weighted_average=steps + evals,
                      fused_encoder_ffn=ffn_sites * (steps + evals),
                      fused_encoder_ffn_train=ffn_sites * steps)
    return counts


def ffn_site_rows(model):
    """Forward pre-hooks on every EncoderLayer and DecoderLayer that record
    the rows its FFN takes (the leading dims of its input); returns (the
    list they append to, a function that removes them)."""
    rows: list = []
    record = lambda _, a: rows.append(a[0].shape[0] * a[0].shape[1])
    hooks = [m.register_forward_pre_hook(record) for m in model.modules()
             if isinstance(m, (EncoderLayer, DecoderLayer))]
    return rows, lambda: [h.remove() for h in hooks]


def final_weights(res) -> dict:
    """The trained modules' state dicts (CPU copies) of trainable()'s result."""
    return {mod: {k: v.detach().cpu().clone() for k, v in res[mod].state_dict().items()}
            for mod in ("model", "fusion") if res[mod] is not None}


def run_patchtst_training(device, root: str, exp_dir: str, kept: dict | None = None) -> dict:
    """Phase 8: train PatchTST + TTF_RecAvg + MMF_GR_Add through
    imm_tsf_torch.main on the kernel route, then the plain route, then one
    step at the bench headline's shape held kernels vs plain
    (compare_patchtst_step). `kept`, when given, gets the kernel route's
    final weights under "weights" (phase 11d holds a resumed run to them)."""
    data = training_data(root, PATCH_TRAIN_ARGS)
    cfg = data["cfg"]
    n_val, n_test = len(data["val_dataloader"]), len(data["test_dataloader"])
    out = {"batches": {"train": len(data["train_dataloader"]), "val": n_val, "test": n_test},
           "widths": {k: getattr(cfg, k) for k in ("d_model", "d_ff", "n_heads", "e_layers",
                                                   "dropout", "dropout_impl")},
           "routes": {}}
    log(f"# PatchTST training data: L {cfg.input_len}, Lp {cfg.pred_len}, batches "
        f"{out['batches']}, widths {out['widths']}")
    keep = (lambda res: kept.update(weights=final_weights(res))) if kept is not None else None
    for route in ("kernel", "plain"):
        out["routes"][route] = train_route(
            device, PATCH_TRAIN_ARGS + PATCH_ROUTES[route], root, exp_dir,
            f"PatchTST on the {route} route", n_val, n_test, cfg.early_stop_delta,
            lambda steps, evals: ffn_counts(route, cfg.e_layers, steps, evals),
            inspect=keep if route == "kernel" else None)
    out["step"] = compare_patchtst_step(device)
    out["wide_notes"] = compare_wide_notes(device)
    return out


def headline_batch(cfg, B: int, gen, device) -> dict:
    """A training batch at the configuration's full shape: B windows of
    input_len observed steps (a fifth of the values missing) and pred_len
    forecast steps over input_dim channels, times normalised as
    standard_collate does, 8 note slots of d_txt (about 70 % filled)."""
    L, Lp, C, N = cfg.input_len, cfg.pred_len, cfg.input_dim, 8
    span = cfg.history + cfg.pred_window
    u = lambda *shape: torch.rand(shape, generator=gen)
    mask, pmask = (u(B, L, C) < 0.8).float(), (u(B, Lp, C) < 0.8).float()
    batch = {"observed_tp": torch.sort(u(B, L) * cfg.history / span, dim=1).values,
             "observed_data": torch.randn((B, L, C), generator=gen) * mask,
             "observed_mask": mask,
             "tp_to_predict": torch.sort(cfg.history / span + u(B, Lp) * cfg.pred_window / span,
                                         dim=1).values,
             "data_to_predict": torch.randn((B, Lp, C), generator=gen) * pmask,
             "mask_predicted_data": pmask, "tau": u(B, N) * cfg.history,
             "notes_embeddings": torch.randn((B, N, cfg.d_txt), generator=gen),
             "notes_mask": (u(B, N) < 0.7).float()}
    return {k: v.to(device) for k, v in batch.items()}


class _Pinned:
    """A choice that rounding may flip (a max-pool's argmax, a top-k's
    order), pinned across compared runs: the first run records it call by
    call, every later run takes the first run's (`next_run()` starts a
    run), and `flips[r]` counts the elements where run r + 1's own choice
    differed."""

    def __init__(self):
        self.records, self.flips, self.run, self.call = [], [], 0, 0

    def next_run(self) -> None:
        self.run, self.call = self.run + 1, 0
        self.flips.append(0)

    def pinned(self, choice):
        if self.run == 0:
            self.records.append(choice)
            return choice
        pinned = self.records[self.call]
        self.call += 1
        self.flips[-1] += int((choice != pinned).sum())
        return pinned


class pinned_pools(_Pinned):
    """Within the block, the distilling convs' max-pools (the F.max_pool1d
    of imm_tsf_torch/layers/transformer.py) take the first run's argmax.
    The max's gradient is a step: where two elements of a window agree to
    within rounding, another rounding order may pick the other one, and a
    whole gradient entry moves to its neighbour. The forward value changes
    by the near tie's difference only."""

    def __getattr__(self, name):  # the rest of torch.nn.functional
        return getattr(torch.nn.functional, name)

    def __enter__(self):
        self.saved = transformer_layers.F
        transformer_layers.F = self
        return self

    def __exit__(self, *exc):
        transformer_layers.F = self.saved

    def max_pool1d(self, x, kernel_size, stride, padding=0):
        out, idx = torch.nn.functional.max_pool1d(x, kernel_size, stride, padding=padding,
                                                  return_indices=True)
        pinned = self.pinned(idx)
        return out if self.run == 0 else torch.gather(x, 2, pinned)


def compare_fused_step(device, cfg, label: str, time_masks: bool = False) -> dict:
    """One gradient step of a full-width experiment with FFN layers (cfg,
    hash dropout) from seeded weights on a batch at the bench headline's
    shape (B 64, L 48, Lp 24, C 8), three ways under the same salts and the
    same ProbSparse key samples (one CPU generator for the salts and one
    device generator for the samples, both reseeded before each run), from
    the same BatchNorm running statistics: the kernel route, the plain route
    and the plain route in float64, the later two with the float64 run's
    max-pool choices (pinned_pools). The losses agree to TRAIN_LOSS_RTOL,
    each gradient's error on the kernel route (max |g - g64| / max |g64|) is
    at most GRAD_FACTOR times the plain route's plus GRAD_FLOOR, the running
    statistics after the step agree across routes to 1e-5 + 1e-5|ref|, and
    the step's launch counts are exact. Then one full step of each route
    (optimizer included) is traced, and with `time_masks` the
    re-derivation of #2's two dropout masks at the first site's M is timed."""
    gen = torch.Generator().manual_seed(SEED)
    model, fusion = get_model(cfg), FusionModel(cfg)
    seeded_weights(model, gen)
    seeded_weights(fusion, gen)
    batch = headline_batch(cfg, PATCH_STEP_B, torch.Generator().manual_seed(SEED + 1), device)
    n_sites = sum(isinstance(m, (EncoderLayer, DecoderLayer)) for m in model.modules())
    rows, remove_hooks = ffn_site_rows(model)
    initial = {n: b.clone() for n, b in model.named_buffers()}

    def set_route(model, fusion, kernels):
        for m in model.modules():
            if isinstance(m, (EncoderLayer, DecoderLayer)):
                m.use_fused_ffn = kernels
        fusion.ttf.use_pallas = kernels

    def grads(model, fusion, batch, kernels):
        set_route(model, fusion, kernels)
        salts = torch.Generator().manual_seed(SEED)  # the same salts, so the same masks
        samples = torch.Generator(device=device).manual_seed(SEED)  # and the same samples
        for m in [*model.modules(), *fusion.modules()]:
            if isinstance(m, Dropout):
                m.generator = salts
            elif isinstance(m, ProbAttention):
                m.generator = samples
        with torch.no_grad():
            for n, b in model.named_buffers():
                b.copy_(initial[n])
        model.zero_grad(set_to_none=True)
        fusion.zero_grad(set_to_none=True)
        loss = make_loss_fn(make_forward(cfg, model, fusion))(batch)
        loss.backward()
        named = [*model.named_parameters(), *fusion.named_parameters()]
        return (float(loss.detach()), {n: p.grad.detach().clone() for n, p in named},
                {n: b.detach().clone() for n, b in model.named_buffers()})

    model64, fusion64 = (copy.deepcopy(m).double().to(device).train() for m in (model, fusion))
    batch64 = {k: v.double() for k, v in batch.items()}
    with pinned_pools() as pools:
        loss64, g64, _ = grads(model64, fusion64, batch64, False)
        model, fusion = model.to(device).train(), fusion.to(device).train()
        initial = {n: b.to(device) for n, b in initial.items()}
        out = {"batch": {k: list(v.shape) for k, v in batch.items()}, "loss_float64": loss64}
        pools.next_run()
        zero_counts()
        loss_p, g_p, buf_p = grads(model, fusion, batch, False)
        plain_launches = read_counts()
        pools.next_run()
        zero_counts()
        loss_k, g_k, buf_k = grads(model, fusion, batch, True)
        launches = read_counts()
    remove_hooks()
    out["pool_argmax_flips"] = {"plain": pools.flips[0], "kernel": pools.flips[1],
                                "windows": sum(int(r.numel()) for r in pools.records)}
    for route, got in (("plain", plain_launches), ("kernel", launches)):
        want = ffn_counts(route, n_sites, 1, 0)
        if device.type == "cuda" and got != want:
            raise AssertionError(f"one {label} step on the {route} route launched {got}, "
                                 f"expected {want}")
    if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * abs(loss_p):
        raise AssertionError(f"{label} step loss: kernel route {loss_k} vs plain {loss_p}")
    errs, plain_err, zero_err = held_grads(g_k, g_p, g64, f"{label} step")
    worst = max(errs, key=lambda n: errs[n] / (plain_err[n] + 1e-6))
    out.update(ffn_rows=rows[-n_sites:], loss_kernel=loss_k, loss_plain=loss_p,
               launches=launches,
               worst_grad={worst: (errs[worst], plain_err[worst])}, vanishing_grads=zero_err,
               largest_grad_err={"kernel": max(errs.values()), "plain": max(plain_err.values())},
               ffn_grad_err={n: (errs[n], plain_err[n]) for n in errs
                             if re.search(r"\.(conv1|conv2|norm2|norm3)\.", n)},
               running_stats_err={n: max_err(buf_k[n], buf_p[n], (1e-5, 1e-5)) for n in buf_p})
    log(f"# one {label} step, seeded weights, B {PATCH_STEP_B} at the headline shape (FFN M "
        f"{out['ffn_rows']}): {json.dumps(out)}")

    if device.type == "cuda":  # one whole step of each route, optimizer included, traced
        params = trainable_parameters(model, fusion)
        step = make_grad_step(make_loss_fn(make_forward(cfg, model, fusion)),
                              make_optimizer(params, cfg.lr, cfg.w_decay), params)
        out["profile"] = {}
        for route in ("kernel", "plain"):
            set_route(model, fusion, route == "kernel")
            wall_ms(step, batch, reps=1, inference=False)  # warm
            step_ms = float(np.median(wall_ms(step, batch, reps=5, inference=False)))
            out["profile"][route] = {"step_ms": step_ms,
                                     **trace(lambda: step(batch), 3, step_ms, inference=False)}
            log(f"# one traced {label} {route}-route training step: "
                f"{json.dumps(out['profile'][route])}")
        if time_masks:
            M = out["ffn_rows"][0]
            salts = torch.tensor([[1, 2], [3, 4]])
            mask_ms = device_ms(lambda: ffn._masks(salts, KEEP, M, cfg.d_model, cfg.d_ff, device),
                                [[]], per_rep=10)
            busy = out["profile"]["kernel"]["device_busy_ms"]
            out["ffn_mask_ms"] = {"ms": mask_ms, "share_of_kernel_step_busy": mask_ms / busy}
            log(f"# #2's two dropout masks re-derived at M {M} ([M, {cfg.d_ff}] and "
                f"[M, {cfg.d_model}]): {mask_ms:.4f} ms, {mask_ms / busy:.3f} of the kernel "
                "route's busy step")
    return out


def compare_informer_step(device) -> dict:
    """Phase 9b's compared step: the full-width Informer experiment
    (INFORMER_CFG, hash dropout 0.1), #2 at M 3072, 1600 and 1536."""
    return compare_fused_step(device, Config(**dict(INFORMER_CFG, dropout=0.1)), "Informer")


def compare_patchtst_step(device) -> dict:
    """Phase 8's compared step: the full-width PatchTST experiment
    (SERVE_CFG, hash dropout 0.1), the FFN at M = 64 x 8 x 16 = 8192."""
    return compare_fused_step(device, Config(**dict(SERVE_CFG, dropout=0.1)), "PatchTST",
                              time_masks=True)



# ---------------------------------------------------------------- phase 9
def informer_ffn_shapes(cfg_kw: dict, B: int = 64) -> tuple:
    """(M, D, F) of Informer's FFN sites at a batch of B: the encoder's
    layers (the time axis after each distilling conv: L -> (L + 1)//2 + 1),
    then the decoder's."""
    L, D, F = cfg_kw["input_len"], cfg_kw["d_model"], cfg_kw["d_ff"]
    rows = []
    for _ in range(cfg_kw["e_layers"]):
        rows.append(B * L)
        L = (L + 1) // 2 + 1
    rows += [B * cfg_kw["pred_len"]] * cfg_kw["d_layers"]
    return tuple((m, D, F) for m in rows)


def run_informer_serving(device, n_requests: int, seed: int, exp_dir: str) -> dict:
    """Phase 9a: the Informer experiment (INFORMER_CFG, seeded weights and
    BatchNorm running statistics) through ForecastService on the kernel
    route: launch counts exact (#2's eval form at 3 sites and #1 once a
    dispatch), every answer finite with its rows, one dispatch's batch
    kernels vs plain versions, one uncontended dispatch traced."""
    cfg = make_experiment(exp_dir, INFORMER_CFG, seed)
    svc = ForecastService(exp_dir, max_batch=64, max_wait_ms=5.0, device=device)
    try:
        bn = [b for n, b in svc.model.named_buffers() if n.endswith("running_var")]
        if not bn or any(bool((b == 1).any()) for b in bn):
            raise AssertionError("the service did not load the seeded BatchNorm statistics")
        n_sites = sum(isinstance(m, (EncoderLayer, DecoderLayer)) for m in svc.model.modules())
        requests = make_requests(cfg, n_requests, seed)
        d0 = svc.metrics()["dispatches_total"]
        zero_counts()
        t0 = time.monotonic()
        answers = serve_requests(svc, requests)
        wall = time.monotonic() - t0
        launches = read_counts()
        metrics = svc.metrics()
        dispatches = metrics["dispatches_total"] - d0
        want = ffn_counts("kernel", n_sites, 0, dispatches)
        if device.type == "cuda" and launches != want:
            raise AssertionError(f"serving Informer launched {launches}, expected {want}")
        for inst, ans in zip(requests, answers):
            y = np.asarray(ans["prediction"])
            if y.shape != (len(inst["tp_to_predict"]), cfg.input_dim) or not np.isfinite(y).all():
                raise AssertionError(f"bad answer shape {y.shape} or non-finite values")
        log(f"# served Informer: {len(requests)} requests in {dispatches} dispatches, "
            f"{wall:.3f} s: {len(requests) / wall:.1f} requests/s, dispatch p50 "
            f"{metrics['dispatch_latency_ms']['p50']} ms p95 "
            f"{metrics['dispatch_latency_ms']['p95']} ms; launches {launches}")

        built = [_build_chunk(r, cfg, svc.d_txt) for r in requests[:64]]
        batch = svc.to_device(svc._collate([b[0] for b in built]))
        rows, remove_hooks = ffn_site_rows(svc.model)
        with torch.inference_mode():
            got = svc._forward(batch)
            remove_hooks()
            set_kernels(svc, False)
            try:
                want_y = svc._forward(batch)
            finally:
                set_kernels(svc, True)
        err = max_err(got, want_y, SERVE_TOL)
        log(f"# Informer dispatch batch {tuple(batch['observed_data'].shape)}, FFN rows {rows}: "
            f"kernels vs plain max|err| {err:.3e}")
        profile = None
        if device.type == "cuda":
            profile = profile_dispatch(svc, built)
            log(f"# one uncontended Informer dispatch of 64 requests: {json.dumps(profile)}")
        return {"launches": launches, "dispatches": dispatches,
                "requests_per_s": len(requests) / wall,
                "dispatch_ms": metrics["dispatch_latency_ms"], "serve_err": err,
                "dispatch_profile": profile, "ffn_rows": rows}
    finally:
        svc.close()


def run_informer_training(device, root: str, exp_dir: str) -> dict:
    """Phase 9b: train the Informer preset at full width through
    imm_tsf_torch.main on the kernel route, then the plain route (exact
    launch counts), check that the trained checkpoint carries moved
    BatchNorm statistics, then one step held kernels vs plain vs float64
    (compare_fused_step)."""
    from imm_tsf_torch.training.checkpoint import load_weights

    data = training_data(root, INFORMER_TRAIN_ARGS)
    cfg = data["cfg"]
    n_val, n_test = len(data["val_dataloader"]), len(data["test_dataloader"])
    out = {"batches": {"train": len(data["train_dataloader"]), "val": n_val, "test": n_test},
           "widths": {k: getattr(cfg, k) for k in ("d_model", "d_ff", "n_heads", "e_layers",
                                                   "d_layers", "factor", "distil", "dropout",
                                                   "dropout_impl")},
           "routes": {}}
    log(f"# Informer training data: L {cfg.input_len}, Lp {cfg.pred_len}, batches "
        f"{out['batches']}, widths {out['widths']}")
    for route in ("kernel", "plain"):
        out["routes"][route] = train_route(
            device, INFORMER_TRAIN_ARGS + PATCH_ROUTES[route], root, exp_dir,
            f"Informer on the {route} route", n_val, n_test, cfg.early_stop_delta,
            lambda steps, evals: ffn_counts(route, cfg.e_layers + cfg.d_layers, steps, evals))
    saved = [load_weights(os.path.join(exp_dir, d, "best"))["model"]
             for d in sorted(os.listdir(exp_dir)) if d.startswith("experiment_")]
    var = [st["encoder.conv_layers.0.norm.running_var"] for st in saved]
    if not var or any(bool((v == 1).all()) for v in var):
        raise AssertionError("a trained Informer checkpoint lacks its moved BatchNorm statistics")
    out["step"] = compare_informer_step(device)
    return out


def run_default_pair(device, n_requests: int, seed: int, root: str, exp_dir: str) -> dict:
    """Phase 9c: DLinear + TTF_T2V_XAttn + MMF_XAttn_Add (the config's
    default fusion pair; no kernel runs): served on the card (no launch,
    finite answers, one dispatch against the same modules on the CPU),
    then trained two epochs through imm_tsf_torch.main."""
    cfg = make_experiment(exp_dir, DEFAULT_PAIR_CFG, seed)
    svc = ForecastService(exp_dir, max_batch=64, max_wait_ms=5.0, device=device)
    try:
        requests = make_requests(cfg, n_requests, seed)
        d0 = svc.metrics()["dispatches_total"]
        zero_counts()
        t0 = time.monotonic()
        answers = serve_requests(svc, requests)
        wall = time.monotonic() - t0
        launches = read_counts()
        if any(launches.values()):
            raise AssertionError(f"the default pair launched {launches}")
        for inst, ans in zip(requests, answers):
            y = np.asarray(ans["prediction"])
            if y.shape != (len(inst["tp_to_predict"]), cfg.input_dim) or not np.isfinite(y).all():
                raise AssertionError(f"bad answer shape {y.shape} or non-finite values")
        metrics = svc.metrics()
        out = svc._collate([_build_chunk(r, cfg, svc.d_txt)[0] for r in requests[:64]])
        cpu = torch.device("cpu")
        model, fusion = copy.deepcopy(svc.model).to(cpu), copy.deepcopy(svc.fusion).to(cpu)
        with torch.inference_mode():
            got = svc._forward(svc.to_device(out)).cpu()
            want = make_forward(svc.cfg, model, fusion)(to_device(out, cpu))
        err = max_err(got, want, SERVE_TOL)
        serving = {"dispatches": metrics["dispatches_total"] - d0,
                   "requests_per_s": len(requests) / wall,
                   "dispatch_ms": metrics["dispatch_latency_ms"], "card_vs_cpu_err": err}
        log(f"# served DLinear + TTF_T2V_XAttn + MMF_XAttn_Add: {json.dumps(serving)}")
    finally:
        svc.close()
    shutil.rmtree(exp_dir, ignore_errors=True)
    data = training_data(root, DEFAULT_PAIR_TRAIN_ARGS)
    train = train_route(device, DEFAULT_PAIR_TRAIN_ARGS, root, exp_dir,
                        "DLinear + TTF_T2V_XAttn + MMF_XAttn_Add", len(data["val_dataloader"]),
                        len(data["test_dataloader"]), data["cfg"].early_stop_delta,
                        lambda steps, evals: dict.fromkeys(KERNEL_COUNTS, 0))
    return {"serving": serving, "training": train}


# --------------------------------------------------------------- phase 10
def timellm_attn_shapes(cfg_kw: dict, B: int) -> tuple:
    """#3's [B, 12, T, 64] in TimeLLM's GPT-2 at a batch of B: T the fast
    prompt's 36 tokens (or the exact prompt's timellm_prompt_len) plus
    the patches of every channel."""
    cfg = Config(**cfg_kw)
    tokens = timellm.n_patches(cfg) * cfg.input_dim
    fast = timellm.N_PROMPT_TOKENS + timellm.N_STAT_TOKENS + tokens
    return ((B, 12, fast, 64), (B, 12, cfg.timellm_prompt_len + tokens, 64))


def attn_counts(route: str, layers: int, steps: int, evals: int) -> dict:
    """Launches of a TimeLLM run with fusion: on the kernel route #1 once a
    forward, #3 once a GPT-2 block a forward and its backward once a block
    a step; nothing on the plain route."""
    counts = dict.fromkeys(KERNEL_COUNTS, 0)
    if route == "kernel":
        counts.update(recency_weighted_average=steps + evals,
                      fused_causal_attention=layers * (steps + evals),
                      fused_causal_attention_backward=layers * steps)
    return counts


def serve_experiment(device, cfg_kw: dict | None, label: str, n_requests: int, seed: int,
                     exp_dir: str, expected, per_dispatch: int = 64,
                     profile_reps: int = 10) -> dict:
    """`label`'s experiment (cfg_kw, seeded weights; or, when cfg_kw is
    None, the trained experiment exp_dir holds) through ForecastService
    on the kernel route: ragged requests from 8 threads, every answer
    finite with its rows, launch counts exactly expected(svc, dispatches),
    #3's shapes recorded, one dispatch's batch (`per_dispatch` requests:
    a full batch, or the one request of a per-request service) kernels vs
    plain versions to SERVE_TOL, one uncontended dispatch traced
    (`profile_reps` dispatches a measure)."""
    cfg = (make_experiment(exp_dir, cfg_kw, seed) if cfg_kw is not None
           else load_saved_config(os.path.join(exp_dir, "config.json")))
    t0 = time.monotonic()
    svc = ForecastService(exp_dir, max_batch=64, max_wait_ms=5.0, device=device)
    up_s = time.monotonic() - t0
    log(f"# {label} service up in {up_s:.2f} s (includes one warmup dispatch)")
    try:
        requests = make_requests(cfg, n_requests, seed)
        d0 = svc.metrics()["dispatches_total"]
        zero_counts()
        attn.launches_by_shape = {}
        t0 = time.monotonic()
        answers = serve_requests(svc, requests)
        wall = time.monotonic() - t0
        launches = read_counts()
        metrics = svc.metrics()
        dispatches = metrics["dispatches_total"] - d0
        want = expected(svc, dispatches)
        if device.type == "cuda" and launches != want:
            raise AssertionError(f"serving {label} launched {launches}, expected {want}")
        for inst, ans in zip(requests, answers):
            y = np.asarray(ans["prediction"])
            if y.shape != (len(inst["tp_to_predict"]), cfg.input_dim) or not np.isfinite(y).all():
                raise AssertionError(f"{label}: bad answer shape {y.shape} or non-finite values")
        shapes = sorted(attn.launches_by_shape)
        log(f"# served {label}: {len(requests)} requests in {dispatches} dispatches, "
            f"{wall:.3f} s: {len(requests) / wall:.1f} requests/s, dispatch p50 "
            f"{metrics['dispatch_latency_ms']['p50']} ms p95 "
            f"{metrics['dispatch_latency_ms']['p95']} ms; launches {launches}; #3 at {shapes}")

        built = [_build_chunk(r, cfg, svc.d_txt) for r in requests[:per_dispatch]]
        batch = svc.to_device(svc._collate([b[0] for b in built]))
        with torch.inference_mode():
            got = svc._forward(batch)
            set_kernels(svc, False)
            try:
                want_y = svc._forward(batch)
            finally:
                set_kernels(svc, True)
        err = max_err(got, want_y, SERVE_TOL)
        log(f"# {label} dispatch batch {tuple(batch['observed_data'].shape)}: kernels vs "
            f"plain max|err| {err:.3e}")
        profile = None
        if device.type == "cuda":
            profile = profile_dispatch(svc, built, reps=profile_reps)
            log(f"# one uncontended {label} dispatch of {len(built)} requests: "
                f"{json.dumps(profile)}")
        return {"launches": launches, "dispatches": dispatches, "attn_shapes": shapes,
                "dispatch_batch": {k: list(v.shape) for k, v in batch.items()},
                "service_up_s": up_s, "requests_per_s": len(requests) / wall,
                "dispatch_ms": metrics["dispatch_latency_ms"], "serve_err": err,
                "dispatch_profile": profile}
    finally:
        svc.close()


def run_timellm_serving(device, n_requests: int, seed: int, exp_dir: str) -> dict:
    """Phase 10a: the TimeLLM experiment (TIMELLM_CFG) on the kernel route,
    #3 once a GPT-2 block and #1 once a dispatch, no backward."""
    return serve_experiment(device, TIMELLM_CFG, "TimeLLM", n_requests, seed, exp_dir,
                            lambda svc, dispatches: attn_counts(
                                "kernel", len(svc.model.frozen_llm.h), 0, dispatches))


def frozen_unchanged(cfg):
    """inspect(result) for train_route: the trained frozen GPT-2 equals,
    bit for bit, the one trainable() drew (torch.manual_seed(cfg.seed),
    then get_model)."""

    def check(res):
        torch.manual_seed(cfg.seed)
        drawn = get_model(cfg).frozen_llm.state_dict()
        trained = res["model"].frozen_llm.state_dict()
        moved = [k for k, v in drawn.items() if not torch.equal(trained[k].cpu(), v)]
        if moved or not drawn:
            raise AssertionError(f"training moved the frozen GPT-2: {moved[:3]}")

    return check


def run_timellm_training(device, root: str, exp_dir: str) -> dict:
    """Phase 10b and 10c: train TimeLLM + TTF_RecAvg + MMF_GR_Add through
    imm_tsf_torch.main (TIMELLM_TRAIN_ARGS: the presets, hash dropout 0.1,
    batch 32, two epochs) on the kernel route, the plain route, then the
    kernel route with the exact prompt; launch counts exact (#3 and its
    backward once a GPT-2 block a forward and a step), the frozen GPT-2
    unchanged; then one step held kernels vs plain vs float64
    (compare_timellm_step)."""
    out = {"routes": {}}
    for label, route, extra in (("kernel", "kernel", []), ("plain", "plain", []),
                                ("kernel, exact prompt", "kernel", EXACT_PROMPT)):
        args = TIMELLM_TRAIN_ARGS + ATTN_ROUTES[route] + extra
        data = training_data(root, args)
        cfg = data["cfg"]
        n_val, n_test = len(data["val_dataloader"]), len(data["test_dataloader"])
        attn.launches_by_shape = {}
        res = train_route(
            device, args, root, exp_dir, f"TimeLLM on the {label} route", n_val, n_test,
            cfg.early_stop_delta,
            lambda steps, evals: attn_counts(route, cfg.llm_layers_timellm, steps, evals),
            inspect=frozen_unchanged(cfg))
        res["attn_shapes"] = sorted(attn.launches_by_shape)
        out["routes"][label] = res
        out.setdefault("widths", {k: getattr(cfg, k) for k in (
            "d_model", "d_ff", "n_heads", "input_token_len", "stride", "llm_layers_timellm",
            "ts_vocab_size", "timellm_prompt_len", "dropout", "dropout_impl")})
        out.setdefault("batches", {"train": len(data["train_dataloader"]), "val": n_val,
                                   "test": n_test, "L": cfg.input_len, "Lp": cfg.pred_len})
        shutil.rmtree(exp_dir, ignore_errors=True)
    log(f"# TimeLLM training data: {out['batches']}, widths {out['widths']}")
    out["step"] = compare_timellm_step(device)
    return out


class pinned_lags(_Pinned):
    """Within the block, TimeLLM's fast prompt takes the first run's lags.
    They are the top_k of an autocorrelation whose pairs corr[k], corr[L -
    k] are equal in exact arithmetic, so float32 and float64 rank a pair
    by their rounding."""

    def __enter__(self):
        self.saved = timellm.top_lags
        timellm.top_lags = lambda corr, k: self.pinned(self.saved(corr, k))
        return self

    def __exit__(self, *exc):
        timellm.top_lags = self.saved


def compare_model_step(device, cfg, label: str, B: int, pin, expected, batch=None,
                       trace_reps: int = 3) -> dict:
    """One gradient step of `label`'s full-width experiment (cfg, hash
    dropout) from seeded weights on a batch of B windows at cfg's lengths,
    three ways under the same salts: the kernel route, the plain route and
    the plain route in float64, the later two with the float64 run's
    rounding-sensitive choices (`pin`, a _Pinned context; its flips are
    returned); `batch`, when given, replaces the headline batch. The losses agree to TRAIN_LOSS_RTOL, the gradients as
    held_grads holds them (parameters without a gradient are skipped: a
    frozen LLM's, which must take none, and TimeMixer's last block's finer
    scales, which feed no output), and the step's launch counts equal
    expected(route). Then one full step of each route (optimizer included)
    is traced (`trace_reps` steps)."""
    gen = torch.Generator().manual_seed(SEED)
    model, fusion = get_model(cfg), FusionModel(cfg)
    seeded_weights(model, gen)
    seeded_weights(fusion, gen)
    if batch is None:
        batch = headline_batch(cfg, B, torch.Generator().manual_seed(SEED + 1), device)

    def set_route(model, fusion, kernels):
        for m in model.modules():
            if isinstance(m, GPT2Block):
                m.use_fused_attn = kernels
        fusion.ttf.use_pallas = kernels

    def grads(model, fusion, batch, kernels):
        set_route(model, fusion, kernels)
        salts = torch.Generator().manual_seed(SEED)  # the same salts, so the same masks
        for m in [*model.modules(), *fusion.modules()]:
            if isinstance(m, Dropout):
                m.generator = salts
        model.zero_grad(set_to_none=True)
        fusion.zero_grad(set_to_none=True)
        loss = make_loss_fn(make_forward(cfg, model, fusion))(batch)
        loss.backward()
        named = [*model.named_parameters(), *fusion.named_parameters()]
        if any(p.grad is not None for n, p in named if FROZEN_SUBTREE in n.split(".")):
            raise AssertionError(f"{label}: the frozen LLM took a gradient")
        return float(loss.detach()), {n: p.grad.detach().clone() for n, p in named
                                      if p.grad is not None}

    # to the card first, then float64 there (TimeLLM's Llama is 7.4 GB in float32)
    model64, fusion64 = (copy.deepcopy(m).to(device).double().train() for m in (model, fusion))
    batch64 = {k: v.double() for k, v in batch.items()}
    with pin:
        loss64, g64 = grads(model64, fusion64, batch64, False)
        del model64, fusion64
        model, fusion = model.to(device).train(), fusion.to(device).train()
        pin.next_run()
        zero_counts()
        loss_p, g_p = grads(model, fusion, batch, False)
        plain_launches = read_counts()
        pin.next_run()
        zero_counts()
        loss_k, g_k = grads(model, fusion, batch, True)
        launches = read_counts()
    out = {"batch": {k: list(v.shape) for k, v in batch.items()}, "loss_float64": loss64,
           "loss_plain": loss_p, "loss_kernel": loss_k, "launches": launches,
           "pinned_flips": {"plain": pin.flips[0], "kernel": pin.flips[1],
                            "choices": sum(int(r.numel()) for r in pin.records)},
           "parameters": sum(int(g.numel()) for g in g64.values()),
           "without_gradient": sum(1 for _ in model.parameters()) + sum(
               1 for _ in fusion.parameters()) - len(g64)}
    for route, got in (("plain", plain_launches), ("kernel", launches)):
        if device.type == "cuda" and got != expected(route):
            raise AssertionError(f"one {label} step on the {route} route launched {got}, "
                                 f"expected {expected(route)}")
    if abs(loss_k - loss_p) > TRAIN_LOSS_RTOL * abs(loss_p):
        raise AssertionError(f"{label} step loss: kernel route {loss_k} vs plain {loss_p}")
    errs, plain_err, zero_err = held_grads(g_k, g_p, g64, f"{label} step")
    worst = max(errs, key=lambda n: errs[n] / (plain_err[n] + 1e-6))
    out.update(worst_grad={worst: (errs[worst], plain_err[worst])}, vanishing_grads=zero_err,
               largest_grad_err={"kernel": max(errs.values()), "plain": max(plain_err.values())})
    log(f"# one {label} step, seeded weights, B {B}: {json.dumps(out)}")

    if device.type == "cuda":  # one whole step of each route, optimizer included, traced
        params = trainable_parameters(model, fusion)
        step = make_grad_step(make_loss_fn(make_forward(cfg, model, fusion)),
                              make_optimizer(params, cfg.lr, cfg.w_decay), params)
        out["profile"] = {}
        for route in ("kernel", "plain"):
            set_route(model, fusion, route == "kernel")
            wall_ms(step, batch, reps=1, inference=False)  # warm
            step_ms = float(np.median(wall_ms(step, batch, reps=5, inference=False)))
            out["profile"][route] = {"step_ms": step_ms, **trace(
                lambda: step(batch), trace_reps, step_ms, inference=False)}
            log(f"# one traced {label} {route}-route training step: "
                f"{json.dumps(out['profile'][route])}")
    return out


def compare_timellm_step(device) -> dict:
    """Phase 10c's compared step: the full-width TimeLLM experiment
    (TIMELLM_CFG, hash dropout 0.1) at the trained shape (B 32, L 36, Lp
    36, C 8): #3 forward and backward once a GPT-2 block and #1 on the
    kernel route, the float64 run's lags on the others (pinned_lags)."""
    cfg = Config(**dict(TIMELLM_CFG, **TIMELLM_TRAINED, dropout=0.1))
    return compare_model_step(device, cfg, "TimeLLM", TIMELLM_STEP_B, pinned_lags(),
                              lambda route: attn_counts(route, cfg.llm_layers_timellm, 1, 0))


def run_raw_text_training(device, root: str, exp_dir: str) -> dict:
    """Phase 10d: PatchTST + TTF_RecAvg + MMF_GR_Add on raw-text notes
    (RAW_TEXT_TRAIN_ARGS: phase 8's run, the notes through the 6-block
    GPT-2 in the loader stage) on the attention kernel's route, then on the
    plain attention: every loss finite, #3 launched in the embedding stage
    (a multiple of the blocks, never backward) on the kernel route only,
    #1 once a forward on both, and the first epoch's losses of the two
    routes within RAW_TEXT_LOSS_RTOL."""
    data = training_data(root, RAW_TEXT_TRAIN_ARGS)
    cfg = data["cfg"]
    n_val, n_test = len(data["val_dataloader"]), len(data["test_dataloader"])
    out = {"batches": {"train": len(data["train_dataloader"]), "val": n_val, "test": n_test},
           "llm_layers": cfg.llm_layers_fusion, "routes": {}}
    for route, extra in RAW_TEXT_ROUTES.items():
        attn.launches_by_shape = {}
        res = train_route(
            device, RAW_TEXT_TRAIN_ARGS + extra, root, exp_dir,
            f"PatchTST on raw-text notes, {route} route", n_val, n_test, cfg.early_stop_delta,
            lambda steps, evals: dict(dict.fromkeys(KERNEL_COUNTS, 0),
                                      recency_weighted_average=steps + evals),
            free=("fused_causal_attention",))
        n = res["launches"]["fused_causal_attention"]
        if device.type == "cuda" and (route == "kernel") != (n > 0):
            raise AssertionError(f"raw-text training, {route} route: #3 launched {n} times")
        if n % cfg.llm_layers_fusion:
            raise AssertionError(f"#3 launched {n} times, not a multiple of the GPT-2 blocks")
        res["attn_launches_by_shape"] = [[list(k), c] for k, c in
                                         sorted(attn.launches_by_shape.items())]
        out["routes"][route] = res
        shutil.rmtree(exp_dir, ignore_errors=True)
    first = {r: res["step_losses"][:out["batches"]["train"]] for r, res in out["routes"].items()}
    k, p = (np.asarray(first[r]) for r in RAW_TEXT_ROUTES)
    gap = float((np.abs(k - p) / np.abs(p)).max())
    if not gap <= RAW_TEXT_LOSS_RTOL:
        raise AssertionError(f"raw-text training: the first epoch's losses differ by {gap:.3e} "
                             "between the attention routes")
    out["first_epoch_loss_gap"] = gap
    log(f"# raw-text training: #3 by shape on the kernel route "
        f"{out['routes']['kernel']['attn_launches_by_shape']}; first epoch's losses, kernel vs "
        f"plain attention, max relative gap {gap:.3e}")
    return out


# --------------------------------------------------------------- phase 11
def mts_cfg(model: str) -> dict:
    """Phase 11's served experiment of `model`: its preset at full width
    behind TTF_RecAvg + MMF_GR_Add, EPA-Air 48 + 24 steps (TTM's patch is
    history // 4, as apply_presets sets it)."""
    kw = dict(SERVE_CFG, model=model, **MODEL_PRESETS[model])
    if model == "TTM":
        kw["patch_size"] = kw["history"] // 4
    return kw


def recavg_only(steps: int, evals: int) -> dict:
    """Launches of a run whose only kernel is #1, once a forward."""
    return dict(dict.fromkeys(KERNEL_COUNTS, 0), recency_weighted_average=steps + evals)


def run_mts_serving(device, model: str, n_requests: int, seed: int, exp_dir: str) -> dict:
    """Phase 11a: `model`'s experiment (mts_cfg), #1 exactly once a dispatch
    and nothing else."""
    return serve_experiment(device, mts_cfg(model), model, n_requests, seed, exp_dir,
                            lambda svc, dispatches: recavg_only(0, dispatches))


def run_mts_training(device, root: str, exp_dir: str, model: str) -> dict:
    """Phase 11b and 11c: train `model` + TTF_RecAvg + MMF_GR_Add through
    imm_tsf_torch.main (MTS_TRAIN_ARGS: the presets, hash dropout 0.1, batch
    32, two epochs, #1 on), every loss finite and #1 exactly once a
    forward; then one step held kernels vs plain vs float64
    (compare_mts_step)."""
    data = training_data(root, MTS_TRAIN_ARGS[model])
    cfg = data["cfg"]
    n_val, n_test = len(data["val_dataloader"]), len(data["test_dataloader"])
    out = {"batches": {"train": len(data["train_dataloader"]), "val": n_val, "test": n_test,
                       "L": cfg.input_len, "Lp": cfg.pred_len},
           "widths": {k: getattr(cfg, k) for k in ("d_model", "d_ff", "e_layers", "d_layers",
                                                   "top_k", "patch_size", "stride",
                                                   "AP_levels", "d_d_model",
                                                   "down_sampling_layers", "dropout",
                                                   "dropout_impl")}}
    log(f"# {model} training data: {out['batches']}, widths {out['widths']}")
    out["kernel"] = train_route(device, MTS_TRAIN_ARGS[model], root, exp_dir,
                                f"{model} on the kernel route", n_val, n_test,
                                cfg.early_stop_delta, recavg_only)
    t0 = time.monotonic()
    out["step"] = compare_mts_step(device, model, dict(input_len=cfg.input_len,
                                                       pred_len=cfg.pred_len))
    out["step"]["wall_s"] = time.monotonic() - t0  # three routes and the traces
    return out


class pinned_periods(_Pinned):
    """Within the block, TimesNet's blocks take the first run's frequency
    bins: the top_k of mean FFT amplitudes, which float32 and float64 may
    rank differently where two are close."""

    def __enter__(self):
        self.saved = timesnet.top_lags
        timesnet.top_lags = lambda freq, k: self.pinned(self.saved(freq, k))
        return self

    def __exit__(self, *exc):
        timesnet.top_lags = self.saved


def compare_mts_step(device, model: str, trained: dict) -> dict:
    """Phase 11c's compared step: `model`'s experiment (mts_cfg at the
    trained lengths, hash dropout 0.1) at B MTS_STEP_B, #1 once on the
    kernel route, TimesNet's bins the float64 run's (pinned_periods)."""
    cfg = Config(**dict(mts_cfg(model), **trained, dropout=0.1))
    return compare_model_step(device, cfg, model, MTS_STEP_B, pinned_periods(),
                              lambda route: recavg_only(int(route == "kernel"), 0))


def nondeterministic_ops(device) -> list[str]:
    """What torch's deterministic mode (warn_only) reports over one PatchTST
    kernel-route training step (SERVE_CFG, hash dropout 0.1, B 32): the ops
    whose results may change from run to run, such as atomic adds; each
    message once, cut to 160 characters."""
    import warnings

    cfg = Config(**dict(SERVE_CFG, dropout=0.1))
    torch.manual_seed(SEED)
    net, fusion = get_model(cfg).to(device).train(), FusionModel(cfg).to(device).train()
    batch = headline_batch(cfg, MTS_STEP_B, torch.Generator().manual_seed(SEED + 1), device)
    params = trainable_parameters(net, fusion)
    step = make_grad_step(make_loss_fn(make_forward(cfg, net, fusion)),
                          make_optimizer(params, cfg.lr, cfg.w_decay), params)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            step(batch)
            if device.type == "cuda":
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message)[:160] for w in caught})


def run_resume(device, root: str, exp_dir: str, uninterrupted: dict, weights: dict,
               args=RESUME_ARGS + STREAM, expected=None, label: str = "resume",
               strict: bool = False, stopped: str | None = None, total: int = 2) -> dict:
    """Phase 11d: phase 8's kernel route (#1, #2's training form, hash
    salts) as experiment "resume": `--load resume --epoch 1` (no state yet:
    it trains from scratch and saves epoch 0's), then `--load resume --epoch
    2` (resumes at epoch 1). Each epoch's launches are exact. The per-step
    losses, val MSEs, test metrics and final weights must equal phase 8's
    uninterrupted two epochs (`uninterrupted`, `weights`) bit for bit;
    where they do not, the ops that torch's deterministic mode names
    (nondeterministic_ops) must explain it and every gap stay within
    RESUME_RTOL, else the phase fails. Phase 12d passes the LatentODE's run
    (`args`, its launch counts `expected(steps, evals)`) with `strict`: bit
    for bit or the phase fails (no PatchTST step is probed then), and
    `stopped`, the uninterrupted run's experiment directory: its epoch-0
    train state stands for a run stopped after one epoch (the same seed and
    flags write the same state), so only the resumed epoch is trained.
    Phase 14e passes the default epoch loop's `args` and `total` 3: one
    epoch, then `--load resume --epoch 3`."""
    data = training_data(root, args)
    cfg = data["cfg"]
    n_val, n_test = len(data["val_dataloader"]), len(data["test_dataloader"])
    runs = []
    if stopped is not None:
        exp = os.path.join(exp_dir, "experiment_resume")
        shutil.copytree(stopped, exp)
        os.remove(os.path.join(exp, "train_state_1.pt"))
        runs.append({"epochs": [0], "copied_from": "the uninterrupted run's epoch-0 state",
                     "wall_s": 0.0, "launches": dict.fromkeys(KERNEL_COUNTS, 0)})
    for epochs in (1, total)[len(runs):]:
        zero_counts()
        t0 = time.monotonic()
        res = train_main.main(list(args) + ["--epoch", str(epochs), "--data_root", root,
                                            "--save", exp_dir, "--device", device.type])
        wall = time.monotonic() - t0
        launches = read_counts()
        start = 0 if epochs == 1 else 1  # the epochs this run trained
        best, steps, evals = np.inf, 0, 0
        for h in res["history"]:
            improved = best - h["val"]["mse"] > cfg.early_stop_delta
            best = h["val"]["mse"] if improved else best
            if h["epoch"] >= start:
                steps += len(h["step_losses"])
                evals += n_val + (n_test if improved else 0)
        want = (ffn_counts("kernel", cfg.e_layers, steps, evals)
                if expected is None else expected(steps, evals))
        if device.type == "cuda" and launches != want:
            raise AssertionError(f"{label} run {epochs} launched {launches}, expected {want}")
        runs.append({"epochs": [x["epoch"] for x in res["history"]], "wall_s": wall,
                     "launches": launches})
    exp = os.path.join(exp_dir, "experiment_resume")
    states = sorted(f for f in os.listdir(exp) if f.startswith("train_state_"))
    if runs[0]["epochs"] != [0] or runs[1]["epochs"] != list(range(total)) or states != [
            f"train_state_{total - 2}.pt", f"train_state_{total - 1}.pt"]:
        raise AssertionError(f"{label}: epochs {[r['epochs'] for r in runs]}, states {states}")
    hist = res["history"]
    got = {"step_losses": [x for h in hist for x in h["step_losses"]],
           "val_mse": [h["val"]["mse"] for h in hist],
           "test": [res[k] for k in ("mse", "mae", "rmse")] + [res["best_iter"]]}
    want = {"step_losses": uninterrupted["step_losses"],
            "val_mse": [e["val_mse"] for e in uninterrupted["epochs"]],
            "test": [uninterrupted["test"][k] for k in ("mse", "mae", "rmse", "best_iter")]}
    mine = final_weights(res)
    gaps = {k: float(np.max(np.abs(np.subtract(got[k], want[k])) / np.maximum(
        np.abs(want[k]), 1e-30))) for k in got}
    moved = {f"{mod}.{n}": float(((v - weights[mod][n]).abs().max()
                                  / weights[mod][n].abs().max().clamp(min=1e-30)))
             for mod in weights for n, v in mine[mod].items()
             if not torch.equal(v, weights[mod][n])}
    bitwise = not moved and all(g == 0.0 for g in gaps.values())
    ops = [] if strict else nondeterministic_ops(device)
    out = {"runs": runs, "bitwise": bitwise, "gaps": gaps, "weights_moved": len(moved),
           "largest_weight_gap": max(moved.values(), default=0.0),
           "nondeterministic_ops": ops}
    log(f"# {label} on the card: {json.dumps(out)}")
    if not bitwise:
        # cuBLAS's own notice (a workspace setting for several streams) names no op
        named = [m for m in ops if "CuBLAS" not in m]
        worst = max([*gaps.values(), out["largest_weight_gap"]])
        if strict or not named or worst > RESUME_RTOL:
            raise AssertionError(f"the resumed run differs from the uninterrupted one: gaps "
                                 f"{gaps}, {len(moved)} weights (largest {worst:.3e}); ops "
                                 f"with atomics named: {named}")
        log(f"# resume within {RESUME_RTOL} relative, not bitwise: ops with atomics {named}")
    return out


# --------------------------------------------------------------- phase 12
def imts_cfg(model: str) -> dict:
    """Phase 12's served experiment of `model`: its preset behind TTF_RecAvg
    + MMF_GR_Add, EPA-Air 48 + 24 steps; tPatchGNN patched as
    SERVED_PATCHING."""
    kw = dict(SERVE_CFG, model=model, **MODEL_PRESETS[model])
    if model == "tPatchGNN":
        kw.update(SERVED_PATCHING)
    return kw


def patches_with_points(batch) -> int:
    """How many of a patch-collated batch's patches hold a point."""
    mask = batch["observed_mask"]
    return int((mask.reshape(mask.shape[0], mask.shape[1], -1).sum(-1) > 0).any(0).sum())


def imts_batch(cfg, B: int, seed: int, device) -> dict:
    """A training batch of B ragged requests whose times lie on one grid of
    input_len observed and pred_len forecast points (a regularly sampled
    deployment: the LatentODE's union axes stay within 48 + 24) through the
    service's collate for cfg's model (the patch or ODE collate, or the
    standard one), the forecast targets N(0, 1) where the mask holds one."""
    from imm_tsf_torch.serving import collate_chunks

    chunks = [_build_chunk(r, cfg, cfg.d_txt)[0]
              for r in make_requests(cfg, B, seed, oversample=1)]
    out = collate_chunks(cfg, chunks, cfg.d_txt, float(cfg.history + cfg.pred_window), B)
    pmask = out["mask_predicted_data"]
    out["data_to_predict"] = (np.random.default_rng(seed).standard_normal(pmask.shape)
                              .astype(np.float32) * pmask)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()
            if isinstance(v, np.ndarray)}


class pinned_z0(_Pinned):
    """Within the block, the LatentODE's and NeuralFlow's train-mode z0
    noise is one fixed N(0, 1) draw (seeded, on the host), cast to each
    run's dtype: the float64 run takes the same numbers."""

    def __enter__(self):
        from imm_tsf_torch.ode import nets

        self.nets, self.saved = nets, nets.train_eps
        draw = lambda shape: torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 2))
        nets.train_eps = lambda shape, like, generator: draw(tuple(shape)).to(like.device,
                                                                             like.dtype)
        return self

    def __exit__(self, *exc):
        self.nets.train_eps = self.saved


def ode_drift_case():
    """Phase 12e's long scan: the preset LatentODE in eval mode, its weights
    drawn on the host (seeded_weights, SEED + 13), and an ODE-collated
    batch of the trained run's shape: 32 windows of 7 + 7 days, each 45
    irregular times (8 features, about a third observed), whose union axes
    hold 719 + 721 real times in buckets of 768 + 768. Made from a seed,
    so the card and the CPU hold the same numbers. Returns (model, args),
    args the forward's four tensors on the host."""
    from imm_tsf_torch.data import collate as C
    from imm_tsf_torch.data.dataset import Chunk

    rng = np.random.default_rng(SEED + 13)
    chunks = []
    for b in range(32):
        tt = np.unique(rng.uniform(0, 14, 45)).astype(np.float32)
        mask = (rng.random((len(tt), 8)) < 0.35).astype(np.float32)
        vals = rng.standard_normal((len(tt), 8)).astype(np.float32) * mask
        chunks.append(Chunk(f"w{b}_chunk0", tt, vals, mask, np.zeros(0, np.float32), []))
    out = C.ode_collate(chunks, 7.0, 14.0)
    model = get_model(Config(**dict(MODEL_PRESETS["LatentODE"], model="LatentODE",
                                    input_dim=8)))
    seeded_weights(model, torch.Generator().manual_seed(SEED + 13))
    return model.eval(), tuple(torch.from_numpy(out[k]) for k in (
        "tp_to_predict", "observed_data", "observed_tp", "observed_mask"))


def check_ode_drift(device) -> dict:
    """Phase 12e: the LatentODE's float32 forward on the card over a union
    axis of the trained length (ode_drift_case) against its float64 run on
    the card, within ODE_DRIFT_MAX."""
    model, args = ode_drift_case()
    m64 = copy.deepcopy(model).double().to(device)
    model.to(device)
    with torch.inference_mode():
        got = model(*(a.to(device) for a in args))
        want = m64(*(a.to(device, torch.float64) for a in args))
    out = {"union": list(args[2].shape) + list(args[0].shape),
           "max_abs_from_float64": float((got.double() - want).abs().max()),
           "largest_float64": float(want.abs().max()),
           "jax_cpu_from_float64": ODE_DRIFT_JAX, "bound": ODE_DRIFT_MAX}
    log(f"# LatentODE over the trained union axis, float32 vs float64 on the card: "
        f"{json.dumps(out)}")
    if not torch.isfinite(got).all() or not out["max_abs_from_float64"] <= ODE_DRIFT_MAX:
        raise AssertionError(f"the LatentODE's float32 scan drifts {out['max_abs_from_float64']} "
                             f"from float64, past {ODE_DRIFT_MAX}")
    return out


def check_recavg_ode(device, shapes) -> dict:
    """#1 at the LatentODE's trained union shapes (B, N, T, d) with the ODE
    collate's 1-D t_hat, expanded as TTF_RecAvg expands it (a stride-0
    view; the wrapper makes it contiguous), against its plain version."""
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    errs = {}
    for B, N, T, d in shapes:
        tau, t_hat, V, mask, sigma = recavg_inputs(B, N, T, d, gen, device)
        t_hat = torch.sort(t_hat[0]).values[None].expand(B, -1)
        got = recavg.recency_weighted_average(tau, t_hat, V, mask, sigma)
        want = recavg.recavg_reference(tau, t_hat, V, mask, sigma)
        errs[str((B, N, T, d))] = max_err(got, want, RECAVG_TOL)
    log(f"# check recavg at the LatentODE's trained union shapes, 1-D t_hat: max|err| "
        f"{json.dumps(errs)}")
    return errs


def run_imts_serving(device, model: str, n_requests: int, seed: int, exp_dir: str) -> dict:
    """Phase 12a: `model`'s experiment (imts_cfg) on the kernel route, #1
    exactly once a dispatch and nothing else; the LatentODE a request a
    dispatch (its compared and traced dispatch is one request, traced
    three times)."""
    cfg = Config(**imts_cfg(model))
    ode = model == "LatentODE"  # ~14,000 launches a dispatch: fewer traced
    out = serve_experiment(device, imts_cfg(model), model, n_requests, seed, exp_dir,
                           lambda svc, dispatches: recavg_only(0, dispatches),
                           per_dispatch=1 if ode else 64, profile_reps=3 if ode else 10)
    if model == "LatentODE" and out["dispatches"] != n_requests:
        raise AssertionError(f"the LatentODE served {n_requests} requests in "
                             f"{out['dispatches']} dispatches, not one a request")
    if model == "tPatchGNN":
        batch = imts_batch(cfg, 64, seed, torch.device("cpu"))
        out["patching"] = {"npatch": cfg.npatch, "patch_size": cfg.patch_size,
                           "patches_with_points": patches_with_points(batch)}
        log(f"# tPatchGNN served patching: {out['patching']}")
        if out["patching"]["patches_with_points"] < 3:
            raise AssertionError(f"tPatchGNN served {out['patching']}: fewer than 3 patches "
                                 "hold points")
    return out


def run_imts_training(device, root: str, exp_dir: str, model: str, kept: dict) -> dict:
    """Phase 12b and 12c: train `model` + TTF_RecAvg + MMF_GR_Add through
    imm_tsf_torch.main (IMTS_TRAIN_ARGS: the presets, hash dropout 0.1,
    batch 32, two epochs, #1 on), every loss finite and #1 exactly once a
    forward (tPatchGNN's npatch the reference's derivation from the flags
    before the presets, printed with the patches that hold points); then
    one step held kernels vs plain vs float64 under one pinned z0 noise
    (compare_imts_step). `kept` gets the LatentODE's run, final weights and
    a copy of its experiment directory (`dir`, the caller removes it), for
    phase 12d, and #1's trained shapes."""
    data = training_data(root, IMTS_TRAIN_ARGS[model])
    cfg = data["cfg"]
    n_val, n_test = len(data["val_dataloader"]), len(data["test_dataloader"])
    first = next(iter(data["train_dataloader"]))
    out = {"batches": {"train": len(data["train_dataloader"]), "val": n_val, "test": n_test,
                       "L": cfg.input_len, "Lp": cfg.pred_len,
                       "first_batch": {k: list(v.shape) for k, v in first.items()
                                       if isinstance(v, np.ndarray)}}}
    if model == "tPatchGNN":
        out["patching"] = {"npatch": cfg.npatch, "patch_size": cfg.patch_size,
                           "patch_stride": cfg.patch_stride,
                           "patches_with_points": patches_with_points(first)}
    if model == "LatentODE":
        # the union prediction axes #1 sees in training, evaluation included
        kept["recavg_shapes"] = sorted({
            (cfg.batch_size, b["notes_embeddings"].shape[1], b["tp_to_predict"].shape[0],
             b["notes_embeddings"].shape[2])
            for split in ("train_dataloader", "val_dataloader", "test_dataloader")
            for b in (data[split] or [])})
        out["recavg_shapes"] = kept["recavg_shapes"]
    log(f"# {model} training data: {json.dumps(out)}")
    keep = (lambda res: kept.update(weights=final_weights(res))) if model == "LatentODE" else None
    out["kernel"] = train_route(device, IMTS_TRAIN_ARGS[model], root, exp_dir,
                                f"{model} on the kernel route", n_val, n_test,
                                cfg.early_stop_delta, recavg_only, inspect=keep)
    if model == "LatentODE":  # the run and its experiment directory, for phase 12d
        kept["run"] = out["kernel"]
        (name,) = [d for d in os.listdir(exp_dir) if d.startswith("experiment_")]
        kept["dir"] = exp_dir + "_latent_ode_run"
        shutil.copytree(os.path.join(exp_dir, name), kept["dir"])
    t0 = time.monotonic()
    out["step"] = compare_imts_step(device, model)
    out["step"]["wall_s"] = time.monotonic() - t0  # three routes and the traces
    return out


def compare_imts_step(device, model: str) -> dict:
    """Phase 12c's compared step: `model`'s served experiment (imts_cfg,
    hash dropout 0.1) on IMTS_STEP_B requests through the service's
    collate (imts_batch), #1 once on the kernel route, the z0 noise pinned
    (pinned_z0); the LatentODE's ~41,000-launch step traced once."""
    cfg = Config(**dict(imts_cfg(model), dropout=0.1))
    batch = imts_batch(cfg, IMTS_STEP_B, SEED + 1, device)
    return compare_model_step(device, cfg, model, IMTS_STEP_B, pinned_z0(),
                              lambda route: recavg_only(int(route == "kernel"), 0), batch=batch,
                              trace_reps=1 if model == "LatentODE" else 3)


# --------------------------------------------------------------- phase 13
def llm_text_cfg(alias: str) -> dict:
    """Phase 4b's raw-text experiment with `alias` as the fusion LLM (6
    layers at full width), BERT at its 512 tokens (resolve_max_length)."""
    return dict(TEXT_CFG, llm_model_fusion=alias, max_length=512 if alias == "BERT" else 1024)


def pooled_notes(model, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
    """[rows, T] ids and bool mask -> the masked mean of the last hidden
    state in the model's own dtype (embed_notes pools the same way, in
    float32)."""
    dev = model.word_embedding_table().device
    m = torch.from_numpy(mask).to(dev)
    with torch.inference_mode():
        h = model(input_ids=torch.from_numpy(ids).to(dev), attn_mask=m)
        mf = m[:, :, None].to(h.dtype)
        return (h * mf).sum(1) / mf.sum(1).clamp(min=1e-6)


def llm_drift_case(alias: str):
    """Phase 13a's drift case: `alias` at full width and LLM_DRIFT_LAYERS
    layers, its vocab cut to LLM_DRIFT_VOCAB (only the lookup reads it),
    drawn on the host in the loader's families from SEED + 14, and one
    bucket call of LLM_DRIFT_ROWS right-padded notes (1-LLM_DRIFT_TOKENS
    real tokens, one full). Made from a seed, so the card and the CPU hold
    the same numbers. Returns (model in eval mode, int64 ids, bool mask)."""
    from imm_tsf_torch.llm import bert, llama

    with torch.device("meta"):
        if alias == "BERT":
            model = bert.BertModel(dataclasses.replace(bert.BertConfig(),
                                                       vocab_size=LLM_DRIFT_VOCAB),
                                   n_layers=LLM_DRIFT_LAYERS)
        else:
            model = llama.LlamaModel(dataclasses.replace(llama.LLAMA_SIZES[alias],
                                                         vocab_size=LLM_DRIFT_VOCAB),
                                     n_layers=LLM_DRIFT_LAYERS)
    model = model.to_empty(device="cpu")
    init_ = llm_loader._flax_init_ if alias == "BERT" else llm_loader._llama_init_
    init_(model, torch.Generator().manual_seed(SEED + 14))
    rng = np.random.default_rng(SEED + 14)
    lengths = rng.integers(1, LLM_DRIFT_TOKENS + 1, LLM_DRIFT_ROWS)
    lengths[0] = LLM_DRIFT_TOKENS
    mask = np.arange(LLM_DRIFT_TOKENS)[None] < lengths[:, None]
    ids = np.where(mask, rng.integers(1, LLM_DRIFT_VOCAB, mask.shape), 0).astype(np.int64)
    return model.eval().requires_grad_(False), ids, mask


def check_llm_drift(device, alias: str) -> dict:
    """Phase 13a: llm_drift_case(alias)'s pooled notes in float32 on the
    card against its float64 run on the card, within LLM_DRIFT_MAX."""
    model, ids, mask = llm_drift_case(alias)
    model.to(device)
    m64 = copy.deepcopy(model).double()
    got, want = pooled_notes(model, ids, mask), pooled_notes(m64, ids, mask)
    out = {"rows": LLM_DRIFT_ROWS, "tokens": LLM_DRIFT_TOKENS, "layers": LLM_DRIFT_LAYERS,
           "max_abs_from_float64": float((got.double() - want).abs().max()),
           "largest_float64": float(want.abs().max()),
           "jax_cpu_from_float64": LLM_DRIFT_JAX[alias], "bound": LLM_DRIFT_MAX[alias]}
    log(f"# {alias}'s pooled notes, float32 vs float64 on the card: {json.dumps(out)}")
    if not torch.isfinite(got).all() or not out["max_abs_from_float64"] <= LLM_DRIFT_MAX[alias]:
        raise AssertionError(f"{alias}'s float32 notes drift {out['max_abs_from_float64']} "
                             f"from float64, past {LLM_DRIFT_MAX[alias]}")
    return out


def peak_gb(device) -> float | None:
    """Peak device memory (GB) since the last call, then reset; None off
    the card."""
    if device.type != "cuda":
        return None
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    torch.cuda.reset_peak_memory_stats(device)
    return peak


def bf16_gap(got: np.ndarray, want: np.ndarray, label: str) -> float:
    """max |bf16 - fp32| over the fp32 run's largest entry; past LLM_BF16_RTOL
    the phase fails (tests/test_llm_stack.py:128's tolerance)."""
    gap = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    if not (np.isfinite(got).all() and gap <= LLM_BF16_RTOL):
        raise AssertionError(f"{label}: bfloat16 is {gap:.3e} x scale from float32")
    return gap


def run_llm_serving(device, alias: str, n_requests: int, seed: int, exp_dir: str) -> dict:
    """Phase 13a: phase 4b's experiment with `alias` as its fusion LLM
    (llm_text_cfg: 6 layers at full width, drawn on the card): ragged
    raw-text requests from 8 threads (TextNotes, every bucket up to
    max_length), every answer finite with its rows, #1 once and #2 once an
    encoder layer a dispatch, #3 never; one dispatch's batch kernels vs
    plain to SERVE_TOL; that dispatch's notes through the LLM in float32
    and bfloat16 (embed_notes' compute_dtype), timed in turns (real
    tokens/s) and held to LLM_BF16_RTOL; the drift case against float64
    (check_llm_drift)."""
    cfg = make_experiment(exp_dir, llm_text_cfg(alias), seed)
    t0 = time.monotonic()
    svc = ForecastService(exp_dir, max_batch=64, max_wait_ms=5.0, device=device)
    up_s = time.monotonic() - t0
    log(f"# {alias} raw-text service up in {up_s:.2f} s ({alias} init on the card and one "
        f"warmup dispatch)")
    try:
        stage = svc._stage_top
        llm, tok = stage.llm, stage.tokenizer
        requests = make_requests(cfg, n_requests, seed, note=TextNotes())
        d0, calls0 = svc.metrics()["dispatches_total"], stage.llm_calls
        zero_counts()
        peak_gb(device)
        t0 = time.monotonic()
        answers = serve_requests(svc, requests)
        wall = time.monotonic() - t0
        launches = read_counts()
        serving_peak = peak_gb(device)
        metrics = svc.metrics()
        dispatches = metrics["dispatches_total"] - d0
        want = ffn_counts("kernel", cfg.e_layers, 0, dispatches)
        if device.type == "cuda" and launches != want:
            raise AssertionError(f"serving raw text through {alias} launched {launches}, "
                                 f"expected {want}")
        for inst, ans in zip(requests, answers):
            y = np.asarray(ans["prediction"])
            if y.shape != (len(inst["tp_to_predict"]), cfg.input_dim) or not np.isfinite(y).all():
                raise AssertionError(f"{alias}: bad answer shape {y.shape} or non-finite values")
        texts = [n["text"] for r in requests for n in r["notes"]]
        run_tokens = int(tok(sorted(set(texts)), max_length=cfg.max_length)[1].sum())
        log(f"# served {len(requests)} raw-text requests through {alias} ({len(texts)} notes, "
            f"{run_tokens} real tokens in distinct strings) in {dispatches} dispatches and "
            f"{stage.llm_calls - calls0} LLM calls, {wall:.3f} s: "
            f"{len(requests) / wall:.1f} requests/s, dispatch p50 "
            f"{metrics['dispatch_latency_ms']['p50']} ms p95 "
            f"{metrics['dispatch_latency_ms']['p95']} ms; launches {launches}; peak device "
            f"memory {serving_peak} GB")

        built = [_build_chunk(r, cfg, svc.d_txt) for r in requests[:64]]
        batch = svc.to_device(svc._collate([b[0] for b in built]))
        with torch.inference_mode():
            got = svc._forward(batch)
            set_kernels(svc, False)
            try:
                want_y = svc._forward(batch)
            finally:
                set_kernels(svc, True)
        err = max_err(got, want_y, SERVE_TOL)
        log(f"# {alias} dispatch batch {tuple(batch['observed_data'].shape)} notes "
            f"{tuple(batch['notes_embeddings'].shape)}: kernels vs plain max|err| {err:.3e}")

        notes = [[n["text"] for n in r["notes"]] for r in requests[:64]]
        stats: dict = {}
        dtypes = {"float32": None, "bfloat16": torch.bfloat16}
        embed = {k: (lambda dt=dt: embed_notes(notes, llm, tok, max_length=cfg.max_length,
                                               stats_out=stats, compute_dtype=dt)[0])
                 for k, dt in dtypes.items()}
        pooled = {k: fn() for k, fn in embed.items()}  # warms both
        gap = bf16_gap(pooled["bfloat16"], pooled["float32"], f"{alias}'s notes")
        embed_ms: dict = {}
        if device.type == "cuda":
            for k in ("float32", "bfloat16", "bfloat16", "float32"):  # in turns
                embed_ms.setdefault(k, []).extend(wall_ms(embed[k], reps=1))
            embed_ms = {k: float(np.median(v)) for k, v in embed_ms.items()}
        llm_loader._CAST.pop(llm, None)  # the bfloat16 copy
        notes_out = {"notes": stats["n_notes"], "real_tokens": stats["real_tokens"],
                     "processed_tokens": stats["processed_tokens"], "bf16_gap": gap,
                     "ms": embed_ms, "real_tokens_per_s": {
                         k: stats["real_tokens"] / (v / 1e3) for k, v in embed_ms.items()}}
        log(f"# one dispatch's notes through {alias}, float32 and bfloat16: "
            f"{json.dumps(notes_out)}")
        return {"launches": launches, "dispatches": dispatches, "service_up_s": up_s,
                "requests_per_s": len(requests) / wall, "wall_s": wall, "peak_gb": serving_peak,
                "run_real_tokens": run_tokens, "dispatch_ms": metrics["dispatch_latency_ms"],
                "serve_err": err, "embed": notes_out, "drift": check_llm_drift(device, alias)}
    finally:
        svc.close()


def timed_forward(model, ids: np.ndarray, mask: np.ndarray) -> dict:
    """One pooled forward (the embed_notes call) from a reset peak: its
    host ms to synchronize, real tokens/s and peak device memory; an
    out-of-memory error is reported, not raised."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = llm_loader._pooled_forward(model, ids, mask)
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        return {"out_of_memory": str(e).splitlines()[0],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    ms = (time.perf_counter() - t0) * 1e3
    if not torch.isfinite(out).all():
        raise AssertionError("a pooled forward gave non-finite notes")
    return {"ms": ms, "real_tokens_per_s": float(mask.sum()) / (ms / 1e3),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def run_llm_memory(device) -> dict:
    """Phase 13b: one embed_notes bucket call of LLM_BUCKET_CALL (64 rows
    of 1024 real tokens, the token budget) through the 6-layer Llama, then
    one short-note call (LLM_SHORT_CALL) through the full 32-layer
    Llama-3.1-8B (7.50 B parameters, drawn on the card), each in float32
    and then with the model cast to bfloat16 in place; peak device memory
    and real tokens/s of each (timed_forward)."""
    rng = np.random.default_rng(SEED + 15)
    out = {}
    for label, layers, (rows, T) in (("6 layers, bucket 1024", 6, LLM_BUCKET_CALL),
                                     ("32 layers, short notes", None, LLM_SHORT_CALL)):
        t0 = time.monotonic()
        model, _ = llm_loader.load_llm("Llama", layers, device=device)
        drawn_s = time.monotonic() - t0
        ids = rng.integers(1, model.cfg.vocab_size, (rows, T))
        mask = np.ones((rows, T), bool)
        llm_loader._pooled_forward(model, ids[:1, :32], mask[:1, :32])  # warm
        res = {"layers": len(model.layers), "rows": rows, "tokens": T, "drawn_s": drawn_s,
               "parameters": sum(p.numel() for p in model.parameters()),
               "float32": timed_forward(model, ids, mask)}
        model.to(torch.bfloat16)
        res["bfloat16"] = timed_forward(model, ids, mask)
        del model
        torch.cuda.empty_cache()
        log(f"# Llama, {label}: {json.dumps(res)}")
        out[label] = res
    return out


def stage_steady_rate(lines: str) -> float | None:
    """The steady real tokens/s the stage printed (None after one entity)."""
    m = re.search(r"steady-state: (\d+) tokens/sec", lines)
    return float(m.group(1)) if m else None


def run_embed_stage(device, root: str, exp_dir: str) -> dict:
    """Phase 13c: `python -m imm_tsf_torch.compute_text_embeddings`'s
    function on phase 7's fixture with the 6-layer Llama, in float32 and,
    on a copy, in bfloat16 (each printing its steady real tokens/s); every
    bfloat16 artifact within LLM_BF16_RTOL of the float32 one, the same
    rel times; then PatchTST + TTF_RecAvg + MMF_GR_Add trained on the
    float32 artifacts (STAGE_TRAIN_ARGS: 4096-wide notes into d_txt 768,
    two epochs on the kernel route), #1 and #2 exact, the notes' width
    held by the trained input_proj."""
    out: dict = {"artifacts": {}}
    copy_root = root + "_bf16"
    shutil.copytree(root, copy_root)
    try:
        for dtype, where in (("float32", root), ("bfloat16", copy_root)):
            buf = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                embed_stage.compute_text_embeddings(
                    "EPA-Air", "Llama", 6, 1024, where, overwrite=True, embed_dtype=dtype,
                    device=device)
            printed = buf.getvalue()
            out[dtype] = {"wall_s": time.monotonic() - t0,
                          "steady_tokens_per_s": stage_steady_rate(printed),
                          "printed": printed.strip().splitlines()[-1]}
            log(f"# the embedding stage, Llama 6 layers, {dtype}: {json.dumps(out[dtype])}")
        fname = embeddings_filename("Llama", 6, 1024)
        proc = os.path.join(root, "EPA-Air", "processed")
        gaps, notes = [], 0
        for rec in sorted(os.listdir(proc)):
            a = torch.load(os.path.join(proc, rec, fname), weights_only=False)
            b = torch.load(os.path.join(copy_root, "EPA-Air", "processed", rec, fname),
                           weights_only=False)
            if not torch.equal(a["rel_times"], b["rel_times"]):
                raise AssertionError(f"{rec}: the bfloat16 stage's rel times differ")
            gaps.append(bf16_gap(b["embeddings"].numpy(), a["embeddings"].numpy(), rec))
            notes += a["embeddings"].shape[0]
        out["artifacts"] = {"entities": len(gaps), "notes": notes,
                            "width": int(a["embeddings"].shape[1]), "bf16_gap": max(gaps)}
        log(f"# the stage's artifacts: {json.dumps(out['artifacts'])}")
    finally:
        shutil.rmtree(copy_root, ignore_errors=True)
    data = training_data(root, STAGE_TRAIN_ARGS)
    cfg = data["cfg"]
    widths: dict = {}
    out["training"] = train_route(
        device, STAGE_TRAIN_ARGS, root, exp_dir, "PatchTST on the stage's Llama notes",
        len(data["val_dataloader"]), len(data["test_dataloader"]), cfg.early_stop_delta,
        lambda steps, evals: ffn_counts("kernel", cfg.e_layers, steps, evals),
        inspect=lambda res: widths.update(
            input_proj=list(res["fusion"].ttf.input_proj.weight.shape)))
    if widths["input_proj"] != [cfg.d_txt, get_d_model("Llama")]:
        raise AssertionError(f"trained input_proj {widths['input_proj']}: not 4096 -> d_txt")
    out["training"]["input_proj"] = widths["input_proj"]
    return out


def timellm_llm_train_args(name: str, epochs: int) -> list[str]:
    """TIMELLM_TRAIN_ARGS with `name` as TimeLLM's LLM: the TimeLLM preset
    pins GPT-2 under --overwrite_args, so the presets (EPA-Air's windows,
    TimeLLM's widths, batch 32) are given as flags instead."""
    flags = dict(DATASET_PRESETS["EPA-Air"], **MODEL_PRESETS["TimeLLM"], batch_size=32,
                 epoch=epochs)
    flags["llm_model_timellm"] = name
    return ([a for a in TIMELLM_TRAIN_ARGS if a != "--overwrite_args"]
            + [x for k, v in flags.items() for x in (f"--{k}", str(v))])


def run_timellm_llm(device, name: str, root: str, exp_dir: str) -> dict:
    """Phase 13d: TimeLLM with `name` ("BERT" or "LLAMA") at full width
    and 6 layers: trained through imm_tsf_torch.main (TIMELLM_LLM_EPOCHS;
    #1 once a forward, the frozen LLM bit for bit as drawn; each
    checkpoint write's seconds printed), the trained experiment served (64
    requests, #1 exactly once a dispatch, nothing else), then one compared
    step (kernels vs plain vs float64, pinned_lags)."""
    label = f"TimeLLM with {name}"
    secs: dict = {}
    t0 = time.monotonic()
    peak_gb(device)
    args = timellm_llm_train_args(name, TIMELLM_LLM_EPOCHS[name])
    data = training_data(root, args)
    cfg = data["cfg"]
    out = {"training": train_route(
        device, args, root, exp_dir, label, len(data["val_dataloader"]),
        len(data["test_dataloader"]), cfg.early_stop_delta, recavg_only,
        inspect=frozen_unchanged(cfg))}
    out["training"]["peak_gb"] = peak_gb(device)
    secs["training"], t0 = time.monotonic() - t0, time.monotonic()
    trained, = (os.path.join(exp_dir, d) for d in os.listdir(exp_dir))
    out["serving"] = serve_experiment(device, None, label, N_LLM_REQUESTS, SEED, trained,
                                      lambda svc, dispatches: recavg_only(0, dispatches))
    out["serving"]["peak_gb"] = peak_gb(device)
    shutil.rmtree(exp_dir, ignore_errors=True)
    secs["serving"], t0 = time.monotonic() - t0, time.monotonic()
    step_cfg = Config(**dict(TIMELLM_CFG, **TIMELLM_TRAINED, llm_model_timellm=name,
                             dropout=0.1))
    out["step"] = compare_model_step(device, step_cfg, label, TIMELLM_STEP_B, pinned_lags(),
                                     lambda route: recavg_only(int(route == "kernel"), 0))
    out["step"]["peak_gb"] = peak_gb(device)
    secs["step"] = time.monotonic() - t0
    out["secs"] = secs
    log(f"# {label}: seconds {json.dumps(secs)}; peak device memory (GB) training "
        f"{out['training']['peak_gb']}, serving {out['serving']['peak_gb']}, compared step "
        f"(float64 included) {out['step']['peak_gb']}")
    return out


# --------------------------------------------------------------- phase 14
def traced_busy_ms(profile_dir: str) -> float | None:
    """Device busy ms of the epoch the trainer traced (`profile_dir`'s
    trace_epoch1.json: epoch 1's training and validation): the union of
    its kernels', copies' and memsets' device intervals (the graphs'
    kernels among them). None when the trace holds no device interval."""
    with open(os.path.join(profile_dir, "trace_epoch1.json")) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e)
    if not spans:
        return None
    busy_us, (s0, e0) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > e0:
            busy_us, s0 = busy_us + e0 - s0, s
        e0 = max(e0, e)
    return (busy_us + e0 - s0) / 1e3


def loop_summary(res: dict, B: int) -> dict:
    """A three-epoch run's timed epoch (2): training windows/s and wall ms
    a step (training only), the median device ms of a step (CUDA events
    around each replay or eager step on the epoch loop; streaming, forward
    + backward + optimizer events, which the host paces), and the idle
    share: 1 - the traced epoch's device busy ms (epoch 1, the same steps
    and validation batches; the profiler slows the host, not the device)
    over epoch 2's untraced training + validation wall ms."""
    steps = res["steps"] // len(res["epochs"])
    train_s, val_s = res["phase_s"]["train"][-1], res["phase_s"]["val"][-1]
    step = res["step_ms"]
    out = {"train_windows_per_s": steps * B / train_s, "wall_ms_a_step": train_s * 1e3 / steps,
           "device_ms_a_step": step.get("step", sum(step.values()) if step else None),
           "epoch_windows_per_s": [e["windows_per_s"] for e in res["epochs"]],
           "busy_ms": res.get("busy_ms"), "idle_share": None, "epoch_loop": res["epoch_loop"]}
    if out["busy_ms"] is not None:
        out["idle_share"] = 1.0 - out["busy_ms"] / ((train_s + val_s) * 1e3)
    return out


def run_loop_case(device, root: str, exp_dir: str, label: str, args, expected, held: bool,
                  streamed: dict | None = None, epochs: int = LOOP_EPOCHS, trace: bool = True,
                  kept: dict | None = None) -> dict:
    """Phase 14, one case: `args` trained through imm_tsf_torch.main on the
    default epoch loop, then on the streaming loop (STREAM) unless
    `streamed` is an earlier phase's streaming run of the same flags; every
    loss finite, launches exact in both (expected(steps, evals)). With
    `trace`, epoch 1 is traced (idle share). `held`: per-step losses and
    test metrics within LOOP_RTOL relative of the streaming run's, and the
    same best epoch; else the gaps are printed. `kept` gets the loop run's
    final weights."""
    data = training_data(root, args)
    cfg = data["cfg"]
    n_val, n_test = len(data["val_dataloader"]), len(data["test_dataloader"])
    out = {}
    for mode in ("loop", "streaming"):
        if mode == "streaming" and streamed is not None:
            out[mode] = streamed
            continue
        prof = os.path.join(exp_dir, f"trace_{mode}")
        extra = ["--epoch", str(epochs)] + (["--profile_dir", prof] if trace else [])
        keep = (lambda res: kept.update(weights=final_weights(res))) if (
            kept is not None and mode == "loop") else None
        res = train_route(device, list(args) + extra, root, exp_dir, f"{label} ({mode})",
                          n_val, n_test, cfg.early_stop_delta, expected, inspect=keep,
                          streaming=mode == "streaming")
        if trace:
            res["busy_ms"] = traced_busy_ms(prof)
            shutil.rmtree(prof, ignore_errors=True)
        out[mode] = res
    a, b = out["loop"], out["streaming"]
    la, lb = np.asarray(a["step_losses"]), np.asarray(b["step_losses"])
    if la.shape != lb.shape:
        raise AssertionError(f"{label}: {la.size} steps on the epoch loop, {lb.size} streaming")
    test_keys = ("mse", "mae", "rmse")
    gaps = {"step_losses": float(np.max(np.abs(la - lb) / np.abs(lb))),
            "test": max(abs(a["test"][k] - b["test"][k]) / abs(b["test"][k]) for k in test_keys)}
    bitwise = bool((la == lb).all()) and all(a["test"][k] == b["test"][k] for k in test_keys)
    summary = {"gaps": gaps, "bitwise": bitwise, "held": held,
               "best_iter": [a["test"]["best_iter"], b["test"]["best_iter"]],
               "loop": loop_summary(a, cfg.batch_size),
               "streaming": loop_summary(b, cfg.batch_size)}
    log(f"# phase 14 {label}: {json.dumps(summary)}; per-step losses, epoch loop "
        f"{a['step_losses']}, streaming {b['step_losses']}; test {a['test']} / {b['test']}")
    if held and (max(gaps.values()) > LOOP_RTOL
                 or a["test"]["best_iter"] != b["test"]["best_iter"]):
        raise AssertionError(f"{label}: the epoch loop departs from the streaming loop: "
                             f"{summary}")
    return {"summary": summary, "loop": a, "streaming": b}


def check_loop_mode(label: str, run: dict, mode: str, captured: bool,
                    reason: str | None = None) -> None:
    """The run took the epoch loop's `mode`, with captured steps that
    replayed, or eager steps for `reason` (a text the loop logs)."""
    stats = run["epoch_loop"]
    ok = (stats is not None and stats["mode"] == mode and stats["captured"] == captured
          and (stats["replays"] > 0) == captured
          and (reason is None or reason in (stats["eager_reason"] or "")))
    if not ok:
        raise AssertionError(f"{label}: epoch loop {stats}, expected {mode} with "
                             f"{'captured' if captured else 'eager'} steps ({reason})")


def run_device_loop(device, root: str, exp_dir: str, streamed: dict) -> dict:
    """Phase 14: the default training path on the card. 14a PatchTST +
    TTF_RecAvg + MMF_GR_Add on the kernel route (#1, #2 with hash dropout
    0.1), 14b CRU on the default route (#5, #4) and the fused route (#6,
    #7), 14c Informer on the kernel route (#2 at three sites, #1): each on
    the resident loop with captured steps against the streaming loop,
    held to LOOP_RTOL; 14d TimesNet (eager resident steps: its periods are
    read on the host) held the same way, and the LatentODE on the staged
    loop against phase 12's streaming run (`streamed["LatentODE"]`; hash
    masks over the staged, longer union axes differ, so only printed);
    14e the resident 14a resumed from its epoch-0 state bit for bit."""
    from imm_tsf_torch.models.timesnet import TimesNet

    out: dict = {}
    T = lambda args: (lambda c: c.input_len + c.pred_len)(training_data(root, args)["cfg"])
    patch_cfg = training_data(root, PATCH_TRAIN_ARGS)["cfg"]
    kept: dict = {}
    out["14a PatchTST kernel"] = run_loop_case(
        device, root, exp_dir, "14a PatchTST, kernel route", PATCH_TRAIN_ARGS +
        PATCH_ROUTES["kernel"], lambda s, e: ffn_counts("kernel", patch_cfg.e_layers, s, e),
        True, kept=kept)
    shutil.rmtree(exp_dir, ignore_errors=True)
    T_cru = T(TRAIN_ARGS)
    for route in ("default", "fused"):
        with cru_route(route == "fused"):
            out[f"14b CRU {route}"] = run_loop_case(
                device, root, exp_dir, f"14b CRU, {route} route", TRAIN_ARGS,
                lambda s, e: expected_counts(route, T_cru, s, e), True)
        shutil.rmtree(exp_dir, ignore_errors=True)
    inf_cfg = training_data(root, INFORMER_TRAIN_ARGS)["cfg"]
    out["14c Informer kernel"] = run_loop_case(
        device, root, exp_dir, "14c Informer, kernel route",
        INFORMER_TRAIN_ARGS + PATCH_ROUTES["kernel"],
        lambda s, e: ffn_counts("kernel", inf_cfg.e_layers + inf_cfg.d_layers, s, e), True)
    shutil.rmtree(exp_dir, ignore_errors=True)
    out["14d TimesNet"] = run_loop_case(device, root, exp_dir, "14d TimesNet",
                                        MTS_TRAIN_ARGS["TimesNet"], recavg_only, True)
    shutil.rmtree(exp_dir, ignore_errors=True)
    out["14d LatentODE staged"] = run_loop_case(
        device, root, exp_dir, "14d LatentODE, staged", IMTS_TRAIN_ARGS["LatentODE"],
        recavg_only, False, streamed=streamed["LatentODE"], epochs=2, trace=False)
    shutil.rmtree(exp_dir, ignore_errors=True)
    for name, case in out.items():
        captured = not name.startswith("14d") and device.type == "cuda"
        mode = "staged" if "staged" in name else "resident"
        reason = TimesNet.eager_steps if "TimesNet" in name else None
        if "LatentODE" in name:  # captured unless the model says why not
            from imm_tsf_torch.models.latent_ode import LatentODE

            reason = getattr(LatentODE, "eager_steps", None)
            captured = reason is None and device.type == "cuda"
        check_loop_mode(name, case["loop"], mode, captured, reason)
    out["14e resume"] = run_resume(device, root, exp_dir, out["14a PatchTST kernel"]["loop"],
                                   kept["weights"], args=RESUME_ARGS,
                                   label="14e resume on the epoch loop", strict=True,
                                   total=LOOP_EPOCHS)
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


def ffn_bound(M: int, D: int, F: int, residuals: bool = False) -> tuple[float, str]:
    """#2's bound at [M, D] x [D, F]: its products as 3 TF32 passes on the
    tensor cores, the rest (activation, dropout, LayerNorm) at the fp32
    peak, against x, the weights and out moved once (the training form also
    writes a1 [M, F] and r [M, D])."""
    nbytes = 4 * (2 * M * D + 2 * D * F + F + 3 * D) + (4 * (M * F + M * D) if residuals else 0)
    t_ops = (3 * 4 * M * D * F / PEAK_TF32_FLOP_PER_S
             + (10 * M * F + 10 * M * D) / PEAK_FP32_FLOP_PER_S) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def measure(device, shapes, gen, errs, serving, text, cru, patch, informer,
            timellm_run) -> list[dict]:
    """One row per kernel. For kernels #1 and #2 `launches` counts the
    Informer training run on the kernel route (phase 9b), for #3 the
    TimeLLM training run on the kernel route (phase 10b, fast prompt);
    `launches_by_path` adds the raw-text path (phase 4b), which runs all
    three, the embedding path (phase 4), both CRU routes (phase 6), the
    PatchTST training run (phase 8), the Informer service (phase 9a) and
    for #3 the TimeLLM service, the exact-prompt training and the raw-text
    training (phase 10); #3's row also counts its backward's calls and
    times it at TimeLLM's shapes (attn_timellm_timings). #2's row also times its training form and the plain backward at
    the same shape (dropout on, as PatchTST trains), and both forms at
    Informer's three FFN sites. Kernels #5 and #6: measure_cru."""
    B, N, T, d = shapes["recavg"]
    rsets = [recavg_inputs(B, N, T, d, gen, device) for _ in range(4)]
    r_bytes, r_flops = recavg_work(B, N, T, d)
    M, D, F = shapes["ffn"]
    fsets = [ffn_inputs(M, D, F, gen, device) for _ in range(3)]
    f_bytes = 4 * (2 * M * D + 2 * D * F + F + 3 * D)
    f_mm, f_ew = 4 * M * D * F, 10 * M * F + 10 * M * D  # the two products; the rest
    f_flops = f_mm + f_ew
    rows = []
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
        rows.append({"name": name, "route": "cuda", "source": src, "replaces": replaces,
                     "ok": True, "max_abs_err": err,
                     **timed(fn, plain, None, sets, nbytes, flops, per_rep)})
    # #1: its previous design and the launch floor under both, at the same
    # shape; then the PatchTST training shape
    rec_row = rows[0]
    rec_row["previous_design_ms"] = device_ms(recavg.tiled_forward, rsets, per_rep=200)
    rec_row["launch_floor_ms"] = device_ms(lambda: recavg.empty_launch(B, T, d, device),
                                           [[]], per_rep=200)
    rec_row["launch_config"] = recavg.launch_config(T)
    Bt, Nt, Tt, dt = shapes["recavg_train"]
    tsets = [recavg_inputs(Bt, Nt, Tt, dt, gen, device) for _ in range(4)]
    t_bytes, t_flops = recavg_work(Bt, Nt, Tt, dt)
    rec_row["training_shape"] = {
        "shape": [Bt, Nt, Tt, dt], "max_abs_err": errs["recavg training"],
        **timed(recavg.recency_weighted_average, recavg.recavg_reference, None, tsets,
                t_bytes, t_flops, 200),
        "previous_design_ms": device_ms(recavg.tiled_forward, tsets, per_rep=200),
        "launch_floor_ms": device_ms(lambda: recavg.empty_launch(Bt, Tt, dt, device), [[]],
                                     per_rep=200)}
    log(f"# recency average at {[B, N, T, d]}: {rec_row['ms']:.5f} ms (previous design "
        f"{rec_row['previous_design_ms']:.5f}, empty launch {rec_row['launch_floor_ms']:.5f}, "
        f"bound {rec_row['bound_ms']:.5f}); at {[Bt, Nt, Tt, dt]}: "
        f"{json.dumps(rec_row['training_shape'])}")
    # #2's products run as 3 TF32 passes on the tensor cores, the rest in fp32
    ffn_row = rows[-1]
    ffn_row["bound_fma_ms"] = ffn_row["bound_ms"]
    ffn_row["bound_ms"], ffn_row["bound_by"] = ffn_bound(M, D, F)
    # the training form: the same operations, a1 [M, F] and r [M, D] written
    # once more; the plain backward on its residuals (four products over the
    # same K, the LayerNorm and dropout backward; not bounded here)
    train = lambda *a: ffn._forward(*a, KEEP, "gelu", True, with_residuals=True)
    ffn_row["train_ms"] = device_ms(train, fsets, per_rep=10)
    ffn_row["train_plain_ms"] = device_ms(
        lambda *a: ffn.ffn_forward_reference(*a, KEEP, "gelu", True, with_residuals=True),
        fsets, per_rep=10)
    ffn_row["train_bound_ms"], ffn_row["train_bound_by"] = ffn_bound(M, D, F, residuals=True)
    gen_g = torch.Generator(device=device).manual_seed(SEED + 6)
    bsets = []
    for a in fsets:
        _, a1, r = train(*a)
        g = torch.randn((M, D), generator=gen_g, device=device)
        bsets.append([a[0], a[1], a[3], a[5], a[7], a1, r, g])
    ffn_row["backward_plain_ms"] = device_ms(
        lambda *a: ffn.ffn_backward_reference(*a, KEEP, "gelu", True), bsets, per_rep=5)
    ffn_row["train_max_abs_err"] = errs["ffn training form"]
    del bsets

    by_shape = {}
    key = lambda shape: "[" + ",".join(map(str, shape)) + "]"
    for Bq, H, Tq, Dq in shapes["attn"]:
        sets = [attn_inputs(Bq, H, Tq, Dq, gen, device, bucket_lo(Tq)) for _ in range(2)]
        work = [attn_work(a[3], H, Dq) for a in sets]
        causal = torch.ones((Tq, Tq), dtype=torch.bool, device=device).tril()
        masks = [causal[None, None] & (a[3] > 0)[:, None, None, :] for a in sets]
        sdpa_sets = [a[:3] + [m] for a, m in zip(sets, masks)]
        sdpa = lambda q, k, v, m: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=m)
        per_rep = 20 if Tq <= 128 else 5
        nbytes, flops = sum(w[0] for w in work) / len(work), sum(w[1] for w in work) / len(work)
        t = timed(attn.fused_causal_attention, attn.attention_reference, (sdpa, sdpa_sets),
                  sets, nbytes, flops, per_rep)
        # the kernel's products run as 3 TF32 passes on the tensor cores
        t["bound_fma_ms"] = t["bound_ms"]
        t["bound_ms"], t["bound_by"] = bound(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)
        by_shape[key((Bq, H, Tq, Dq))] = {"max_abs_err": errs[f"attn bucket-{Tq}"], **t}
        log(f"# attention at {key((Bq, H, Tq, Dq))}: kernel {t['ms']:.4f} ms, SDPA "
            f"{t['library_ms']:.4f}, plain {t['plain_ms']:.4f}, bound {t['bound_ms']:.4f} "
            f"({t['bound_by']}; fp32 FMA {t['bound_fma_ms']:.4f})")
    # the row's headline numbers: TimeLLM's shape, below
    rows.append({"name": "fused_causal_attention", "route": "cuda",
                 "source": "imm_tsf_torch/csrc/attn.cu",
                 "replaces": "imm_tsf_tpu/ops/pallas/attn_kernel.py:109", "ok": True,
                 "by_shape": by_shape, "raw_text_run": attn_over_run(text, gen, device)})
    for row in rows:
        n = text["launches"][row["name"]]
        row["launches"] = n
        row["launches_per_dispatch"] = n / max(text["dispatches"], 1)
        row["launches_by_path"] = {"raw_text": n,
                                   "embeddings": serving["launches"].get(row["name"], 0)}
        for route, res in cru.items():
            row["launches_by_path"][f"cru_{route}"] = res["launches"].get(row["name"], 0)
    for row in rows[:2]:  # #1 and #2: this slice's path, Informer training
        by_path = row["launches_by_path"]
        by_path["patchtst_training"] = patch["routes"]["kernel"]["launches"][row["name"]]
        by_path["informer_serving"] = informer["serving"]["launches"][row["name"]]
        n = informer["training"]["routes"]["kernel"]["launches"][row["name"]]
        row["launches"] = by_path["informer_training"] = n
    rows[1]["train_launches"] = (
        informer["training"]["routes"]["kernel"]["launches"]["fused_encoder_ffn_train"])
    # #3 on this slice's paths: TimeLLM served and trained, raw-text training
    attn_row, trained = rows[2], timellm_run["training"]["routes"]
    paths = {"timellm_serving": timellm_run["serving"]["launches"],
             "timellm_training": trained["kernel"]["launches"],
             "timellm_training_exact_prompt": trained["kernel, exact prompt"]["launches"],
             "raw_text_training": timellm_run["raw_text_training"]["routes"]["kernel"]["launches"]}
    for path, counts in paths.items():
        attn_row["launches_by_path"][path] = counts["fused_causal_attention"]
    attn_row["backward_calls_by_path"] = {
        path: counts["fused_causal_attention_backward"] for path, counts in paths.items()}
    attn_row["launches"] = attn_row["launches_by_path"]["timellm_training"]
    attn_row["backward_calls"] = attn_row["backward_calls_by_path"]["timellm_training"]
    rec_row["launches_by_path"]["timellm_training"] = (
        trained["kernel"]["launches"]["recency_weighted_average"])
    # the row's headline: TimeLLM's trained fast-prompt shape, where its
    # launches are counted
    attn_row["timellm_shapes"] = attn_timellm_timings(shapes["attn_timellm"], gen, device, errs)
    attn_row["shape"] = key(shapes["attn_timellm"][0])
    attn_row.update({k: v for k, v in attn_row["timellm_shapes"][attn_row["shape"]].items()
                     if k not in ("library_train_ms", "train_ms")})
    # #2 at Informer's FFN sites, both forms (inputs of their own)
    gen_i = torch.Generator(device=device).manual_seed(SEED + 10)
    ffn_row["informer_shapes"] = {}
    for m, D, F in shapes["ffn_informer"]:
        sets = [ffn_inputs(m, D, F, gen_i, device) for _ in range(3)]
        (b, by), (tb, tby) = ffn_bound(m, D, F), ffn_bound(m, D, F, residuals=True)
        ffn_row["informer_shapes"][str(m)] = {
            "ms": device_ms(lambda *a: ffn.fused_encoder_ffn(*a, KEEP, "gelu", False), sets,
                            per_rep=10),
            "plain_ms": device_ms(lambda *a: ffn.ffn_reference(*a, KEEP, "gelu", False), sets,
                                  per_rep=10),
            "bound_ms": b, "bound_by": by,
            "train_ms": device_ms(lambda *a: ffn._forward(*a, KEEP, "gelu", True,
                                                          with_residuals=True), sets, per_rep=10),
            "train_plain_ms": device_ms(lambda *a: ffn.ffn_forward_reference(
                *a, KEEP, "gelu", True, with_residuals=True), sets, per_rep=10),
            "train_bound_ms": tb, "train_bound_by": tby,
            "max_abs_err": errs[f"ffn informer M {m}"],
            "train_max_abs_err": errs[f"ffn informer M {m} training form"]}
        log(f"# fused FFN at Informer's M {m}: {json.dumps(ffn_row['informer_shapes'][str(m)])}")
        del sets
    return rows + measure_cru(cru)


def attn_timellm_timings(attn_shapes, gen, device, errs) -> dict:
    """#3 at TimeLLM's shapes (no pad): the kernel's forward, its plain
    version and SDPA with the same boolean mask, each with its bound (3
    TF32 passes on the tensor cores, the fp32-FMA bound beside); the plain
    backward (attention_backward_reference) with its bound (five products
    to the forward's two) and SDPA's autograd backward (its forward and
    backward, less its forward); and the port's training path, the
    kernel's forward and the plain backward under autograd."""
    key = lambda shape: "[" + ",".join(map(str, shape)) + "]"
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for Bq, H, Tq, Dq in attn_shapes:
        sets = [attn_inputs(Bq, H, Tq, Dq, gen, device) for _ in range(2)]
        causal = torch.ones((Tq, Tq), dtype=torch.bool, device=device).tril()
        masks = [causal[None, None] & (a[3] > 0)[:, None, None, :] for a in sets]
        nbytes, flops = attn_work(sets[0][3], H, Dq)
        t = timed(attn.fused_causal_attention, attn.attention_reference,
                  (lambda q, k, v, m: sdpa(q, k, v, attn_mask=m),
                   [a[:3] + [m] for a, m in zip(sets, masks)]), sets, nbytes, flops, 20)
        t["bound_fma_ms"] = t["bound_ms"]
        t["bound_ms"], t["bound_by"] = bound(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)
        gs = [torch.randn(a[0].shape, generator=gen, device=device) for a in sets]
        b_bytes, b_flops = attn_backward_work(sets[0][3], H, Dq)
        t["backward_plain_ms"] = device_ms(attn.attention_backward_reference,
                                           [a + [g] for a, g in zip(sets, gs)], per_rep=10)
        t["backward_bound_ms"], t["backward_bound_by"] = bound(b_bytes, 3 * b_flops,
                                                               PEAK_TF32_FLOP_PER_S)
        t["backward_bound_fma_ms"] = bound(b_bytes, b_flops)[0]
        leaves = [[x.detach().clone().requires_grad_() for x in a[:3]] for a in sets]
        t["library_train_ms"] = device_ms(
            lambda q, k, v, m, g: torch.autograd.grad(sdpa(q, k, v, attn_mask=m), (q, k, v), g),
            [lv + [m, g] for lv, m, g in zip(leaves, masks, gs)], per_rep=10)
        t["library_backward_ms"] = t["library_train_ms"] - t["library_ms"]
        t["train_ms"] = device_ms(
            lambda q, k, v, pad, g: torch.autograd.grad(
                attn.fused_causal_attention(q, k, v, pad), (q, k, v), g),
            [lv + [a[3], g] for lv, a, g in zip(leaves, sets, gs)], per_rep=10)
        t["max_abs_err"] = errs[f"attn {[Bq, H, Tq, Dq]}"]
        t["backward_max_abs_err"] = errs[f"attn backward {[Bq, H, Tq, Dq]}"]
        out[key((Bq, H, Tq, Dq))] = t
        log(f"# attention at TimeLLM's {key((Bq, H, Tq, Dq))}: {json.dumps(t)}")
        del sets, leaves, gs
    return out


def attn_over_run(text, gen, device) -> dict:
    """#3 over the raw-text run's own launches (phase 4b): each launched
    shape [rows, H, T, D] timed on inputs padded as its bucket pads them,
    with its bound; summed over the run's launches of that shape, and
    divided by the run's dispatches. `excess_ms` is the run's launches x
    (ms - bound_ms), the quantity the redesign order ranks kernels by."""
    shapes, total = {}, {"ms": 0.0, "bound_ms": 0.0, "excess_ms": 0.0}
    for (Bq, H, Tq, Dq), n in text["attn_launches_by_shape"]:
        sets = [attn_inputs(Bq, H, Tq, Dq, gen, device, bucket_lo(Tq)) for _ in range(2)]
        work = [attn_work(a[3], H, Dq) for a in sets]
        nbytes, flops = sum(w[0] for w in work) / 2, sum(w[1] for w in work) / 2
        ms = (device_ms(attn.fused_causal_attention, sets, per_rep=20 if Tq <= 128 else 5)
              if device.type == "cuda" else 0.0)
        # the kernel's products run as 3 TF32 passes on the tensor cores
        bound_ms = bound(nbytes, 3 * flops, PEAK_TF32_FLOP_PER_S)[0]
        shapes[f"[{Bq},{H},{Tq},{Dq}]"] = {"launches": n, "ms": ms, "bound_ms": bound_ms}
        total["ms"] += n * ms
        total["bound_ms"] += n * bound_ms
        total["excess_ms"] += n * (ms - bound_ms)
    d = max(text["dispatches"], 1)
    out = {"launches_by_shape": shapes, "dispatches": text["dispatches"],
           "ms_per_dispatch": total["ms"] / d, "bound_ms_per_dispatch": total["bound_ms"] / d,
           "excess_ms": total["excess_ms"]}
    log(f"# attention over the raw-text run's {sum(v['launches'] for v in shapes.values())} "
        f"launches: {json.dumps(out)}")
    return out


def measure_cru(cru) -> list[dict]:
    """Rows for kernels #5 and #6 on the served inputs of one dispatch of
    the CRU experiment (phase 6, default route): its 72 Van Loan blocks
    [64, 64, 64] and its scan inputs. Each kernel is held to its plain
    version there first; `launches` counts the route that runs it."""
    default = cru["default"]
    blocks, ins = default["blocks"], default["scan_inputs"]
    pairs = [(expm.batched_expm(M, MAX_SQUARINGS), expm_taylor12(M, MAX_SQUARINGS))
             for M in blocks]
    block_err = max(expm_rel_err(got, want) for got, want in pairs)
    block_abs = max(float((got - want).abs().max()) for got, want in pairs)
    scan = check_scan(cru_scan.fused_cru_scan(**ins, max_squarings=MAX_SQUARINGS), ins)
    scan_abs = max(v["max_abs_err"] for v in scan.values())
    work = [expm_work(M) for M in blocks]
    sets = [[M, MAX_SQUARINGS] for M in blocks]
    s_bytes, s_flops = scan_work(ins, blocks)
    args = list(ins.values()) + [MAX_SQUARINGS]
    triangular = float(torch.cat([expm.takes_triangular(M) for M in blocks]).float().mean())
    log(f"# batched_expm: {triangular:.4f} of the served Van Loan blocks take the "
        "block-triangular form")
    rows = [
        {"name": "batched_expm", "route": "cuda", "source": "imm_tsf_torch/csrc/expm.cu",
         "replaces": "imm_tsf_tpu/ops/pallas/expm_kernel.py:212", "ok": True,
         "max_abs_err": block_abs, "max_rel_err": block_err,
         "shape": list(blocks[0].shape), "tiers": default["tiers"],
         **timed(expm.batched_expm, expm_taylor12,
                 (torch.linalg.matrix_exp, [[M] for M in blocks]), sets,
                 sum(w[0] for w in work) / len(work), sum(w[1] for w in work) / len(work),
                 len(blocks)),
         # the bound counts n^3 a product for a triangular matrix, 2n^3 otherwise
         "triangular_share": triangular,
         "launches": cru["default"]["launches"]["batched_expm"]},
        {"name": "fused_cru_scan", "route": "cuda", "source": "imm_tsf_torch/csrc/cru_scan.cu",
         "replaces": "imm_tsf_tpu/ops/pallas/cru_scan_kernel.py:429", "ok": True,
         "max_abs_err": scan_abs, "check": scan,
         "shape": list(ins["y_mean"].shape) + [ins["coeff_w"].shape[1]],
         **timed(cru_scan.fused_cru_scan, cru_ops.cru_scan_reference, None, [args],
                 s_bytes, s_flops, 2),
         "launches": cru["fused"]["launches"]["fused_cru_scan"]},
    ]
    for row in rows:
        res = cru["default" if row["name"] == "batched_expm" else "fused"]
        row["launches_per_dispatch"] = row["launches"] / max(res["dispatches"], 1)
        row["launches_by_path"] = {f"cru_{route}": r["launches"][row["name"]]
                                   for route, r in cru.items()}
    return rows


def scan_bwd_work(ins: dict, blocks) -> tuple[int, int]:
    """(bytes, FLOPs) one fused_cru_scan_backward call needs: the scan's
    inputs, #6's residuals and g read once, gy, gyv and the batch-summed
    parameter cotangents written once; per step the recomputed expm (as
    scan_work counts it, n^3 a product of the block upper triangular Van
    Loan block) and the Frechet derivative of Bm^T, (5 + k) pair products
    with k from Bm^T's own norm: the value half a product of two block
    lower triangular matrices (n^3), the two derivative products a block
    triangular times a full matrix (1.5 n^3 each); plus the two Van Loan
    assemblies, gc and gA (2 K lsd^2 each), the coefficient net and its
    cotangents and the covariance adjoint."""
    B, T, lod = ins["y_mean"].shape
    lsd, K = 2 * lod, ins["coeff_w"].shape[1]
    n = 2 * lsd
    params = lsd * K + K + 4 * K * lod * lod + lsd + 2 * lod
    nbytes = 4 * (B * T * (2 * lod + 2) + params + B * T * (2 * lsd + 3 * lod)
                  + B * T * 2 * lod + params)
    expm_products = sum(int(expm_tiers(M)[2].sum()) for M in blocks)
    pair_products = 0
    for M in blocks:
        k = torch.ceil(torch.log2(M.abs().sum(-2).amax(-1).clamp(min=1.0))).clamp(
            max=MAX_SQUARINGS)
        pair_products += int((5 + k).sum())
    per_step = 8 * K * lsd * lsd + 6 * lsd * K + 40 * lsd * lsd + 18 * lod * lsd + 60 * lod
    return nbytes, (expm_products + 4 * pair_products) * n ** 3 + B * T * per_step


def measure_training(train) -> list[dict]:
    """Rows for kernels #4 and #7 on the inputs captured from one training
    step (phase 7): the step's T Frechet derivatives [B, 64, 64] of the
    default route (library: torch.linalg.matrix_exp of the 128-square
    block [[M, G], [0, M]], whose upper right block is L_exp(M)[G]) and
    its fused-route scan backward. `launches` counts each route's
    training run."""
    step = train["step"]
    pairs = step["captured"]["frechet"]
    work = [frechet_work(M) for M, _ in pairs]
    blocks = [[torch.cat([torch.cat([M, G], -1), torch.cat([torch.zeros_like(M), M], -1)], -2)]
              for M, G in pairs]
    f_abs = max(float((expm.batched_expm_frechet(M, G, MAX_SQUARINGS)
                       - expm_frechet_taylor12(M, G, MAX_SQUARINGS)).abs().max())
                for M, G in pairs)
    args = step["captured"]["scan_bwd"][0]
    ins = dict(zip(("y_mean", "y_var", "valid", "dts", "coeff_w", "coeff_b", "dense_basis",
                    "trans_var", "init_cu", "init_cl"), (a.detach() for a in args[:10])))
    b_bytes, b_flops = scan_bwd_work(ins, van_loan_blocks(ins))
    bwd = step["scan_bwd_check"]
    plan, by_cluster, f_plan, f_by_cluster = {}, {}, {}, {}
    f_sets = [[M, G, MAX_SQUARINGS] for M, G in pairs]
    if args[0].device.type == "cuda":  # the launch plans exist on a card only
        B, _, lod = ins["y_mean"].shape
        plan = cru_scan.cluster_plan(B, lod, ins["coeff_w"].shape[1], args[0].device)
        by_cluster = {C: device_ms(lambda *a, C=C: cru_scan.fused_cru_scan_backward(*a, cluster=C),
                                   [list(args)], per_rep=2)
                      for C in CLUSTER_SIZES}
        log(f"# fused_cru_scan_backward at B {B}: {plan}; device ms by cluster size "
            f"{by_cluster}")
        f_plan = expm.frechet_plan(pairs[0][0].shape[0], args[0].device)
        f_by_cluster = {C: device_ms(lambda *a, C=C: expm.batched_expm_frechet(*a, cluster=C),
                                     f_sets, per_rep=len(pairs))
                        for C in CLUSTER_SIZES}
        log(f"# batched_expm_frechet at {list(pairs[0][0].shape)}: {f_plan}; device ms by "
            f"cluster size {f_by_cluster}")
    f_timed = timed(expm.batched_expm_frechet, expm_frechet_taylor12,
                    (torch.linalg.matrix_exp, blocks), f_sets,
                    sum(w[0] for w in work) / len(work), sum(w[1] for w in work) / len(work),
                    len(pairs))
    return [
        {"name": "batched_expm_frechet", "route": "cuda",
         "source": "imm_tsf_torch/csrc/expm_frechet.cu",
         "replaces": "imm_tsf_tpu/ops/pallas/expm_kernel.py:179", "ok": True,
         "max_abs_err": f_abs, "max_rel_err": step["frechet_err"],
         "shape": list(pairs[0][0].shape), **f_timed,
         # float32 FMA products (the 3xTF32 emulation strays past half of FRECHET_RTOL)
         "bound_fma_ms": f_timed["bound_ms"], **f_plan, "ms_by_cluster": f_by_cluster,
         "launches": train["routes"]["default"]["launches"]["batched_expm_frechet"],
         "launches_per_step": len(pairs)},
        {"name": "fused_cru_scan_backward", "route": "cuda",
         "source": "imm_tsf_torch/csrc/cru_scan_bwd.cu",
         "replaces": "imm_tsf_tpu/ops/pallas/cru_scan_kernel.py:492", "ok": True,
         "max_abs_err": max(v["max_abs_err"] for v in bwd.values()), "check": bwd,
         "shape": list(step["scan_shape"]),
         **timed(cru_scan.fused_cru_scan_backward, cru_ops.cru_scan_bwd_reference, None,
                 [list(args)], b_bytes, b_flops, 2),
         **plan, "ms_by_cluster": by_cluster,
         "launches": train["routes"]["fused"]["launches"]["fused_cru_scan_backward"],
         "launches_per_step": 1},
    ]


def recavg_work(B, N, T, d) -> tuple[int, int]:
    """#1's (bytes, flops): tau, mask, t_hat, V and sigma read once, E
    written once; the weights (8 a (n, t)), the weighted sums and the
    scaling."""
    return (4 * (B * N * 2 + B * T + B * N * d + 1 + B * T * d),
            B * N * T * 8 + 2 * B * N * T * d + B * T * d)


def bound(nbytes, flops, flop_rate=PEAK_FP32_FLOP_PER_S) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of nbytes at the card's
    memory rate and flops at flop_rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def timed(fn, plain, library, sets, nbytes, flops, per_rep) -> dict:
    """Device ms of the kernel, its plain version and (library_fn,
    library_sets) when given, with the bound of (nbytes, flops) at the
    fp32 FMA peak."""
    bound_ms, bound_by = bound(nbytes, flops)
    return {"ms": device_ms(fn, sets, per_rep=per_rep),
            "plain_ms": device_ms(plain, sets, per_rep=per_rep),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": (device_ms(library[0], library[1], per_rep=per_rep)
                           if library else None),
            "bytes": nbytes, "flops": flops}


# ------------------------------------------------------------------- main
def main() -> int:

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run", file=sys.stderr)
        return 2

    t_start = time.monotonic()
    phase_s: dict = {}  # each phase's wall seconds
    marks = [t_start]

    def mark(phase: str) -> None:
        marks.append(time.monotonic())
        phase_s[phase] = marks[-1] - marks[-2]
        log(f"# phase {phase} took {phase_s[phase]:.1f} s")

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # as device.resolve_device sets it
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"# torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    mark("1")
    # phase 2: build
    t0 = time.monotonic()
    secs = _build.build(["ffn", "recavg", "attn", "expm", "cru_scan", "expm_frechet",
                         "cru_scan_bwd"])
    log(f"# built {sorted(secs)} in {time.monotonic() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in sorted(secs.items()))})")

    mark("2")
    # phase 3: kernels against their plain versions
    gen = torch.Generator(device=device).manual_seed(SEED)
    # attention: embed_notes' call at each bucket (token_budget 32768 tokens,
    # at least token_batch 64 rows: [1024, 12, 32, 64] ... [64, 12, 1024, 64]),
    # GPT-2's 12 heads of 64
    # expm and cru_scan: the CRU preset's [64, 64, 64] Van Loan blocks and its
    # scan at B=64, T=48+24, lod=16, K=15, as served; frechet and cru_scan_bwd:
    # the trained batch of phase 7, B=32, T=36+36
    shapes = {"recavg": (64, 8, 24, 768), "recavg_train": (32, 8, 36, 768),
              "ffn": (8192, 512, 2048),
              "attn": tuple((bucket_rows(T), 12, T, 64) for T in EMBED_BUCKETS),
              "expm": (64, 64), "cru_scan": (64, 72, 16, 15),
              "frechet": (32, 64), "cru_scan_bwd": (32, 72, 16, 15),
              "ffn_informer": informer_ffn_shapes(INFORMER_CFG),
              "attn_timellm": timellm_attn_shapes(dict(TIMELLM_CFG, **TIMELLM_TRAINED),
                                                  TIMELLM_STEP_B)}
    errs = check_kernels(device, shapes, gen)

    mark("3")
    # phase 4: serving
    exp_dir = os.path.join(REPO, "experiments", f"chip_smoke_{os.getpid()}")
    try:
        serving = run_serving(device, N_REQUESTS, SEED, exp_dir)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    checked = {k: shapes[k] for k in serving["shapes"]}
    if serving["shapes"] != checked:
        raise AssertionError(f"serving shapes {serving['shapes']} != checked {checked}")

    mark("4")
    # phase 4b: raw-text serving through the frozen GPT-2, random weights
    # from a seed (no local checkpoint is read)
    os.environ.pop("IMM_TSF_LLM_DIR", None)
    try:
        text = run_raw_text_serving(device, N_TEXT_REQUESTS, SEED, exp_dir)
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)

    mark("4b")
    # phase 6: the CRU experiment, default route then fused route
    try:
        cru_cfg = make_experiment(exp_dir, CRU_CFG, SEED)
        cru = {route: run_cru_serving(device, N_CRU_REQUESTS, SEED, exp_dir, cru_cfg,
                                      fused=route == "fused")
               for route in ("default", "fused")}
    finally:
        shutil.rmtree(exp_dir, ignore_errors=True)
    route_err = max_err(cru["fused"]["out"], cru["default"]["out"], CRU_SERVE_TOL)
    log(f"# CRU routes agree on one dispatch: max|fused - default| {route_err:.3e}")
    served = (tuple(cru["default"]["scan_inputs"]["y_mean"].shape)
              + (cru["default"]["scan_inputs"]["coeff_w"].shape[1],))
    if served != shapes["cru_scan"] or tuple(cru["default"]["blocks"][0].shape[1:]) != \
            shapes["expm"]:
        raise AssertionError(f"CRU serving shapes {served} != checked {shapes['cru_scan']}")

    mark("6")
    # phase 7: train the CRU experiment through imm_tsf_torch.main on each route
    root = os.path.join(REPO, "experiments", f"chip_smoke_data_{os.getpid()}")
    try:
        make_synthetic_dataset(os.path.join(root, "EPA-Air"), **TRAIN_DATA)
        train = run_training(device, root, exp_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(exp_dir, ignore_errors=True)
    step = train["step"]
    trained = {"frechet": (step["frechet_shape"][0], step["frechet_shape"][1]),
               "cru_scan_bwd": step["scan_shape"]}
    if trained != {k: shapes[k] for k in trained}:
        raise AssertionError(f"trained shapes {trained} != checked "
                             f"{ {k: shapes[k] for k in trained} }")

    mark("7")
    # phase 8: train PatchTST + TTF_RecAvg + MMF_GR_Add through
    # imm_tsf_torch.main, kernel route then plain route, and one compared step
    kept: dict = {}  # the kernel route's final weights, for phase 11d
    try:
        make_synthetic_dataset(os.path.join(root, "EPA-Air"), **TRAIN_DATA)
        patch = run_patchtst_training(device, root, exp_dir, kept)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(exp_dir, ignore_errors=True)
    if patch["step"]["ffn_rows"] != [shapes["ffn"][0]]:
        raise AssertionError(f"the compared PatchTST step's FFN M {patch['step']['ffn_rows']} "
                             f"!= checked {shapes['ffn'][0]}")

    mark("8")
    # phase 9: Informer served and trained on both routes, then the default
    # fusion pair behind DLinear
    informer = {}
    try:
        informer["serving"] = run_informer_serving(device, N_INFORMER_REQUESTS, SEED, exp_dir)
        shutil.rmtree(exp_dir, ignore_errors=True)
        make_synthetic_dataset(os.path.join(root, "EPA-Air"), **TRAIN_DATA)
        informer["training"] = run_informer_training(device, root, exp_dir)
        shutil.rmtree(exp_dir, ignore_errors=True)
        default_pair = run_default_pair(device, N_DEFAULT_PAIR_REQUESTS, SEED, root, exp_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(exp_dir, ignore_errors=True)
    checked = [m for m, _, _ in shapes["ffn_informer"]]
    for where in (informer["serving"], informer["training"]["step"]):
        if where["ffn_rows"] != checked:
            raise AssertionError(f"Informer's FFN rows {where['ffn_rows']} != checked {checked}")

    mark("9")
    # phase 10: TimeLLM served and trained (both routes, both prompts), one
    # compared step, then raw-text training
    try:
        timellm_run = {"serving": run_timellm_serving(device, N_TIMELLM_REQUESTS, SEED, exp_dir)}
        shutil.rmtree(exp_dir, ignore_errors=True)
        make_synthetic_dataset(os.path.join(root, "EPA-Air"), **TRAIN_DATA)
        timellm_run["training"] = run_timellm_training(device, root, exp_dir)
        timellm_run["raw_text_training"] = run_raw_text_training(device, root, exp_dir)
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(exp_dir, ignore_errors=True)
    routes = timellm_run["training"]["routes"]
    for checked, route in zip(shapes["attn_timellm"], ("kernel", "kernel, exact prompt")):
        if device.type == "cuda" and checked not in routes[route]["attn_shapes"]:
            raise AssertionError(f"TimeLLM's {route} training launched #3 at "
                                 f"{routes[route]['attn_shapes']}, not at the checked {checked}")

    mark("10")
    # phase 11: TimesNet, TimeMixer and TTM served, trained and one compared
    # step each; then phase 8's kernel route resumed from its train state
    mts: dict = {}
    try:
        for model in MTS_MODELS:
            mts[model] = {"serving": run_mts_serving(device, model, N_MTS_REQUESTS, SEED,
                                                     exp_dir)}
            shutil.rmtree(exp_dir, ignore_errors=True)
        make_synthetic_dataset(os.path.join(root, "EPA-Air"), **TRAIN_DATA)
        for model in MTS_MODELS:
            mts[model]["training"] = run_mts_training(device, root, exp_dir, model)
            shutil.rmtree(exp_dir, ignore_errors=True)
        mts["resume"] = run_resume(device, root, exp_dir, patch["routes"]["kernel"],
                                   kept["weights"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(exp_dir, ignore_errors=True)

    mark("11")
    # phase 12: LatentODE, NeuralFlow and tPatchGNN served, trained and one
    # compared step each; the LatentODE's trained union scan against float64
    # (12e); then the LatentODE run resumed from its train state
    imts: dict = {}
    ode_kept: dict = {}  # the LatentODE run, its final weights and #1's trained shapes
    try:
        for model in IMTS_MODELS:
            imts[model] = {"serving": run_imts_serving(device, model, N_IMTS_REQUESTS[model],
                                                       SEED, exp_dir)}
            shutil.rmtree(exp_dir, ignore_errors=True)
        make_synthetic_dataset(os.path.join(root, "EPA-Air"), **TRAIN_DATA)
        for model in IMTS_MODELS:
            imts[model]["training"] = run_imts_training(device, root, exp_dir, model, ode_kept)
            shutil.rmtree(exp_dir, ignore_errors=True)
        imts["ode_drift"] = check_ode_drift(device)
        imts["resume"] = run_resume(device, root, exp_dir, ode_kept["run"], ode_kept["weights"],
                                    args=ODE_RESUME_ARGS, expected=recavg_only,
                                    label="LatentODE resume", strict=True,
                                    stopped=ode_kept["dir"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(exp_dir, ignore_errors=True)
        shutil.rmtree(exp_dir + "_latent_ode_run", ignore_errors=True)
    errs["recavg ode union"] = check_recavg_ode(device, ode_kept["recavg_shapes"])

    mark("12")
    # phase 13: BERT, Llama and DeepSeek as frozen LLMs: raw-text serving,
    # memory at real size, the embedding stage, TimeLLM with BERT and Llama
    llms: dict = {"serving": {}, "timellm": {}}
    try:
        for alias in LLM_ALIASES:
            llms["serving"][alias] = run_llm_serving(device, alias, N_LLM_REQUESTS, SEED, exp_dir)
            shutil.rmtree(exp_dir, ignore_errors=True)
            torch.cuda.empty_cache()
        llms["memory"] = run_llm_memory(device)
        make_synthetic_dataset(os.path.join(root, "EPA-Air"), **TRAIN_DATA)
        llms["stage"] = run_embed_stage(device, root, exp_dir)
        shutil.rmtree(exp_dir, ignore_errors=True)
        for llm_name in TIMELLM_LLM_EPOCHS:
            llms["timellm"][llm_name] = run_timellm_llm(device, llm_name, root, exp_dir)
            shutil.rmtree(exp_dir, ignore_errors=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(exp_dir, ignore_errors=True)

    mark("13")
    # phase 14: the default training path, the device-resident epoch loop on
    # captured steps, against the streaming loop on the same flags
    try:
        make_synthetic_dataset(os.path.join(root, "EPA-Air"), **TRAIN_DATA)
        device_loop = run_device_loop(
            device, root, exp_dir, {"LatentODE": imts["LatentODE"]["training"]["kernel"]})
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(exp_dir, ignore_errors=True)

    mark("14")
    # phase 5: timings
    rows = (measure(device, shapes, gen, errs, serving, text, cru, patch, informer, timellm_run)
            + measure_training(train))
    mark("5")
    rec_row = next(r for r in rows if r["name"] == "recency_weighted_average")
    for model in IMTS_MODELS:
        for path in ("serving", "training"):
            res = imts[model][path] if path == "serving" else imts[model][path]["kernel"]
            rec_row["launches_by_path"][f"{model.lower()}_{path}"] = (
                res["launches"]["recency_weighted_average"])
    rec_row["launches_by_path"]["latent_ode_resume"] = sum(
        r["launches"]["recency_weighted_average"] for r in imts["resume"]["runs"])
    ffn_row = next(r for r in rows if r["name"] == "fused_encoder_ffn")
    llm_paths = {f"{a.lower()}_raw_text_serving": llms["serving"][a] for a in LLM_ALIASES}
    llm_paths["llama_stage_training"] = llms["stage"]["training"]
    for name, res in llms["timellm"].items():
        llm_paths[f"timellm_{name.lower()}_serving"] = res["serving"]
        llm_paths[f"timellm_{name.lower()}_training"] = res["training"]
    for path, res in llm_paths.items():
        for row in (rec_row, ffn_row):
            row["launches_by_path"][path] = res["launches"][row["name"]]
    for case, res in device_loop.items():  # phase 14's runs on the epoch loop
        for row in rows:
            n = res["loop"]["launches"].get(row["name"], 0) if "loop" in res else 0
            if n:
                row.setdefault("launches_by_path", {})[f"device_loop {case}"] = n
    log(f"# service: {serving['requests_per_s']:.1f} requests/s, dispatch p50 "
        f"{serving['dispatch_ms']['p50']} ms; raw text {text['requests_per_s']:.1f} "
        f"requests/s, dispatch p50 {text['dispatch_ms']['p50']} ms; CRU default "
        f"{cru['default']['requests_per_s']:.1f} / fused {cru['fused']['requests_per_s']:.1f} "
        f"requests/s; CRU training {train['routes']['default']['wall_s']:.1f} / "
        f"{train['routes']['fused']['wall_s']:.1f} s; PatchTST training "
        f"{patch['routes']['kernel']['wall_s']:.1f} / {patch['routes']['plain']['wall_s']:.1f} s; "
        f"Informer {informer['serving']['requests_per_s']:.1f} requests/s, training "
        f"{informer['training']['routes']['kernel']['wall_s']:.1f} / "
        f"{informer['training']['routes']['plain']['wall_s']:.1f} s; TimeLLM "
        f"{timellm_run['serving']['requests_per_s']:.1f} requests/s, training "
        + " / ".join(f"{r['wall_s']:.1f}" for r in routes.values())
        + " s; " + "; ".join(f"{m} {mts[m]['serving']['requests_per_s']:.1f} requests/s, "
                             f"training {mts[m]['training']['kernel']['wall_s']:.1f} s"
                             for m in MTS_MODELS)
        + "; resume " + " + ".join(f"{r['wall_s']:.1f}" for r in mts["resume"]["runs"]) + " s; "
        + "; ".join(f"{m} {imts[m]['serving']['requests_per_s']:.1f} requests/s, "
                    f"training {imts[m]['training']['kernel']['wall_s']:.1f} s"
                    for m in IMTS_MODELS)
        + "; LatentODE resume "
        + " + ".join(f"{r['wall_s']:.1f}" for r in imts["resume"]["runs"]) + " s; "
        + "; ".join(f"{a} raw text {llms['serving'][a]['requests_per_s']:.1f} requests/s"
                    for a in LLM_ALIASES)
        + f"; stage training {llms['stage']['training']['wall_s']:.1f} s; "
        + "; ".join(f"TimeLLM {n} {r['serving']['requests_per_s']:.1f} requests/s, training "
                    f"{r['training']['wall_s']:.1f} s" for n, r in llms["timellm"].items())
        + f"; total {time.monotonic() - t_start:.1f} s")
    cru_summary = {route: {k: v for k, v in res.items()
                           if k not in ("out", "scan_inputs", "blocks")}
                   for route, res in cru.items()}
    train_summary = dict(train, step={k: v for k, v in step.items() if k != "captured"})
    print(json.dumps({"kernels": rows, "power": smi,
                      "requests_per_s": serving["requests_per_s"],
                      "dispatch_ms": serving["dispatch_ms"],
                      "forward_ms": serving["forward_ms"],
                      "dispatch_profile": serving["dispatch_profile"],
                      "raw_text": text, "cru": cru_summary,
                      "cru_route_err": route_err, "training": train_summary,
                      "patchtst_training": patch, "informer": informer,
                      "default_pair": default_pair, "timellm": timellm_run,
                      "mts": mts, "imts": imts, "llms": llms,
                      "device_loop": {k: v.get("summary", v) for k, v in device_loop.items()},
                      "phase_s": phase_s}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
