"""TimesNet — FFT-period 2-D-variation model, irregular-adapted (after
imm_tsf_tpu/models/timesnet.py; reference models/TimesNet.py:9-152):
normalization, DataEmbedding over (value, mask, time) channels, the
predict-time tokens, predict_linear over the time axis, TimesBlocks with
one LayerNorm shared by all of them, the projection and de-normalization.

A TimesBlock takes the k frequency bins of largest batch- and
channel-mean amplitude (lax.top_k's order), folds the series into a
[ceil(T / p), p] grid for each bin's period p, runs two inception
convolutions on it and sums the k results under a softmax of their
amplitudes. As in the JAX package, every candidate period runs, with
static shapes: the periods {T // f} are grouped into buckets
(`_bucket_partition`), each bucket's grids are zero-padded to one canvas
and stacked along the batch, both inception convolutions run once a
bucket, and the k selected branches are gathered on the device by
`lookup[top]`. Nothing is read back to the host, so a CUDA graph captures
the forward (the epoch loop's steps) and `torch.export` traces it (the
artifacts). Unselected branches never reach the output.

The inception block (kernels 1, 3, ..., 2K-1, SAME padding, their mean)
is one (2K-1)-square conv2d of the mean of the centre-embedded kernels,
as the JAX package's `_apply_inception` fuses it, cropped to
(2H-1, 2W-1) on an H x W canvas: farther taps only ever meet the zero
padding. Its parameters keep the flax leaves `conv{1,2}_kernel_<i>`
[k, k, in, out] and `conv{1,2}_bias_<i>`; the fused kernel goes to
torch's [out, in, kh, kw] by permute(3, 2, 0, 1) (a layout change, no
flip). The layout is NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config
from ..layers.decomp import fft_dtype
from ..layers.embed import DataEmbedding
from .base import dense, pad_time, variance_scaling_
from .timellm import top_lags


def f_to_period(f: int, T: int) -> int:
    """The period of frequency bin f over T steps; T for the DC bin
    (imm_tsf_tpu/models/timesnet.py:169-170)."""
    return T // f if f else T


# per-conv-dispatch penalty (in padded-cell units) of the canvas-bucket
# partition below: the JAX package's constant, which it measured best on a
# TPU v5e. It is kept so that the port's buckets are the JAX package's;
# retuning it for the H100 is a speed change of its own.
_BUCKET_FIX = 60


def _bucket_partition(T: int, kmax: int):
    """Static DP partition of the candidate periods into canvas buckets
    (imm_tsf_tpu/models/timesnet.py:114-146).

    Candidates (sorted by grid rows desc) are split into contiguous
    groups; each group shares one zero-padded canvas of shape
    [max rows, max period], so the 2 inception convs run once per group
    instead of once per candidate. Cost per group = padded cells x the
    cropped-kernel tap fraction + _BUCKET_FIX. Returns (cand, buckets) with
    buckets = [(members: list[(cand index, (rows, period))], hb, wb)],
    members in `cand` order within each bucket."""
    cand = sorted({f_to_period(f, T) for f in range(T // 2 + 1)})
    grids = [((T + p - 1) // p, p) for p in cand]
    order = sorted(range(len(cand)), key=lambda i: (-grids[i][0], grids[i][1]))
    n = len(order)
    best = [None] * (n + 1)
    best[0] = (0.0, [])
    for j in range(1, n + 1):
        for i in range(j):
            hb = max(grids[order[t]][0] for t in range(i, j))
            wb = max(grids[order[t]][1] for t in range(i, j))
            taps = (min(kmax, 2 * hb - 1) * min(kmax, 2 * wb - 1)) / (kmax * kmax)
            cost = best[i][0] + (j - i) * hb * wb * taps + _BUCKET_FIX
            if best[j] is None or cost < best[j][0]:
                best[j] = (cost, best[i][1] + [(i, j, hb, wb)])
    buckets = [([(order[t], grids[order[t]]) for t in range(i, j)], hb, wb)
               for (i, j, hb, wb) in best[n][1]]
    return cand, buckets


class TimesBlock(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.k, self.num_kernels = cfg.top_k, cfg.num_kernels
        self.T = cfg.input_len + cfg.pred_len
        self.data_mesh = None  # parallel/mesh.DataMesh, set by the trainer
        self._init_inception("conv1", cfg.d_model, cfg.d_ff)
        self._init_inception("conv2", cfg.d_ff, cfg.d_model)
        cand, self.buckets = _bucket_partition(self.T, 2 * cfg.num_kernels - 1)
        branch = {p: i for i, p in enumerate(cand)}
        # the static tables live on the module's device (non-persistent
        # buffers: no checkpoint holds them): bin f -> its branch, and each
        # bucket's true-grid mask where a member is smaller than the canvas
        self.register_buffer("lookup", torch.tensor(
            [branch[f_to_period(f, self.T)] for f in range(self.T // 2 + 1)]), persistent=False)
        for b, (members, hb, wb) in enumerate(self.buckets):
            if any(h != hb or w != wb for _, (h, w) in members):
                mask = torch.zeros(len(members), 1, 1, hb, wb)
                for m, (_, (h, w)) in enumerate(members):
                    mask[m, ..., :h, :w] = 1.0
                self.register_buffer(f"mask_{b}", mask, persistent=False)

    def _init_inception(self, name: str, c_in: int, c_out: int) -> None:
        """The flax leaves `<name>_kernel_<i>` [k, k, in, out] (kaiming
        normal, k = 2i + 1) and `<name>_bias_<i>` (zeros) (reference
        layers/Conv_Blocks.py:5-30)."""
        for i in range(self.num_kernels):
            k = 2 * i + 1
            w = torch.empty(k, k, c_in, c_out)
            variance_scaling_(w, 2.0, k * k * c_in)
            self.register_parameter(f"{name}_kernel_{i}", nn.Parameter(w))
            self.register_parameter(f"{name}_bias_{i}", nn.Parameter(torch.zeros(c_out)))

    def _inception(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """The mean of SAME 2-D convs with kernels 1, 3, ..., 2K-1 over x
        [B, C_in, H, W], as one conv whose kernel is the mean of the
        centre-embedded ones, cut to its centre (2H-1, 2W-1) (the JAX
        package's `_apply_inception(crop=True)`). The kernel and bias are
        cast to x's dtype, as JAX casts them (amp_bf16's bf16 parameters
        meet float32 activations here)."""
        n = self.num_kernels
        kernels = [getattr(self, f"{name}_kernel_{i}") for i in range(n)]
        kmax = kernels[-1].shape[0]
        w = sum(F.pad(k, (0, 0, 0, 0, *(((kmax - k.shape[0]) // 2,) * 4))) for k in kernels)
        b = sum(getattr(self, f"{name}_bias_{i}") for i in range(n))
        kh, kw = min(kmax, 2 * x.shape[2] - 1), min(kmax, 2 * x.shape[3] - 1)
        oh, ow = (kmax - kh) // 2, (kmax - kw) // 2
        w = w[oh:oh + kh, ow:ow + kw]
        return F.conv2d(x, (w / n).to(x.dtype).permute(3, 2, 0, 1), (b / n).to(x.dtype),
                        padding=(kh // 2, kw // 2))

    def _batch_mean(self, amp: torch.Tensor) -> torch.Tensor:
        """The amplitudes' mean over the batch [F, N]; under a data mesh of
        more than one rank, over the global batch (the sum all-reduced,
        with no gradient: the choice it feeds has none), so every rank
        picks the global batch's periods."""
        mesh = self.data_mesh
        if mesh is None or not mesh.couples:
            return amp.mean(dim=0)
        return mesh.all_reduce_(amp.sum(dim=0).detach()) / (amp.shape[0] * mesh.world)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, T, N]
        B, T, N = x.shape
        if T != self.T:
            raise ValueError(f"TimesBlock built for T {self.T} got T {T}")
        amp = torch.fft.rfft(x.to(fft_dtype(x.dtype)), dim=1).abs()  # [B, F, N]
        freq = self._batch_mean(amp).mean(dim=-1).detach()  # [F]; the choice has no gradient
        freq = torch.cat([torch.zeros_like(freq[:1]), freq[1:]])  # the DC bin never wins
        top = top_lags(freq[None], self.k)[0]  # [k], on the device
        period_weight = amp.mean(dim=-1)[:, top].to(x.dtype)  # [B, k]
        xt = x.transpose(1, 2)  # [B, N, T]
        outs: dict = {}  # candidate index -> its branch's output [B, N, T]
        for b, (members, hb, wb) in enumerate(self.buckets):
            canvas = torch.cat([F.pad(F.pad(xt, (0, h * w - T)).reshape(B, N, h, w),
                                      (0, wb - w, 0, hb - h)) for _, (h, w) in members])
            h1 = F.gelu(self._inception("conv1", canvas), approximate="tanh")
            mask = getattr(self, f"mask_{b}", None)
            if mask is not None:  # conv2 sees the SAME-pad zeros of each true grid
                h1 = (h1.reshape(len(members), B, *h1.shape[1:]) * mask.to(h1.dtype)
                      ).reshape(h1.shape)
            o = self._inception("conv2", h1)  # [nb * B, N, hb, wb]
            for m, (ci, (h, w)) in enumerate(members):
                outs[ci] = o[m * B:(m + 1) * B, :, :h, :w].reshape(B, N, h * w)[..., :T]
        outs = torch.stack([outs[ci] for ci in range(len(outs))])  # [n_cand, B, N, T]
        # the k branches, gathered on the device (jnp.take): by indexing,
        # whose backward (index_put_ with accumulate) sums the bins that
        # share a period in a fixed order on cuda, where index_select's
        # (index_add_) sums them with atomics
        res = outs[self.lookup[top]].permute(1, 3, 2, 0)  # [B, T, N, k]
        pw = torch.softmax(period_weight, dim=1)  # [B, k]
        return (res * pw[:, None, None, :]).sum(dim=-1) + x


class TimesNet(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        total = cfg.input_len + cfg.pred_len
        self.enc_embedding = DataEmbedding(2 * cfg.input_dim + 1, cfg.d_model, cfg.dropout)
        self.predict_linear = dense(total, total)
        for i in range(cfg.e_layers):
            setattr(self, f"times_block_{i}", TimesBlock(cfg))
        # one LayerNorm after every block (reference models/TimesNet.py:88,135)
        self.layer_norm = nn.LayerNorm(cfg.d_model, eps=1e-5)
        self.projection = dense(cfg.d_model, cfg.input_dim)

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        cfg = self.cfg
        seq_len, pred_len = cfg.input_len, cfg.pred_len
        observed_data = pad_time(observed_data, seq_len)
        observed_mask = pad_time(observed_mask, seq_len)
        observed_tp = pad_time(observed_tp, seq_len)
        Lp = tp_to_predict.shape[1]
        tp_to_predict = pad_time(tp_to_predict, pred_len)

        means = observed_data.mean(dim=1, keepdim=True)
        x_enc = observed_data - means
        stdev = torch.sqrt(x_enc.var(dim=1, keepdim=True, unbiased=False) + 1e-5)
        x_enc = torch.cat([x_enc / stdev, observed_mask, observed_tp[:, :, None]], dim=-1)

        enc_out = self.enc_embedding(x_enc)  # [B, L, d_model]
        tp_rep = tp_to_predict[:, :, None].expand(-1, -1, cfg.d_model)
        enc_out = torch.cat([enc_out, tp_rep], dim=1)  # [B, L + Lp, d_model]
        # a contiguous input: cuBLAS's result for a transposed one differed
        # by an ulp between an exported program and the eager module on an
        # H100 (tools/torch_timesnet_artifact_probe.py)
        enc_out = self.predict_linear(enc_out.transpose(1, 2).contiguous()).transpose(1, 2)
        for i in range(cfg.e_layers):
            enc_out = self.layer_norm(getattr(self, f"times_block_{i}")(enc_out))

        dec_out = self.projection(enc_out) * stdev + means
        return dec_out[:, -pred_len:][:, :Lp]
