"""tPatchGNN — transformable patching + time-adaptive graph neural network
(after imm_tsf_tpu/models/tpatchgnn.py; reference models/tPatchGNN.py:84-293):

  - learnable time embedding [scale; sin(periodic)] (:98-99, 176-180);
  - TTCN: a filter-generator MLP with a masked softmax over the patch's
    point axis (fill -1e8: a patch with no point gets uniform weights),
    weighted feature sum + bias + relu (:182-195);
  - per layer, a torch-style TransformerEncoder over the patch axis with
    sinusoidal PE (:113-119, 217-220);
  - the time-adaptive adjacency: gated node-vector updates, then
    softmax(relu(nv1 @ nv2)) per (B, M) (:222-234);
  - k-hop gcn message passing, einsum 'bfnm,bmnv->bfvm' (:14-61, 237);
  - Linear or CNN temporal aggregation (:156-165, 243-251);
  - an MLP decoder conditioned on the time embedding of t_hat (:167-174,
    282-291).

Input layout (the patch collate): X / tt / mask [B, M = npatch, L, N];
t_hat [B, Lp]. The model is built for cfg.npatch patches (derived as
config.finalize_patching derives it when unset): the Linear and CNN
aggregations are sized by it.

Parameter names are flax's where flax keeps them: the blocks
`tf_<l>_<t>`, the raw `T_bias`, `nodevec1`, `nodevec2`. flax binds the
Denses of the Sequentials `filter_generators`, `nodevec_gate{1,2}_<l>` and
`decoder` to the model as `Dense_<i>`, in creation order;
convert._sequential_dense maps each to its place in the port's Sequential. The Dense layers draw torch's
U(+-1/sqrt(in)) kernels with zero biases (models/base.dense), T_bias and
the node vectors N(0, 1), the CNN aggregation flax's lecun normal.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import Config, finalize_patching
from ..layers.attention import MultiHeadAttention
from ..layers.embed import pe_table
from ..layers.fast_dropout import Dropout
from .base import dense, variance_scaling_


class TorchTransformerEncoderLayer(nn.Module):
    """torch nn.TransformerEncoderLayer's defaults: post-LN, a relu FFN of
    2048 and dropout 0.1 (hash dropout in train mode), whatever cfg.dropout
    says, as the reference builds it."""

    def __init__(self, d_model: int, n_heads: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dropout)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = dense(d_model, dim_feedforward)
        self.linear2 = dense(dim_feedforward, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.dropout1, self.dropout2, self.dropout3 = (Dropout(dropout) for _ in range(3))

    def forward(self, x):
        x = self.norm1(x + self.dropout1(self.self_attn(x, x, x)))
        y = self.linear2(self.dropout2(torch.relu(self.linear1(x))))
        return self.norm2(x + self.dropout3(y))


def _gate(d_in: int) -> nn.Sequential:
    return nn.Sequential(dense(d_in, 1), nn.Tanh(), nn.ReLU())


class TPatchGNN(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        hid, te_dim, node_dim, N = cfg.hid_dim, cfg.te_dim, cfg.node_dim, cfg.input_dim
        self.M = M = finalize_patching(cfg).npatch
        ttcn_dim = hid - 1
        F_in = 1 + te_dim
        self.te_scale = dense(1, 1)
        self.te_periodic = dense(1, te_dim - 1)
        self.filter_generators = nn.Sequential(
            dense(F_in, ttcn_dim), nn.ReLU(), dense(ttcn_dim, ttcn_dim), nn.ReLU(),
            dense(ttcn_dim, F_in * ttcn_dim))
        self.T_bias = nn.Parameter(torch.randn(1, ttcn_dim))
        self.nodevec1 = nn.Parameter(torch.randn(N, node_dim))
        self.nodevec2 = nn.Parameter(torch.randn(node_dim, N))
        for layer in range(cfg.nlayer):
            for tl in range(cfg.tf_layer):
                setattr(self, f"tf_{layer}_{tl}", TorchTransformerEncoderLayer(hid, cfg.n_heads))
            setattr(self, f"nodevec_gate1_{layer}", _gate(hid + node_dim))
            setattr(self, f"nodevec_gate2_{layer}", _gate(hid + node_dim))
            setattr(self, f"nodevec_linear1_{layer}", dense(hid, node_dim))
            setattr(self, f"nodevec_linear2_{layer}", dense(hid, node_dim))
            setattr(self, f"gconv_mlp_{layer}", dense((cfg.hop + 1) * hid, hid))
        if cfg.outlayer == "CNN":
            self.temporal_agg = nn.Conv1d(hid, hid, kernel_size=M)
            variance_scaling_(self.temporal_agg.weight, 1.0, hid * M)
            with torch.no_grad():
                self.temporal_agg.bias.zero_()
        else:  # Linear
            self.temporal_agg = dense(M * hid, hid)
        self.decoder = nn.Sequential(dense(hid + te_dim, hid), nn.ReLU(), dense(hid, hid),
                                     nn.ReLU(), dense(hid, 1))

    def learnable_te(self, tt):  # (..., 1) -> (..., te_dim)
        return torch.cat([self.te_scale(tt), torch.sin(self.te_periodic(tt))], dim=-1)

    def forward(self, tp_to_predict, observed_data, observed_tp, observed_mask):
        cfg = self.cfg
        hid = cfg.hid_dim
        B, M, L, N = observed_data.shape
        Lp = tp_to_predict.shape[1]

        # fold to (B*N*M, L, 1) like the reference (:270-277)
        fold = lambda a: a.permute(0, 3, 1, 2).reshape(-1, L, 1)
        X, tt, mask = fold(observed_data), fold(observed_tp), fold(observed_mask)
        X = torch.cat([X, self.learnable_te(tt)], dim=-1)  # (BNM, L, 1 + te_dim)

        # TTCN (:182-195)
        Filter = self.filter_generators(X)  # (BNM, L, F_in * ttcn)
        Filter_mask = Filter * mask + (1 - mask) * (-1e8)
        Filter_seqnorm = torch.softmax(Filter_mask, dim=-2).reshape(-1, L, hid - 1, X.shape[-1])
        ttcn_out = (X[:, :, None, :] * Filter_seqnorm).sum(dim=-3).sum(dim=-1)
        h_t = torch.relu(ttcn_out + self.T_bias)  # (BNM, ttcn_dim)
        mask_patch = (mask.sum(dim=1) > 0).to(h_t.dtype)  # (BNM, 1)
        x = torch.cat([h_t, mask_patch], dim=-1).reshape(B, N, M, hid)

        pe = pe_table(M, hid, x.device).to(x.dtype)
        for layer in range(cfg.nlayer):
            x_last = x
            # Transformer over the patch axis (:217-220)
            xt = x.reshape(B * N, M, hid) + pe
            for tl in range(cfg.tf_layer):
                xt = getattr(self, f"tf_{layer}_{tl}")(xt)
            x = xt.reshape(B, N, M, hid)

            # time-adaptive graph structure (:222-234)
            nv1 = self.nodevec1[None, None].expand(B, M, N, cfg.node_dim)
            nv2 = self.nodevec2[None, None].expand(B, M, cfg.node_dim, N)
            gate1 = getattr(self, f"nodevec_gate1_{layer}")(
                torch.cat([x, nv1.permute(0, 2, 1, 3)], dim=-1))
            gate2 = getattr(self, f"nodevec_gate2_{layer}")(
                torch.cat([x, nv2.permute(0, 3, 1, 2)], dim=-1))
            x_p1 = gate1 * getattr(self, f"nodevec_linear1_{layer}")(x)
            x_p2 = gate2 * getattr(self, f"nodevec_linear2_{layer}")(x)
            nv1 = nv1 + x_p1.permute(0, 2, 1, 3)  # (B, M, N, node_dim)
            nv2 = nv2 + x_p2.permute(0, 2, 3, 1)  # (B, M, node_dim, N)
            adp = torch.softmax(torch.relu(nv1 @ nv2), dim=-1)  # (B, M, N, N)

            # gcn k-hop (:37-61): x (B, F, N, M), A (B, M, N, N)
            xg = x.permute(0, 3, 1, 2)
            out = [xg]
            x1 = xg
            for _ in range(cfg.hop):
                x1 = torch.einsum("bfnm,bmnv->bfvm", x1, adp)
                out.append(x1)
            hcat = torch.cat(out, dim=1).permute(0, 2, 3, 1)  # (B, N, M, (hop+1)F)
            x = torch.relu(getattr(self, f"gconv_mlp_{layer}")(hcat))
            if layer > 0:
                x = x_last + x

        # temporal aggregation (:243-251)
        if cfg.outlayer == "CNN":
            h = self.temporal_agg(x.reshape(B * N, M, hid).transpose(1, 2)).reshape(B, N, hid)
        else:
            h = self.temporal_agg(x.reshape(B, N, M * hid))

        # decoder (:282-291)
        h = h[:, :, None, :].expand(B, N, Lp, hid)
        t_hat = tp_to_predict[:, None, :, None].expand(B, N, Lp, 1)
        out = self.decoder(torch.cat([h, self.learnable_te(t_hat)], dim=-1))[..., 0]
        return out.transpose(1, 2)  # (B, Lp, N)
