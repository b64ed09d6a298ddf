"""TimesNet's static period canvas in the port, against the JAX package
on the CPU (2e-5 absolute unless stated):

- `_bucket_partition(T, 11)` equals the JAX function for every T in
  2..200;
- `TimesBlock` through `params_from_jax` at T 36, 72 and 120 (masked
  buckets at each), k 1 and 5, on random and on constant input (every
  non-DC amplitude exactly 0, so the bins tie and go in index order), the
  bins each package picks recorded and equal;
- TimesNet, e_layers 2, at the same T and k;
- one training step's gradients against jax.grad;
- `torch.export` traces the forward (a read back to the host, such as
  `.tolist()` or `.item()`, cannot be traced), and the program picks each
  input's own periods.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.models import timesnet as jtimesnet

from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import params_from_jax
from imm_tsf_torch.models import get_model, timesnet

from torch_port_parity import assert_model_matches, model_batch, perturbed, port_state

torch.set_num_threads(1)

ATOL = 2e-5
T_CASES = (36, 72, 120)
_INITS: dict = {}  # (module, T) -> its flax init under PRNGKey(0)


def _jax_init(jm, T: int, *args):
    """jax.jit(jm.init)(PRNGKey(0), *args), made once a module class and T:
    the parameters depend on neither top_k nor the input's values (the
    candidate periods are all of T's), so the k and input cases share it."""
    key = (type(jm).__name__, T)
    if key not in _INITS:
        _INITS[key] = jax.jit(jm.init)(jax.random.PRNGKey(0), *args)
    return _INITS[key]


@pytest.mark.parametrize("T", range(2, 201))
def test_bucket_partition_equals_jax(T):
    assert timesnet._bucket_partition(T, 11) == jtimesnet._bucket_partition(T, 11)


def test_bucket_counts():
    """(candidates, buckets): 15 in 7 at T 72, 19 in 14 at T 120, 10 in 5 at
    T 36."""
    got = {T: tuple(len(a) for a in timesnet._bucket_partition(T, 11)) for T in T_CASES}
    assert got == {36: (10, 5), 72: (15, 7), 120: (19, 14)}


def _cfg_kw(T: int, k: int, **kw) -> dict:
    L = 2 * T // 3
    return dict(dict(model="TimesNet", input_dim=3, input_len=L, pred_len=T - L, d_model=4,
                     d_ff=6, top_k=k, num_kernels=6, e_layers=2), **kw)


@pytest.fixture
def recorded(monkeypatch):
    """The bins each package's TimesBlock picks, call by call."""
    rec = {"jax": [], "port": []}
    top_k, top_lags = jax.lax.top_k, timesnet.top_lags

    def j_top_k(x, k):
        out = top_k(x, k)
        jax.debug.callback(lambda v: rec["jax"].append(np.asarray(v).tolist()), out[1])
        return out

    def t_top_lags(x, k):
        out = top_lags(x, k)
        rec["port"].append(out[0].tolist())
        return out

    monkeypatch.setattr(jax.lax, "top_k", j_top_k)
    monkeypatch.setattr(timesnet, "top_lags", t_top_lags)
    return rec


@pytest.mark.parametrize("T", T_CASES)
@pytest.mark.parametrize("k, case", [(1, "random"), (5, "random"), (5, "constant")])
def test_times_block_matches_jax(recorded, T, k, case):
    cfg_kw = _cfg_kw(T, k)
    jb = jtimesnet.TimesBlock(JConfig(**cfg_kw), T)
    tb = timesnet.TimesBlock(TConfig(**cfg_kw)).eval()
    masked = [b for b, (members, hb, wb) in enumerate(tb.buckets)
              if any(h != hb or w != wb for _, (h, w) in members)]
    assert masked and all(hasattr(tb, f"mask_{b}") for b in masked)
    rng = np.random.default_rng(T + k)
    x = (rng.standard_normal((3, T, 4)) if case == "random"
         else np.full((3, T, 4), -2.5)).astype(np.float32)
    params = perturbed(_jax_init(jb, T, x)["params"])
    tb.load_state_dict(port_state(params))
    recorded["jax"].clear()  # the init's pick
    want = np.asarray(jax.jit(jb.apply)({"params": params}, x))
    with torch.inference_mode():
        got = tb(torch.from_numpy(x)).numpy()
    assert recorded["jax"] == recorded["port"] and len(recorded["port"]) == 1
    if case == "constant":  # every amplitude but DC's is 0: the tie in index order
        assert recorded["port"] == [list(range(k))]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("T", T_CASES)
@pytest.mark.parametrize("k", [1, 5])
def test_timesnet_matches_jax(T, k):
    cfg_kw = _cfg_kw(T, k)
    L, Lp = cfg_kw["input_len"], cfg_kw["pred_len"]
    batch = model_batch(T + k, B=4, L=L, Lp=Lp, K=3)
    tm = get_model(TConfig(**cfg_kw))
    jm = jtimesnet.TimesNet(JConfig(**cfg_kw))
    assert_model_matches(jm, tm, batch, ATOL, init=_jax_init(jm, T, *batch))


def test_training_step_gradients_match_jax():
    """One step's loss sum(out * g), dropout 0, T 36 and k 3: the loss to
    1e-5 relative, each parameter's gradient to 1e-4 of its own largest
    entry plus 1e-6 of the largest gradient entry overall."""
    cfg_kw = _cfg_kw(36, 3, dropout=0.0)
    batch = model_batch(7, B=4, L=cfg_kw["input_len"], Lp=cfg_kw["pred_len"], K=3)
    g = np.random.default_rng(8).standard_normal((4, cfg_kw["pred_len"], 3)).astype(np.float32)
    jm = jtimesnet.TimesNet(JConfig(**cfg_kw))
    params = perturbed(jax.jit(jm.init)(jax.random.PRNGKey(0), *batch)["params"])

    def loss(p):
        return (jm.apply({"params": p}, *batch, train=True) * g).sum()

    want_loss, want = jax.jit(jax.value_and_grad(loss))(params)
    want = params_from_jax({"model": jax.tree_util.tree_map(np.asarray, want)})[0]
    tm = get_model(TConfig(**cfg_kw))
    tm.load_state_dict(port_state(params))
    tm.train()
    got_loss = (tm(*(torch.from_numpy(a) for a in batch)) * torch.from_numpy(g)).sum()
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), float(want_loss), rtol=1e-5)
    named = dict(tm.named_parameters())
    assert set(named) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    for n, p in named.items():
        w = want[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6 * top, err_msg=n)


def _exported_equals_eager(module, inputs: list, recorded) -> list:
    """`module` exported on inputs[0]: the program's output equals the
    eager module's (run first) bit for bit on every input; returns each
    input's bins."""
    wants, picked = [], []
    for args in inputs:
        recorded["port"].clear()
        with torch.no_grad():
            wants.append(module(*args))
        picked.append(list(recorded["port"]))
    ep = torch.export.export(module, inputs[0], strict=False)
    assert not any("_local_scalar_dense" in str(n.target) for n in ep.graph.nodes)
    program = ep.module()
    for args, want in zip(inputs, wants):
        assert torch.equal(program(*args), want)
    return picked


def test_forward_exports_with_no_host_read(recorded):
    """torch.export traces the forward on the CPU, which a read back to the
    host (`.tolist()`, `.item()`) would stop. A TimesBlock's program picks
    each input's own bins (planted periods 24 and 8 at T 72: bins 3 and 9),
    and TimesNet's (e_layers 2) equals the eager module on two batches."""
    src = inspect.getsource(timesnet.TimesBlock.forward)
    assert ".tolist()" not in src and ".item()" not in src
    cfg_kw = _cfg_kw(72, 1)
    tb = timesnet.TimesBlock(TConfig(**cfg_kw)).eval()
    rng = np.random.default_rng(0)
    t = np.arange(72)
    planted = [(torch.from_numpy((np.cos(2 * np.pi * f * t / 72)[None, :, None]
                                  + 0.01 * rng.standard_normal((2, 72, 4))).astype(np.float32)),)
               for f in (3, 9)]
    assert _exported_equals_eager(tb, planted, recorded) == [[[3]], [[9]]]
    L, Lp = cfg_kw["input_len"], cfg_kw["pred_len"]
    tm = get_model(TConfig(**dict(cfg_kw, top_k=3))).eval()
    batches = [tuple(torch.from_numpy(np.ascontiguousarray(a))
                     for a in model_batch(s, B=4, L=L, Lp=Lp, K=3)) for s in (1, 2)]
    assert all(len(p) == 2 for p in _exported_equals_eager(tm, batches, recorded))
