"""dropout_impl="flax": the port's flax nn.Dropout masks against the JAX
package, on the CPU, bit for bit under rng_impl="threefry2x32".

- kernels/dropout's mask (`keep_mask_reference`, the plain version) with
  layers/jax_prng's `site_hash` against jax.random.bernoulli of
  jax.random.fold_in and of flax's LazyRng.as_jax_rng(); past 2^32 against
  JAX's threefry2x32 on the flat index's counters; layers/jax_prng's
  `KeyChain` against the JAX trainer's chain;
- kernels/dropout's plain version (the wrapper on CPU tensors) against
  `imm_tsf_tpu.layers.fast_dropout.Dropout(impl="flax")`: output and
  gradient at rates 0.1 and 0.3, float32 and bf16; at a flat offset a
  block of the global mask, past 2^32 too;
- trainer.make_forward takes one step key a train-mode forward from the
  chain build_run attaches to the model, and none in eval mode;
- every backbone with both fusion pairs (six here, five in
  tests/test_torch_flax_dropout_sites.py): the (scope path, counter) of
  each dropout draw of one train-mode forward equals what the JAX forward
  draws (flax's `Scope.make_rng` recorded), and the forward through
  `params_from_jax` matches the JAX one to 2e-5 (ProbSparse's train
  sample and the latent models' z0 noise pinned on both sides: those
  draws stay the port's own generators);
- the refusals: flax under rng_impl="rbg", and a flax site outside a
  training step's key.
"""

import jax
import jax.extend.random as jax_random_ext
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import imm_tsf_tpu.layers.prob_attention as jpa
import imm_tsf_tpu.models.latent_ode as jlatent_ode
import imm_tsf_tpu.models.neural_flow as jneural_flow
import imm_tsf_tpu.training.trainer as jtrainer
from flax.core import scope as flax_scope
from imm_tsf_tpu.config import Config as JConfig
from imm_tsf_tpu.fusion.fusion_model import FusionModel as JFusionModel
from imm_tsf_tpu.layers import fast_dropout as jdropout
from imm_tsf_tpu.models import get_model as j_get_model

import imm_tsf_torch.layers.prob_attention as tpa
from imm_tsf_torch.config import Config as TConfig
from imm_tsf_torch.convert import assign_flax_sites
from imm_tsf_torch.kernels.dropout import flax_dropout, keep_mask_reference
from imm_tsf_torch.layers import jax_prng
from imm_tsf_torch.layers.fast_dropout import Dropout, flax_step
from imm_tsf_torch.training.trainer import check_trainable, make_forward
from torch_port_parity import pinned_z0, port_modules, tensors

torch.set_num_threads(1)

PAIRS = (("TTF_RecAvg", "MMF_GR_Add"), ("TTF_T2V_XAttn", "MMF_XAttn_Add"))


def key_words(key) -> tuple[int, int]:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


def jax_key(seed: int):
    return jax.random.key(seed, impl="threefry2x32")


# ------------------------------------------------------------ the site's mask
def jax_keep(key, keep_prob: float, shape) -> torch.Tensor:
    return torch.from_numpy(np.array(jax.random.bernoulli(key, keep_prob, shape)))


def jax_global_keep(key, site: int, keep_prob: float, n: int, offset: int) -> torch.Tensor:
    """Elements offset .. offset + n of jax.random.bernoulli(fold_in(key,
    site), keep_prob) over a mask too large to draw: JAX's threefry2x32 on
    the counters (hi, lo) of the 64-bit flat index, as the partitionable
    jax.random.bits splits it, then bernoulli's uniform."""
    k = jax.random.key_data(jax.random.fold_in(key, np.uint32(site)))
    i = np.arange(n, dtype=np.uint64) + np.uint64(offset)
    count = np.concatenate([(i >> np.uint64(32)).astype(np.uint32),
                            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)])
    out = np.asarray(jax_random_ext.threefry_2x32((k[0], k[1]), jnp.asarray(count)))
    bits = out[:n] ^ out[n:]
    u = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return torch.from_numpy(u < np.float32(keep_prob))


@pytest.mark.parametrize("data", [0, 1, 0x7FFFFFFF, 0xFFFFFFFF, 2654435769])
def test_keep_mask_reference_folds_the_site_as_jax_fold_in(data):
    """keep_mask_reference(key, site) draws from jax.random.fold_in(key, site)."""
    key = jax_key(11)
    got = keep_mask_reference(torch.tensor(key_words(key)), data, 0.9, (5, 13))
    assert torch.equal(got, jax_keep(jax.random.fold_in(key, np.uint32(data)), 0.9, (5, 13)))


@pytest.mark.parametrize("path, counter", [((), 1), (("Dropout_0",), 1),
                                           (("enc_layer_0", "Dropout_2"), 1),
                                           (("enc_embedding", "Dropout_0"), 4),
                                           (("encoder", "ap_block_1", "mixer_0", "patch_mixer",
                                             "mlp", "Dropout_1"), 1),
                                           (("ttf", "attn", "Dropout_0"), 300)])
def test_site_mask_is_flax_make_rngs(path, counter):
    """The mask at site_hash(path, counter) is drawn from flax's key for
    that scope's counter-th make_rng (LazyRng with the path and the
    counter as its suffix, flax/core/scope.py)."""
    key = jax_key(5)
    want = flax_scope.LazyRng.create(key, *path, counter).as_jax_rng()
    got = keep_mask_reference(torch.tensor(key_words(key)), jax_prng.site_hash(path, counter),
                              0.7, (257,))
    assert torch.equal(got, jax_keep(want, 0.7, (257,)))


@pytest.mark.parametrize("keep_prob", [0.9, 0.7, 0.5])
@pytest.mark.parametrize("shape", [(7,), (3, 50, 7), (2, 4, 16, 16)])
def test_keep_mask_reference_is_jax_bernoulli(keep_prob, shape):
    """The mask and, from flat index k on, a block of it."""
    key, site = jax_key(3), jax_prng.site_hash(("enc_layer_0", "Dropout_1"), 1)
    tkey = torch.tensor(key_words(key))
    want = jax_keep(jax.random.fold_in(key, np.uint32(site)), keep_prob, shape)
    assert torch.equal(keep_mask_reference(tkey, site, keep_prob, shape), want)
    flat = want.reshape(-1)
    k = flat.numel() // 3
    assert torch.equal(keep_mask_reference(tkey, site, keep_prob, (flat.numel() - k,), k),
                       flat[k:])


@pytest.mark.parametrize("offset", [0, 1000])
def test_keep_mask_reference_is_jax_bernoulli_of_the_site_key(offset):
    """The kernel's plain version (int64 torch ops) against JAX itself:
    bernoulli(fold_in(key, site), keep_prob) over the global mask, from
    flat index `offset` on; and jax_global_keep, which draws that block
    alone, against the same."""
    key, site, shape = jax_key(21), jax_prng.site_hash(("enc_layer_0", "Dropout_1"), 1), (6, 9)
    flat = jax_keep(jax.random.fold_in(key, np.uint32(site)), 0.9, (offset + 54,))
    got = keep_mask_reference(torch.tensor(key_words(key)), site, 0.9, shape, offset)
    assert torch.equal(got, flat[offset:].reshape(shape))
    assert torch.equal(jax_global_keep(key, site, 0.9, 54, offset), flat[offset:])


def test_key_chain_is_the_jax_trainers():
    """KeyChain(seed): key(seed), split off the init's key, then one split a
    step; its state continues the chain after a save."""
    chain, rng = jax_prng.KeyChain(3), jax_key(3)
    rng, _ = jax.random.split(rng)
    for _ in range(4):
        rng, step = jax.random.split(rng)
        assert chain.next() == key_words(step)
    again = jax_prng.KeyChain(0)
    again.set_state(chain.get_state())
    assert again.get_state() == {"rng": list(key_words(rng)), "rng_impl": "threefry2x32"}
    assert again.next() == chain.next()


# ------------------------------------------------ the dropout's plain version
def _jax_dropout(x, rate, key, g):
    """The JAX package's flax-mode Dropout as the root module: output and
    the VJP of g."""
    mod = jdropout.Dropout(rate, impl="flax")
    f = lambda v: mod.apply({}, v, deterministic=False, rngs={"dropout": key})
    out, vjp = jax.vjp(f, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flax_dropout_matches_jax_output_and_gradient(rate, dtype):
    rng = np.random.default_rng(int(rate * 10))
    x = rng.standard_normal((4, 6, 33)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                          torch.float32)
    key = jax_key(9)
    want, want_g = _jax_dropout(jnp.asarray(x, jdt), rate, key, jnp.asarray(g, jdt))
    drop = Dropout(rate)
    drop.impl, drop.flax_path = "flax", ()
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    with flax_step(key=key_words(key)) as sites:
        out = drop(xt)
    out.backward(torch.from_numpy(g).to(tdt))
    assert sites.drawn == [((), 1)]
    assert torch.equal(out.detach().float(), torch.from_numpy(want.astype(np.float32)))
    assert torch.equal(xt.grad.float(), torch.from_numpy(want_g.astype(np.float32)))
    # the mask does not depend on the dtype (x holds no zero)
    site = jax_prng.site_hash((), 1)
    keep = keep_mask_reference(torch.tensor(key_words(key)), site, 1.0 - rate, x.shape)
    assert (x != 0).all() and torch.equal(keep, torch.from_numpy(want != 0))


@pytest.mark.parametrize("offset", [0, 3000, 2**32 - 100, 3 * 2**32 + 5])
def test_flax_dropout_at_an_offset_is_a_block_of_the_global_mask(offset):
    """A rank's block (flat offset, a 64-bit index: counters (hi, lo)) is
    the global mask's elements from that index on."""
    key = jax_key(123456789)
    site = jax_prng.site_hash(("mmf", "Dropout_0"), 1)
    x = torch.randn(5, 7, 11, generator=torch.Generator().manual_seed(0))
    out = flax_dropout(x, torch.tensor(key_words(key)), site, 0.8, offset)
    keep = jax_global_keep(key, site, 0.8, x.numel(), offset).reshape(x.shape)
    assert torch.equal(out, torch.where(keep, x / 0.8, 0.0))


# ------------------------------------------------------- every backbone's sites
def _record_jax_sites(monkeypatch) -> list:
    """(path, counter) of every make_rng a Dropout module makes while the
    list is live (the JAX forward is traced once under jit)."""
    drawn: list = []
    make_rng = flax_scope.Scope.make_rng

    def recording(self, name="params"):
        key = make_rng(self, name)
        if self.path and self.path[-1].startswith("Dropout_"):
            drawn.append((tuple(self.path), self.rng_counters[name]))
        return key

    monkeypatch.setattr(flax_scope.Scope, "make_rng", recording)
    return drawn


def _pin_other_draws(monkeypatch, model: str) -> None:
    """ProbSparse's train sample and the z0 noise: the port's own
    generators (not the dropout stream), pinned on both sides."""
    if model == "Informer":
        import types

        pinned = types.SimpleNamespace(
            PRNGKey=jax.random.PRNGKey,
            randint=lambda key, shape, lo, hi: jax.random.randint(jax.random.PRNGKey(0),
                                                                   shape, lo, hi))
        monkeypatch.setattr(jpa, "jax", types.SimpleNamespace(random=pinned, lax=jax.lax))
        monkeypatch.setattr(tpa, "train_sample", lambda L_Q, U, L_K, device, gen:
                            tpa.eval_sample(L_Q, U, L_K, device))
    elif model in ("LatentODE", "NeuralFlow"):
        eps = np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32)
        pinned_z0(monkeypatch, jlatent_ode if model == "LatentODE" else jneural_flow, eps)


# the backbones of this file; tests/test_torch_flax_dropout_sites.py holds the rest
MODELS_HERE = ("CRU", "DLinear", "LatentODE", "NeuralFlow", "PatchTST", "tPatchGNN")


_BACKBONES: dict = {}  # model -> its JAX side, shared by the two pairs' tests


def _jax_backbone(model: str, key, monkeypatch) -> dict:
    """`model`'s JAX side (backbone_case's config, batch and init key,
    without the fusion stack; its leaves moved off the init), its
    train-mode output under `key` and the draws of that forward, computed
    once for both fusion pairs: the backbone's sites and output do not
    depend on the pair."""
    if model not in _BACKBONES:
        from imm_tsf_tpu.serving import collate_chunks

        from torch_port_parity import (BF16_BASE, BF16_MODELS, D_TXT, perturbed,
                                       sample_chunks)

        jcfg = JConfig(**{**BF16_BASE, "model": model, **BF16_MODELS[model],
                          "compute_dtype": "float32", "dropout": 0.1,
                          "dropout_impl": "flax", "rng_impl": "threefry2x32"})
        batch = collate_chunks(jcfg, sample_chunks(jcfg.input_dim), D_TXT, 14.0, 8)
        batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
        jm = j_get_model(jcfg)
        params, stats = jax.jit(lambda k: jtrainer.init_state(jcfg, jm, None, batch, k))(
            jax.random.PRNGKey(3))
        params = {"model": perturbed(params["model"], 0.02)}
        stats = jax.tree_util.tree_map(np.asarray, stats)
        drawn = _record_jax_sites(monkeypatch)
        fwd = jtrainer.make_forward(jcfg, jm, None)
        pred = jax.jit(lambda p, s, b, k: fwd(p, s, b, True, k)[0])(params, stats, batch, key)
        _BACKBONES[model] = dict(jcfg=jcfg, batch=batch, params=params, stats=stats,
                                 pred=pred, drawn=list(drawn))
        monkeypatch.undo()
    return _BACKBONES[model]


def check_train_forward(model: str, pair: tuple, monkeypatch) -> None:
    """One train-mode forward of `model` + `pair` in both packages under
    one step key (the JAX trainer's make_forward: the backbone's apply,
    then the fusion stack's under the same key and dropout impl): the same
    dropout draws, outputs to 2e-5."""
    key = jax_key(5)
    _pin_other_draws(monkeypatch, model)
    back = _jax_backbone(model, key, monkeypatch)
    _pin_other_draws(monkeypatch, model)
    jcfg = back["jcfg"].replace(TTF_module=pair[0], MMF_module=pair[1])
    batch = back["batch"]
    jf = JFusionModel(jcfg)
    fusion_args = lambda last: (batch["notes_embeddings"], batch["tau"], batch["tp_to_predict"],
                                last, batch["notes_mask"])
    fparams = jax.jit(lambda k: jf.init({"params": k, "dropout": k},
                                        *fusion_args(batch["data_to_predict"]),
                                        train=False))(jax.random.PRNGKey(4))["params"]
    fparams = jax.tree_util.tree_map(np.asarray, fparams)
    if "log_recency_sigma" in fparams["ttf"]:  # TTF_RecAvg's sigma off its init
        fparams["ttf"]["log_recency_sigma"] = np.float32(np.log(1.7))
    drawn = _record_jax_sites(monkeypatch)
    with jdropout.use_dropout_impl("flax"):  # as the JAX make_forward binds it
        want = np.asarray(jax.jit(lambda fp, last, k: jf.apply(
            {"params": fp}, *fusion_args(last), train=True, rngs={"dropout": k}))(
            fparams, back["pred"], key))
    drawn = back["drawn"] + drawn
    monkeypatch.undo()
    _pin_other_draws(monkeypatch, model)

    tcfg, tm, tf = port_modules(jcfg, dict(back["params"], fusion=fparams), back["stats"])
    for mod in (tm, tf):
        assign_flax_sites(mod)
        mod.train()
    forward = make_forward(tcfg, tm, tf)
    with flax_step(key=key_words(key)) as sites:
        got = forward(tensors(batch)).detach().numpy()
    # the same draws (Informer's decoder embedding is called first in JAX)
    assert sorted(sites.drawn) == sorted(drawn) and len(drawn) >= 2
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("pair", PAIRS, ids=["recavg_gr_add", "t2v_xattn"])
@pytest.mark.parametrize("model", MODELS_HERE)
def test_train_forward_sites_and_output_match_jax(model, pair, monkeypatch):
    check_train_forward(model, pair, monkeypatch)


# ---------------------------------------------- make_forward takes the key
class _OneSite(torch.nn.Module):
    """A backbone of one flax-mode site on the observed data."""

    def __init__(self):
        super().__init__()
        self.drop = Dropout(0.5)
        self.drop.impl, self.drop.flax_path = "flax", ("Dropout_0",)

    def forward(self, tp, data, observed_tp, mask):
        return self.drop(data)


def test_make_forward_takes_one_step_key_from_the_models_chain():
    """With a key chain on the model (build_run's `flax_keys`), a
    train-mode forward draws from the chain's next key, one split a
    forward; an eval-mode forward draws nothing."""
    net = _OneSite()
    net.flax_keys = jax_prng.KeyChain(3)
    data = torch.randn(2, 5, 4, generator=torch.Generator().manual_seed(0))
    batch = {"tp_to_predict": None, "observed_data": data, "observed_tp": None,
             "observed_mask": None}
    forward = make_forward(TConfig(model="DLinear"), net, None)
    chain = jax_prng.KeyChain(3)
    for _ in range(2):
        step = torch.tensor(chain.next())
        want = flax_dropout(data, step, jax_prng.site_hash(("Dropout_0",), 1), 0.5)
        assert torch.equal(forward(batch), want)
    net.eval()
    assert torch.equal(forward(batch), data)
    assert net.flax_keys.get_state() == chain.get_state()


# ------------------------------------------------------------ refusals
def test_flax_refused_under_rbg_and_taken_under_threefry():
    base = dict(model="PatchTST", enable_text=True, use_text_embeddings=True,
                dropout_impl="flax")
    with pytest.raises(NotImplementedError, match="Queue 1, item 19") as err:
        check_trainable(TConfig(**base))
    assert "--rng_impl threefry2x32" in str(err.value) and "RngBitGenerator" in str(err.value)
    check_trainable(TConfig(**base, rng_impl="threefry2x32"))


def test_flax_site_outside_a_training_step_raises():
    drop = Dropout(0.1)
    drop.impl, drop.flax_path = "flax", ("Dropout_0",)
    with pytest.raises(RuntimeError, match="flax_step"):
        drop(torch.ones(3))
    assert torch.equal(drop.eval()(torch.ones(3)), torch.ones(3))
