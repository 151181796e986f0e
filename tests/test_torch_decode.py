"""Decode of every model family against the JAX package's, at ``reduced``
size in float32, the reference's own initial weights carried across by
`params_from_jax`: the nine decoders' ``decode_step`` token by token (or
frame by frame, for the embeddings model) against the reference's, the
port's decode against its own full forward, the sliding window's rolling
cache across a wrap, the hybrid with a tail of mixers, MoE at a capacity
where no pair drops, and the continuous engine's joins: a joined SSM or
hybrid lane against a fresh lane bit for bit (and not so with the reset
removed), a joined RoPE lane against a static batch at the same absolute
positions.

Tolerances: against the reference, rtol 1e-4 / atol 1e-5 on the logits
(float32 in both, sums taken in another order); decode against the
forward, 2e-2 as the reference's own test (`tests/test_models.py:70-96`),
and 1e-4 where MoE drops no pair on either side.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.config import reduced as jreduced  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.config import get_arch, reduced  # noqa: E402
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import continuous  # noqa: E402

CPU = "cpu"
DECODERS = [a for a in ASSIGNED if get_arch(a).has_decode]
TOL = dict(rtol=1e-4, atol=1e-5)
JRT = jmodel.Runtime(compute_dtype=jnp.float32)
TRT = tmodel.Runtime(torch.float32)


@functools.lru_cache(maxsize=None)
def setup(arch, **changes):
    """(reference cfg, port cfg, reference params, port params) at reduced
    size with ``changes`` applied to both configs."""
    jcfg = dataclasses.replace(jreduced(jget_arch(arch)), **changes)
    tcfg = dataclasses.replace(reduced(get_arch(arch)), **changes)
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device=CPU)
    return jcfg, tcfg, jp, tp


def inputs(cfg, B, T, seed=0):
    """(B, T) token ids, or (B, T, d_model) frame embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    return (0.1 * rng.standard_normal((B, T, cfg.d_model))).astype(
        np.float32)


def make_batch(cfg, B, S, seed):
    """`tests/test_models.py`'s ``make_batch`` inputs (jax.random)."""
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    if cfg.input_mode == "tokens":
        return {"tokens": jax.random.randint(k1, (B, S), 0, cfg.vocab_size)}
    return {"embeddings": 0.1 * jax.random.normal(k1, (B, S, cfg.d_model))}


def step_input(cfg, x, t, lib):
    key = "tokens" if cfg.input_mode == "tokens" else "embeddings"
    return {key: lib(x[:, t:t + 1])}


def jax_decode(jcfg, jp, x, max_len):
    """The reference's decode_step over every position of ``x``."""
    step = jax.jit(lambda p, b, c, i: jmodel.decode_step(p, jcfg, JRT, b, c,
                                                         i))
    caches = jmodel.init_decode_caches(jcfg, x.shape[0], max_len,
                                       dtype=jnp.float32)
    out = []
    for t in range(x.shape[1]):
        logits, caches = step(jp, step_input(jcfg, x, t, jnp.asarray),
                              caches, jnp.int32(t))
        out.append(np.asarray(logits))
    return np.concatenate(out, 1)


def torch_decode(tcfg, tp, x, max_len, rt=TRT, index0=0, starts=None,
                 joins=None, caches=None):
    """The port's slot step (`continuous.make_slot_step`: the join-time
    reset, then decode_step) over every position of ``x``, at absolute
    positions ``index0 + t``; ``starts``/``joins`` per step or None."""
    B, T = x.shape[:2]
    if caches is None:
        caches = tmodel.init_decode_caches(tcfg, B, max_len,
                                           dtype=torch.float32, device=CPU)
    step = continuous.make_slot_step(tcfg, rt)
    out = []
    for t in range(T):
        start = None if starts is None else torch.as_tensor(starts[t])
        join = torch.as_tensor(np.zeros(B, bool) if joins is None
                               else joins[t])
        logits, caches = step(tp, step_input(tcfg, x, t, torch.as_tensor),
                              caches, index0 + t, start, join)
        out.append(logits.numpy())
    return np.concatenate(out, 1)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_step_matches_jax(arch):
    """16 positions through both packages' decode_step (MoE at the default
    capacity, where the same pairs drop on both sides): the logits at
    every position."""
    jcfg, tcfg, jp, tp = setup(arch)
    x = inputs(tcfg, 2, 16, seed=1)
    np.testing.assert_allclose(torch_decode(tcfg, tp, x, 16),
                               jax_decode(jcfg, jp, x, 16), **TOL)


@pytest.mark.parametrize("arch", DECODERS)
def test_decode_matches_forward(arch):
    """Token-by-token decode with caches reproduces the port's full
    forward: the port's mirror of the reference's test_decode_matches_forward
    (`tests/test_models.py:70-96`), on its weights (key 1) and inputs
    (`make_batch`, seed 3), at its tolerance. It covers GQA with RoPE, the
    rolling window, MLA's absorbed decode, the SSM state and the hybrid's
    shared-attention caches; MoE at the default capacity, as there (decode
    equals the forward only while the forward drops no pair, which these
    inputs give; `test_moe_decode_matches_forward_where_no_pair_drops`
    holds it where none can drop)."""
    jcfg, tcfg, _, _ = setup(arch)
    tp = params_from_jax(jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(1), jcfg)), tcfg, device=CPU)
    key = "tokens" if tcfg.input_mode == "tokens" else "embeddings"
    x = np.array(make_batch(jcfg, B=2, S=16, seed=3)[key])
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, TRT, {key: torch.as_tensor(x)})
    np.testing.assert_allclose(torch_decode(tcfg, tp, x, 16), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_rolling_cache_holds_the_window_across_a_wrap():
    """h2o-danube's reduced window of 32: the cache holds 32 slots however
    long ``max_len`` is, and 48 positions (past the ring's wrap) equal the
    reference's decode and the port's forward, whose mask keeps the 32
    latest keys."""
    jcfg, tcfg, jp, tp = setup("h2o-danube-3-4b")
    assert tcfg.sliding_window == 32
    caches = tmodel.init_decode_caches(tcfg, 2, 512, device=CPU)
    assert all(c["k"].shape[1] == 32 and c["pos"].shape == (32,)
               for c in caches["layers"])
    x = inputs(tcfg, 2, 48, seed=4)
    got = torch_decode(tcfg, tp, x, 48)
    np.testing.assert_allclose(got, jax_decode(jcfg, jp, x, 48), **TOL)
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, TRT, {"tokens": torch.as_tensor(x)})
    np.testing.assert_allclose(got, full.numpy(), rtol=1e-4, atol=1e-4)


def test_hybrid_with_a_tail_matches_jax():
    """Zamba2 with 5 layers and a shared block every 2: two groups and a
    tail of one mixer (`tail` caches on both sides)."""
    jcfg, tcfg, jp, tp = setup("zamba2-7b", n_layers=5)
    caches = tmodel.init_decode_caches(tcfg, 2, 16, device=CPU)
    assert (len(caches["layers"]), len(caches["tail"]),
            len(caches["shared"])) == (4, 1, 2)
    x = inputs(tcfg, 2, 16, seed=5)
    np.testing.assert_allclose(torch_decode(tcfg, tp, x, 16),
                               jax_decode(jcfg, jp, x, 16), **TOL)


def count_drops(monkeypatch, rt):
    """Record the (token, choice) pairs each MoE call drops at its
    capacity for ``rt``: returns the list it appends to."""
    drops = []
    route = tmoe.route

    def counted(params, prefix, cfg, xf, rt_=None):
        out = route(params, prefix, cfg, xf, rt_)
        C = tmoe._capacity(xf.shape[0], cfg.moe_top_k, cfg.n_experts,
                           rt.moe_capacity_factor)
        drops.append(int(tmoe.dropped(out[2], cfg.n_experts, C)))
        return out

    monkeypatch.setattr(tmoe, "route", counted)
    return drops


@pytest.mark.parametrize("arch", ["arctic-480b", "deepseek-v2-236b"])
def test_moe_decode_matches_forward_where_no_pair_drops(arch, monkeypatch):
    """At a capacity factor of E / k every expert can take every token, so
    no pair drops in the forward (T = B S) nor in decode (T = B) and decode
    is the forward's function: within 1e-4, the drops counted."""
    _, tcfg, _, tp = setup(arch)
    rt = tmodel.Runtime(torch.float32, moe_capacity_factor=tcfg.n_experts
                        / tcfg.moe_top_k)
    drops = count_drops(monkeypatch, rt)
    x = inputs(tcfg, 2, 16, seed=6)
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, rt, {"tokens": torch.as_tensor(x)})
    got = torch_decode(tcfg, tp, x, 16, rt=rt)
    n_moe = tcfg.n_layers - tcfg.first_dense_layers
    assert len(drops) == n_moe * 17 and sum(drops) == 0
    np.testing.assert_allclose(got, full.numpy(), rtol=1e-4, atol=1e-4)


S_JOIN, T_JOIN = 6, 14  # lane 1's request joins at position 6 of 14


def joined(tcfg, tp, x, seed=9):
    """Lane 0 decodes ``x[0]`` from position 0; lane 1 decodes another
    occupant's tokens, then ``x[1, S_JOIN:]`` joins it at S_JOIN (``start``
    = S_JOIN, the join mask set once). Returns the logits (2, T, V)."""
    lane1 = inputs(tcfg, 1, T_JOIN, seed=seed)[0]
    lane1[S_JOIN:] = x[1, S_JOIN:]
    xs = np.stack([x[0], lane1])
    starts = [np.array([0, 0 if t < S_JOIN else S_JOIN], np.int32)
              for t in range(T_JOIN)]
    joins = [np.array([False, t == S_JOIN]) for t in range(T_JOIN)]
    return torch_decode(tcfg, tp, xs, T_JOIN, starts=starts, joins=joins)


def fresh(tcfg, tp, x):
    """The same two lanes from position S_JOIN on, in fresh caches."""
    return torch_decode(tcfg, tp, x[:, S_JOIN:], T_JOIN, index0=S_JOIN,
                        starts=[np.array([0, S_JOIN], np.int32)]
                        * (T_JOIN - S_JOIN))


@pytest.mark.parametrize("arch,changes,plant", [
    ("mamba2-2.7b", (), "no_reset"),
    ("zamba2-7b", (("n_layers", 5),), "layers_only")])
def test_joined_recurrent_lane_equals_a_fresh_lane(arch, changes, plant,
                                                   monkeypatch):
    """A lane that joins over a previous occupant's SSM state: with the
    join-time reset its logits equal a fresh lane's at the same positions
    bit for bit. Planted: no reset at all (Mamba2); the reset of
    ``layers`` only, the hybrid's ``tail`` mixer left stale (Zamba2) —
    then they differ."""
    _, tcfg, _, tp = setup(arch, **dict(changes))
    x = inputs(tcfg, 2, T_JOIN, seed=7)
    want = fresh(tcfg, tp, x)[1]
    assert np.array_equal(joined(tcfg, tp, x)[1, S_JOIN:], want)
    def layers_only(caches, mask):  # the hybrid's tail left stale
        for c in caches["layers"]:
            for leaf in (c["state"], c["conv"]):
                leaf.mul_((~mask).to(leaf.dtype).reshape(
                    (-1,) + (1,) * (leaf.ndim - 1)))
        return caches

    monkeypatch.setattr(continuous, "_reset_joined", {
        "no_reset": lambda caches, mask: caches,
        "layers_only": layers_only}[plant])
    assert not np.allclose(joined(tcfg, tp, x)[1, S_JOIN:], want,
                           rtol=1e-4, atol=1e-4)


def test_joined_rope_lane_equals_a_static_batch_at_its_positions():
    """Llama's RoPE: a request that joins at S_JOIN is rotated at positions
    S_JOIN, S_JOIN + 1, ... (the reference's rotation at write time): its
    logits equal the request decoded alone from position S_JOIN."""
    _, tcfg, _, tp = setup("llama3.2-1b")
    x = inputs(tcfg, 2, T_JOIN, seed=8)
    got = joined(tcfg, tp, x)[1, S_JOIN:]
    want = torch_decode(tcfg, tp, x[1:, S_JOIN:], T_JOIN, index0=S_JOIN)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_rope_and_ring_slot_read_the_index():
    """The decode's position-dependent parts follow ``index``: a sliding
    window's rows go to ``index % slots``, and under RoPE (which sees only
    the distance between positions) a second token one position after the
    first gives other logits than four positions after it."""
    _, tcfg, _, tp = setup("h2o-danube-3-4b")

    def two_tokens(second):
        caches = tmodel.init_decode_caches(tcfg, 1, 64, dtype=torch.float32,
                                           device=CPU)
        with torch.no_grad():
            for tok, at in ((3, 40), (5, second)):
                logits, _ = tmodel.decode_step(
                    tp, tcfg, TRT, {"tokens": torch.tensor([[tok]])}, caches,
                    at)
        return logits, caches["layers"][0]["pos"]

    near, pos = two_tokens(41)
    assert pos.tolist() == [-1] * 8 + [40, 41] + [-1] * 22
    far, pos = two_tokens(44)
    assert int(pos[8]) == 40 and int(pos[12]) == 44
    assert int(tattn.ring_slot(tcfg, torch.tensor([40]), 32)) == 8
    assert not torch.allclose(near, far, rtol=1e-3, atol=1e-3)


def test_only_an_encoder_lacks_a_decode_step():
    """`check_decode_supported` refuses an encoder only: every other
    registered config builds its caches."""
    for arch in ASSIGNED + ["gpt2"]:
        cfg = reduced(get_arch(arch))
        if cfg.has_decode:
            assert tmodel.init_decode_caches(cfg, 2, 8, device=CPU)
        else:
            with pytest.raises(NotImplementedError, match="encoder"):
                tmodel.init_decode_caches(cfg, 2, 8, device=CPU)
