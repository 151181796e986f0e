"""The port's GPT-2 training path against the JAX package's, on the reduced
GPT-2 with the reference's own initial weights carried across by
`params_from_jax`: loss, gradient norm and one AdamW step in float32.

Loss and gradient norm agree within 1e-4 relative and the parameters after
one step within 1e-5 absolute: both are float32, with matmuls and reductions
summed in another order.
"""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.config import reduced as jreduced  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.config import TrainConfig, get_arch, param_shapes, reduced  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import schedule as tschedule  # noqa: E402
from repro_torch.optim.optimizers import moments  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CPU = "cpu"
# vocab 256 needs no padding; 250 pads to 256 and exercises the loss mask
VOCABS = [256, 250]


def configs(vocab):
    return (dataclasses.replace(jreduced(jget_arch("gpt2")), vocab_size=vocab),
            dataclasses.replace(reduced(get_arch("gpt2")), vocab_size=vocab))


def batch(cfg, seed=0):
    return SyntheticLMData(cfg, seq_len=32, global_batch=4, seed=seed).batch(3)


def both_params(jcfg, tcfg):
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device=CPU)
    return jp, tp


@pytest.mark.parametrize("vocab", VOCABS)
def test_loss_matches_jax(vocab):
    jcfg, tcfg = configs(vocab)
    jp, tp = both_params(jcfg, tcfg)
    b = batch(tcfg)
    jl, _ = jmodel.loss_fn(jp, jcfg, jmodel.Runtime(compute_dtype=jnp.float32),
                           jax.tree.map(jnp.asarray, b))
    tl, _ = tmodel.loss_fn(tp, tcfg, tmodel.Runtime(torch.float32),
                           tmodel.batch_to_device(b, torch.device(CPU)))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4)


@pytest.mark.parametrize("vocab", VOCABS)
def test_adamw_step_matches_jax(vocab):
    """Loss and gradient norm of one step, and every parameter after it."""
    jcfg, tcfg = configs(vocab)
    jp, tp = both_params(jcfg, tcfg)
    b = batch(tcfg, seed=1)
    jopt = jstep.make_optimizer_for(JTrainConfig(learning_rate=1e-3,
                                                 total_steps=10,
                                                 warmup_steps=2))
    jstate = jstep.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jmodel.Runtime(compute_dtype=jnp.float32), jopt))
    jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, b))
    topt = tstep.make_optimizer_for(TrainConfig(learning_rate=1e-3,
                                                total_steps=10,
                                                warmup_steps=2), tcfg)
    tstate = tstep.TrainState(tp, topt.init(tp), 0)
    tfn = tstep.make_train_step(tcfg, tmodel.Runtime(torch.float32), topt)
    tstate, tm = tfn(tstate, b)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                           device=CPU)
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   want[name].detach().numpy(), rtol=0,
                                   atol=1e-5, err_msg=name)


def test_init_params_follow_param_shapes():
    cfg = reduced(get_arch("gpt2"))
    params = tmodel.init_params(cfg, seed=0, device=CPU)
    assert {k: tuple(v.shape) for k, v in params.items()} == param_shapes(cfg)
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in params.values())
    assert float(params["layers.0.norm1.scale"].detach().min()) == 1.0
    std = float(params["embed.table"].detach().std())
    assert 0.015 < std < 0.025  # normal_init scale 0.02


def test_params_from_jax_rejects_a_foreign_tree():
    jcfg, tcfg = configs(256)
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0),
                                                       jcfg))
    del tree["final_norm"]["bias"]
    with pytest.raises(ValueError, match="final_norm.bias"):
        params_from_jax(tree, tcfg, device=CPU)


def test_unported_model_features_raise():
    """Decode refuses an encoder only (it has none, nor has the reference),
    and every other family builds its caches. A mesh of more ranks than
    the process has refuses: ``--data-mesh 2`` outside ``torchrun``."""
    with pytest.raises(NotImplementedError, match="encoder"):
        tmodel.init_decode_caches(reduced(get_arch("hubert-xlarge")), 2, 16,
                                  device=CPU)
    for arch in ("deepseek-v2-236b", "llama3.2-1b", "h2o-danube-3-4b",
                 "gpt2"):
        tmodel.check_decode_supported(reduced(get_arch(arch)))
    with pytest.raises(SystemExit):
        tlaunch.main(["--reduced", "--device", "cpu", "--data-mesh", "2"])


@pytest.mark.parametrize("name", ["cosine", "linear", "constant"])
def test_schedules_match_jax(name):
    tf = tschedule.make_schedule(name, 3e-3, 10, 100)
    jf = jschedule.make_schedule(name, 3e-3, 10, 100)
    for s in (0, 1, 5, 10, 11, 50, 100, 150):
        np.testing.assert_allclose(tf(s), float(jf(s)), rtol=1e-6)


def test_cpu_step_ignores_the_cuda_graph_option():
    """The CUDA graph engages only for parameters on a card: on the CPU
    both settings run the same eager step."""
    cfg = reduced(get_arch("gpt2"))
    opt = tstep.make_optimizer_for(TrainConfig(learning_rate=1e-3,
                                               total_steps=10), cfg)
    data = SyntheticLMData(cfg, seq_len=16, global_batch=2, seed=0)
    finals = []
    for graph in (True, False):
        state = tstep.init_train_state(cfg, opt, seed=0, device=CPU)
        fn = tstep.make_train_step(cfg, tmodel.Runtime(torch.float32), opt,
                                   cuda_graph=graph)
        for s in range(3):
            state, _ = fn(state, data.batch(s))
        finals.append(state.params)
    for name in finals[0]:
        assert torch.equal(finals[0][name], finals[1][name]), name


def tensor_scalars_equal_host_floats(optimizer):
    """`Optimizer.step_` as the CUDA graph captures and replays it, with the
    step's scalars in 0-dim tensors, against the same update with host
    floats, as the eager step runs it: parameters, moments and gradient
    norms equal bit for bit over steps through the warm-up."""
    cfg = reduced(get_arch("gpt2"))
    opt = tstep.make_optimizer_for(TrainConfig(learning_rate=1e-3,
                                               total_steps=10,
                                               warmup_steps=2,
                                               optimizer=optimizer), cfg)
    gen = torch.Generator().manual_seed(0)
    runs = []
    for tensors in (False, True):
        params = tmodel.init_params(cfg, seed=0, device=CPU)
        state = opt.init(params)
        gen.manual_seed(0)
        norms = []
        for n in range(1, 5):
            grads = {k: torch.randn(p.shape, generator=gen)
                     for k, p in params.items()}
            sc = opt.scalars(n)
            held = {k: torch.tensor(v, dtype=torch.float32)
                    for k, v in sc.items()}
            gnorm = opt.step_(grads, state, params, held if tensors else sc)
            state = opt.advance(state, n, sc, gnorm)
            norms.append(state["grad_norm"])
        runs.append((params, state, norms))
    (p0, s0, n0), (p1, s1, n1) = runs
    assert s0["step"] == s1["step"] == 4 and s0["lr"] == s1["lr"]
    assert all(torch.equal(a, b) for a, b in zip(n0, n1))
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
    m0, m1 = moments(s0), moments(s1)
    assert len(m0) == len(m1) > 0
    assert all(torch.equal(a, b) for a, b in zip(m0, m1))


def test_adamw_update_with_tensor_scalars_equals_host_floats():
    """AdamW: the learning rate and bias corrections in 0-dim tensors."""
    tensor_scalars_equal_host_floats("adamw")


def test_adafactor_update_with_tensor_scalars_equals_host_floats():
    """Adafactor: the learning rate and the step's ``beta2``."""
    tensor_scalars_equal_host_floats("adafactor")


def test_cuda_graph_refuses_cpu_tensors():
    cfg = reduced(get_arch("gpt2"))
    params = tmodel.init_params(cfg, device=CPU)
    graphed = tstep.CudaGraphed(tstep.make_loss_and_grads(
        cfg, tmodel.Runtime(torch.float32)))
    b = tmodel.batch_to_device(batch(cfg), torch.device(CPU))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        graphed(params, b)


def test_loss_decreases_over_training():
    """Port of tests/test_system.py::test_loss_decreases_over_training."""
    cfg = reduced(get_arch("gpt2"))
    opt = tstep.make_optimizer_for(TrainConfig(learning_rate=3e-3,
                                               total_steps=40,
                                               warmup_steps=4), cfg)
    data = SyntheticLMData(cfg, seq_len=32, global_batch=8, seed=0)
    state = tstep.init_train_state(cfg, opt, seed=0, device=CPU)
    step_fn = tstep.make_train_step(cfg, tmodel.Runtime(torch.float32), opt)
    losses = []
    for s in range(40):
        state, m = step_fn(state, data.batch(s))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.2, losses[::8]


# -- decode -------------------------------------------------------------------
# float32: same arithmetic up to summation order (rtol 1e-4, atol 1e-4 on
# logits of O(1)); bf16 caches and compute: one bf16 rounding of each
# activation on either side (rtol/atol 2e-2)
DECODE_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
JDTYPE = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def decode_both(jcfg, tcfg, jp, tp, dtype, tokens, start=None):
    """Run both packages' decode_step over ``tokens`` (B, T) teacher-forced,
    each on caches it filled itself; returns the logits (B, T, V) of each."""
    B, T = tokens.shape
    jrt = jmodel.Runtime(compute_dtype=JDTYPE[dtype])
    trt = tmodel.Runtime(TDTYPE[dtype])
    jc = jmodel.init_decode_caches(jcfg, B, T + 4, dtype=JDTYPE[dtype])
    tc = tmodel.init_decode_caches(tcfg, B, T + 4, dtype=TDTYPE[dtype],
                                   device=CPU)
    jout, tout = [], []
    for t in range(T):
        js = None if start is None else jnp.asarray(start, jnp.int32)
        ts = None if start is None else torch.as_tensor(start)
        jl, jc = jmodel.decode_step(jp, jcfg, jrt,
                                    {"tokens": jnp.asarray(tokens[:, t:t + 1])},
                                    jc, jnp.int32(t), start=js)
        with torch.no_grad():
            tl, tc = tmodel.decode_step(
                tp, tcfg, trt, {"tokens": torch.as_tensor(tokens[:, t:t + 1])},
                tc, t, start=ts)
        jout.append(np.asarray(jl.astype(jnp.float32)))
        tout.append(tl.float().numpy())
    return np.concatenate(jout, 1), np.concatenate(tout, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_jax(dtype):
    jcfg, tcfg = configs(250)
    jp, tp = both_params(jcfg, tcfg)
    tokens = np.random.default_rng(0).integers(1, 250, (3, 10)).astype(np.int32)
    want, got = decode_both(jcfg, tcfg, jp, tp, dtype, tokens)
    rtol, atol = DECODE_TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    if dtype == "float32":  # greedy tokens equal
        np.testing.assert_array_equal(got[..., :250].argmax(-1),
                                      want[..., :250].argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_the_full_forward(dtype):
    """Teacher-forced decode reproduces the full-sequence forward's logits
    at every position, to DECODE_TOL (both accumulate scores and values in
    float32)."""
    _, tcfg = configs(256)
    tp = tmodel.init_params(tcfg, seed=1, device=CPU)
    rt = tmodel.Runtime(TDTYPE[dtype])
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (2, 12)))
    caches = tmodel.init_decode_caches(tcfg, 2, 16, dtype=TDTYPE[dtype],
                                       device=CPU)
    with torch.no_grad():
        full, _ = tmodel.forward(tp, tcfg, rt, {"tokens": tokens})
        steps = [tmodel.decode_step(tp, tcfg, rt,
                                    {"tokens": tokens[:, t:t + 1]}, caches,
                                    t)[0] for t in range(12)]
    rtol, atol = DECODE_TOL[dtype]
    np.testing.assert_allclose(torch.cat(steps, 1).float().numpy(),
                               full.float().numpy(), rtol=rtol, atol=atol)


def test_decode_start_mask_matches_jax_and_hides_stale_rows():
    """Per-slot ``start``: lane 1 starts at position 4, so rows 0-3 of its
    cache (another occupant's) are masked out — both packages agree, and
    the lane's logits equal a fresh sequence's."""
    jcfg, tcfg = configs(256)
    jp, tp = both_params(jcfg, tcfg)
    tokens = np.random.default_rng(2).integers(1, 256, (2, 9)).astype(np.int32)
    start = np.array([0, 4], np.int32)
    want, got = decode_both(jcfg, tcfg, jp, tp, "float32", tokens, start)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the masked lane from position 4 on == a fresh run of tokens[1, 4:]
    _, fresh = decode_both(jcfg, tcfg, jp, tp, "float32", tokens[1:, 4:])
    np.testing.assert_allclose(got[1:, 4:], fresh, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got[1:, 4:].argmax(-1), fresh.argmax(-1))


def test_bf16_attention_scores_accumulate_in_float32_as_the_reference():
    """bf16 q, k and v with float32 scores: the port's attention block
    equals the reference's (``preferred_element_type=float32``) on inputs
    whose bf16-rounded scores differ from the float32 ones. Every position
    shares a large input direction that both the query and key projections
    map onto one vector, so each head's scores sit near a common offset of
    ~200 with a spread of ~8: rounded to bf16 they move by up to 0.5 and the
    softmax with them. The value projection drops that direction, so the
    output is the attention-weighted rest. Within 2e-2 of the output's
    scale (the bf16 tolerance above); scores rounded to bf16 miss it by
    ~5x."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    jcfg, tcfg = configs(256)
    d, H, hd = tcfg.d_model, tcfg.n_heads, tcfg.head_dim
    rng = np.random.default_rng(0)
    u = rng.standard_normal(d)
    u /= np.linalg.norm(u)
    e = np.ones(d) / np.sqrt(d)
    w = {n: 0.02 * rng.standard_normal((d, d)) for n in ("q", "k", "v", "out")}
    w["q"] += 0.5 * np.outer(u, e)
    w["k"] += 0.5 * np.outer(u, e)
    w["v"] = (np.eye(d) - np.outer(u, u)) @ w["v"]
    w = {n: a.astype(np.float32) for n, a in w.items()}
    x = (100 * u + rng.standard_normal((2, 32, d))).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jattn.gqa_forward(
        {n: {"kernel": jnp.asarray(a)} for n, a in w.items()}, jcfg,
        xb).astype(jnp.float32))
    tp = {f"attn.{n}.kernel": torch.tensor(a) for n, a in w.items()}
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).bfloat16()
    with torch.no_grad():
        got = tattn.gqa_forward(tp, "attn", tcfg, xt)
        q, k = (xt @ tp[f"attn.{n}.kernel"].bfloat16() for n in "qk")
        s = (q.float().view(2, 32, H, hd).transpose(1, 2)
             @ k.float().view(2, 32, H, hd).permute(0, 2, 3, 1)) / hd ** 0.5
    assert got.dtype == torch.bfloat16
    assert float((s.bfloat16().float() - s).abs().max()) > 0.1  # the premise
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2e-2 * scale)


def test_bf16_attention_gradients_follow_the_reference_vjp():
    """`matmul_f32`'s backward (the incoming gradient cast to the operands'
    bf16, products summed in float32) against the reference's custom VJP
    (`_flash_vjp_bwd`, which casts ``ds`` to the operands' dtype the same
    way): the gradients of one bf16 attention block's weighted output
    with respect to its input and its four kernels agree within 2e-2 of
    each gradient's scale."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as tattn

    jcfg, tcfg = configs(256)
    d = tcfg.d_model
    rng = np.random.default_rng(3)
    w = {n: (0.2 * rng.standard_normal((d, d))).astype(np.float32)
         for n in ("q", "k", "v", "out")}
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    r = rng.standard_normal((2, 16, d)).astype(np.float32)

    def jloss(wj, xj):
        out = jattn.gqa_forward({n: {"kernel": a} for n, a in wj.items()},
                                jcfg, xj.astype(jnp.bfloat16))
        return jnp.sum(out.astype(jnp.float32) * r)

    jw, jx = jax.grad(jloss, argnums=(0, 1))(
        {n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(x))
    tp = {f"attn.{n}.kernel": torch.tensor(a, requires_grad=True)
          for n, a in w.items()}
    xt = torch.tensor(x, requires_grad=True)
    out = tattn.gqa_forward(tp, "attn", tcfg, xt.bfloat16())
    (out.float() * torch.from_numpy(r)).sum().backward()
    pairs = [(xt.grad, jx)] + [(tp[f"attn.{n}.kernel"].grad, jw[n])
                               for n in w]
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-2 * float(np.abs(want).max()))
