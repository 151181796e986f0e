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
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.optim import schedule as tschedule  # noqa: E402
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
                                                warmup_steps=2))
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
    cfg = dataclasses.replace(reduced(get_arch("gpt2")), use_rope=True)
    with pytest.raises(NotImplementedError, match="use_rope"):
        tmodel.init_params(cfg, device=CPU)


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
                                               total_steps=10))
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
                                               warmup_steps=4))
    data = SyntheticLMData(cfg, seq_len=32, global_batch=8, seed=0)
    state = tstep.init_train_state(cfg, opt, seed=0, device=CPU)
    step_fn = tstep.make_train_step(cfg, tmodel.Runtime(torch.float32), opt)
    losses = []
    for s in range(40):
        state, m = step_fn(state, data.batch(s))
        losses.append(float(m["loss"]))
    assert np.mean(losses[-8:]) < np.mean(losses[:8]) - 0.2, losses[::8]
