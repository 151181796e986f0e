"""One train step of the port against the JAX package's ``make_train_step``
for each of the ten assigned configs at ``reduced`` size, in float32, from
the reference's own initial weights (`params_from_jax`): AdamW, Adafactor,
and AdamW over two accumulated microbatches. Both optimizers act on the
reference's stacked leaves (`repro_torch.config.stack_layout`): weight
decay and Adafactor's factoring by the stacked rank, Adafactor's moments of
stacked per-layer vectors and its update clipping across the layers.

Tolerances: loss and gradient norm within 1e-5 relative; parameters after
the step within 5e-5 absolute for AdamW (a tenth of the step's learning
rate, 5e-4) and 1e-6 for Adafactor (its update is proportional to the
gradient); Adafactor's moments within 1e-5 relative + 2e-4 of the leaf's
largest (squares of gradients that agree within 1e-4 of their largest).
Adam's first step moves an entry by about the learning rate whatever the
size of its gradient, so an entry whose gradient is zero within the
gradients' own agreement may step either way in either package: such an
entry (the reference's first moment within 1e-4 of its leaf's largest, or
within one bf16 step, 2^-8, when the microbatches' gradients are rounded to
bf16) is held to 2.2 learning rates (the step's bound with the decay) only.
"""
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.config import get_arch as jget_arch  # noqa: E402
from repro.config import reduced as jreduced  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch.config import TrainConfig, get_arch, reduced  # noqa: E402
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CPU = "cpu"
TOL = {"adamw": 5e-5, "adafactor": 1e-6}


def one_step(arch, optimizer, microbatches):
    jcfg, tcfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device=CPU)
    b = SyntheticLMData(tcfg, seq_len=64, global_batch=4, seed=1).batch(3)
    kw = dict(learning_rate=1e-3, total_steps=10, warmup_steps=2,
              optimizer=optimizer)
    jopt = jstep.make_optimizer_for(JTrainConfig(**kw))
    jstate = jstep.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jmodel.Runtime(compute_dtype=jnp.float32), jopt,
        microbatches=microbatches))
    jstate, jm = jfn(jstate, jax.tree.map(jnp.asarray, b))
    topt = tstep.make_optimizer_for(TrainConfig(**kw), tcfg)
    tstate = tstep.TrainState(tp, topt.init(tp), 0)
    tfn = tstep.make_train_step(tcfg, tmodel.Runtime(torch.float32), topt,
                                microbatches=microbatches)
    tstate, tm = tfn(tstate, b)
    for key in ("loss", "grad_norm", "aux_loss"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg,
                           device=CPU)
    mu = (params_from_jax(jax.tree.map(np.asarray, jstate.opt_state["mu"]),
                          tcfg, device=CPU) if optimizer == "adamw" else None)
    lr = float(jm["lr"])
    for name, p in tstate.params.items():
        got, ref = p.detach().numpy(), want[name].detach().numpy()
        off = np.abs(got - ref) > TOL[optimizer]
        if mu is not None:  # Adam's noise-floor entries (module docstring)
            m = np.abs(mu[name].detach().numpy())
            floor = (1e-4 if microbatches == 1 else 2.0 ** -8) * m.max()
            assert (np.abs(got - ref)[off] <= 2.2 * lr).all(), name
            off &= m > floor
        assert not off.any(), (name, np.abs(got - ref).max(),
                                int(off.sum()))
    return tstate, jstate


@pytest.mark.parametrize("arch", ASSIGNED)
def test_adamw_step_matches_jax(arch):
    one_step(arch, "adamw", 1)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_adafactor_step_matches_jax(arch):
    """Also the factored moments, leaf by leaf in the reference's stacked
    shapes (the port keeps them so)."""
    tstate, jstate = one_step(arch, "adafactor", 1)
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, dict) and set(tree) not in ({"vr", "vc"},
                                                        {"v"}):
            for k, v in tree.items():
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(tree, list):
            for k, v in enumerate(tree):
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        else:
            flat[prefix] = tree

    walk(jstate.opt_state["m"], "")
    assert set(flat) == set(tstate.opt_state["m"])
    for leaf, mom in tstate.opt_state["m"].items():
        for key, t in mom.items():
            w = np.asarray(flat[leaf][key])
            np.testing.assert_allclose(t.numpy(), w, rtol=1e-5,
                                       atol=2e-4 * np.abs(w).max(),
                                       err_msg=f"{leaf}.{key}")


@pytest.mark.parametrize("arch", ASSIGNED)
def test_accumulated_step_matches_jax(arch):
    """``microbatches=2``: each microbatch's gradient rounded to bf16 into a
    float32 accumulator, the mean loss, the last microbatch's metrics."""
    one_step(arch, "adamw", 2)
