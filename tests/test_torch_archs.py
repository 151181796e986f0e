"""The port's model families against the JAX package's, for each of the ten
assigned configs of `repro.configs` at ``reduced`` size, in float32, with
the reference's own initial weights carried across by `params_from_jax`:
the forward's logits and aux loss, the loss, and the gradients against
``jax.grad``; MoE routing and capacity drops, SSD over several chunks,
RoPE alone, the parameter count, weight decay on the reference's stacked
leaves, and the launchers (training and serving) on every architecture. The optimizer steps are in
tests/test_torch_archs_steps.py.

Tolerances (float32 in both; matmuls and reductions summed in another
order, the SSD inter-chunk state by a loop where the reference runs an
associative scan): logits and aux within 1e-4 relative + 1e-4 absolute,
the loss within 1e-5 relative, each gradient within 1e-4 of its largest
entry + 1e-6. Routing indices, capacity slots and drops are equal exactly.
Sequences of 64 tokens put the SSD configs' 16-token chunks at 4 a
sequence and the reduced sliding window (32) inside the sequence.
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
from repro.configs import ASSIGNED as JASSIGNED  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.config import (TrainConfig, get_arch, param_shapes,  # noqa: E402
                                reduced, stack_layout)
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serve import ContinuousBatchingEngine  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

CPU = "cpu"
SEQ, BATCH = 64, 2
MOE = [a for a in ASSIGNED if get_arch(a).n_experts]


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(reference cfg, port cfg, reference params, the batch) at reduced
    size; the port's parameters come from `port_params`."""
    jcfg, tcfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    b = SyntheticLMData(tcfg, seq_len=SEQ, global_batch=BATCH,
                        seed=1).batch(3)
    return jcfg, tcfg, jp, b


def port_params(arch, tree=None):
    jcfg, tcfg, jp, _ = setup(arch)
    return params_from_jax(jax.tree.map(np.asarray, jp if tree is None
                                        else tree), tcfg, device=CPU)


def jbatch(b):
    return jax.tree.map(jnp.asarray, b)


def tbatch(b):
    return tmodel.batch_to_device(b, torch.device(CPU))


JRT = jmodel.Runtime(compute_dtype=jnp.float32)
TRT = tmodel.Runtime(torch.float32)


def test_the_port_registers_the_reference_s_configs():
    assert ASSIGNED == JASSIGNED
    for arch in ASSIGNED + ["gpt2"]:
        assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(
            jget_arch(arch))
        assert dataclasses.asdict(reduced(get_arch(arch))) == \
            dataclasses.asdict(jreduced(jget_arch(arch)))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_forward_matches_jax(arch):
    jcfg, tcfg, jp, b = setup(arch)
    jl, jaux = jax.jit(lambda p, x: jmodel.forward(p, jcfg, JRT, x))(
        jp, jbatch(b))
    with torch.no_grad():
        tl, taux = tmodel.forward(port_params(arch), tcfg, TRT, tbatch(b))
    assert tl.shape == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4,
                               atol=1e-6)
    if tcfg.n_experts:
        assert float(taux) > 0.0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_loss_and_gradients_match_jax(arch):
    jcfg, tcfg, jp, b = setup(arch)

    def jloss(p, x):
        return jmodel.loss_fn(p, jcfg, JRT, x)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, jbatch(b))
    tp = port_params(arch)
    tl, _ = tmodel.loss_fn(tp, tcfg, TRT, tbatch(b))
    grads = dict(zip(tp, torch.autograd.grad(tl, list(tp.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = port_params(arch, jg)
    for name, g in grads.items():
        w = want[name].detach().numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 + 1e-4 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("arch", MOE)
def test_moe_routing_matches_jax(arch):
    """The router's top-k indices equal the reference's ``lax.top_k``, the
    renormalised weights and the aux loss agree."""
    jcfg, tcfg, jp, _ = setup(arch)
    x = np.random.default_rng(0).standard_normal((96, tcfg.d_model),
                                                 dtype=np.float32)
    kernel = np.asarray(jp["layers"]["moe"]["router"]["kernel"][0])
    logits = jnp.asarray(x) @ jnp.asarray(kernel)
    gates = jax.nn.softmax(logits, axis=-1)
    jw, ji = jax.lax.top_k(gates, jcfg.moe_top_k)
    jw = jw / jnp.sum(jw, axis=-1, keepdims=True)
    _, tw, ti, _ = tmoe.route({"r.router.kernel": torch.tensor(kernel)}, "r",
                              tcfg, torch.tensor(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("E,C,k", [(4, 8, 2), (6, 8, 3), (8, 16, 1)])
def test_dispatch_with_capacity_overflow_matches_jax(E, C, k):
    """Skewed routing that overflows the capacity: the slots, the tokens
    kept and dropped, the permutation and the combined output equal the
    reference's exactly (the stable sort keeps the earliest tokens)."""
    rng = np.random.default_rng(E * 100 + C + k)
    T, d = 48, 5
    p = np.array([0.55] + [0.45 / (E - 1)] * (E - 1))
    idx = np.stack([rng.choice(E, size=k, replace=False, p=p)
                    for _ in range(T)]).astype(np.int32)
    x = rng.standard_normal((T, d)).astype(np.float32)
    w = rng.random((T, k)).astype(np.float32)
    jout = jmoe._dispatch(jnp.asarray(x), jnp.asarray(idx), E, C)
    tout = tmoe._dispatch(torch.tensor(x), torch.tensor(idx), E, C)
    for name, a, t in zip(("buf", "slot", "keep", "token_of", "order"),
                          jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(a),
                                      err_msg=name)
    dropped = int((~np.asarray(jout[2])).sum())
    assert dropped > 0 and int(tmoe.dropped(torch.tensor(idx), E, C)) == \
        dropped
    ys = rng.standard_normal((E, C, d)).astype(np.float32)
    jy = jmoe._combine(jnp.asarray(ys), jout[1], jout[2], jout[3],
                       jnp.asarray(w), jout[4], T)
    ty = tmoe._combine(torch.tensor(ys), tout[1], tout[2], torch.tensor(w),
                       tout[4], T)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)


def test_capacity_matches_jax():
    for T, k, E, cf in [(1024, 6, 160, 1.25), (128, 2, 4, 1.25),
                        (7, 1, 8, 1.0), (4096, 2, 128, 1.25)]:
        assert tmoe._capacity(T, k, E, cf) == jmoe._capacity(T, k, E, cf)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-7b"])
def test_ssd_over_several_chunks_matches_jax(arch):
    """The mixer alone on 4 chunks of 16 (float32, 1e-5): the chunk loop
    carries the state as the reference's associative scan does."""
    jcfg, tcfg, jp, _ = setup(arch)
    assert SEQ // tcfg.ssm_chunk == 4
    x = np.random.default_rng(3).standard_normal(
        (BATCH, SEQ, tcfg.d_model)).astype(np.float32)
    tree = jax.tree.map(lambda a: a[0], jp["layers"]["mixer"])
    if jcfg.attn_every:
        tree = jax.tree.map(lambda a: a[0], tree)
    jy = jssm.ssd_forward(tree, jcfg, jnp.asarray(x))
    flat = {}
    tssm_params = jax.tree.map(np.asarray, tree)
    for key, val in (("in_proj.kernel", tssm_params["in_proj"]["kernel"]),
                     ("conv.kernel", tssm_params["conv"]["kernel"]),
                     ("A_log", tssm_params["A_log"]),
                     ("D", tssm_params["D"]),
                     ("dt_bias", tssm_params["dt_bias"]),
                     ("norm.scale", tssm_params["norm"]["scale"]),
                     ("out_proj.kernel", tssm_params["out_proj"]["kernel"])):
        flat[f"m.{key}"] = torch.tensor(val)
    ty = tssm.ssd_forward(flat, "m", tcfg, torch.tensor(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (64, 500_000.0),
                                            (8, 1e6)])
def test_rope_matches_jax(head_dim, theta):
    """Same rotation convention (halves, not interleaved pairs), positions
    with an offset, float32 within 1e-5."""
    rng = np.random.default_rng(head_dim)
    x = rng.standard_normal((2, 12, 3, head_dim)).astype(np.float32)
    pos = np.arange(12) + 37
    jy = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    ty = tlayers.apply_rope(torch.tensor(x), torch.tensor(pos), theta)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        tlayers.rope_frequencies(head_dim, theta).numpy(),
        np.asarray(jlayers.rope_frequencies(head_dim, theta)), rtol=1e-6)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_param_count_matches_the_analytic_count(arch):
    """The initialised model holds exactly `param_shapes`, whose count is
    the reference's analytic one at full size and at reduced size; the
    reduced reference tree holds the same number."""
    full, small = get_arch(arch), reduced(get_arch(arch))
    assert full.param_count() == jget_arch(arch).param_count()
    assert full.active_param_count() == jget_arch(arch).active_param_count()
    params = tmodel.init_params(small, seed=0, device=CPU)
    assert {k: tuple(v.shape) for k, v in params.items()} == \
        param_shapes(small)
    n = sum(p.numel() for p in params.values())
    assert n == small.param_count() == jreduced(jget_arch(arch)).param_count()
    assert n == sum(np.asarray(a).size for a in jax.tree.leaves(setup(arch)[2]))


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "zamba2-7b",
                                  "mamba2-2.7b"])
def test_stack_layout_names_the_reference_s_leaves(arch):
    """Every reference leaf is covered, each at its stacked shape."""
    jcfg, tcfg, jp, _ = setup(arch)
    flat = {}

    def walk(tree, prefix):
        if isinstance(tree, (dict, list)):
            items = tree.items() if isinstance(tree, dict) else enumerate(tree)
            for k, v in items:
                walk(v, f"{prefix}.{k}" if prefix else str(k))
        else:
            flat[prefix] = tuple(np.shape(tree))

    walk(jp, "")
    layout, shapes = stack_layout(tcfg), param_shapes(tcfg)
    assert {leaf for leaf, _, _ in layout.values()} == set(flat)
    for name, (leaf, idx, stacked) in layout.items():
        assert flat[leaf] == tuple(stacked) + tuple(shapes[name]), name


def test_adamw_leaves_head_layer_vectors_undecayed_as_the_reference():
    """DeepSeek's leading dense layer is ``head_layers`` in the reference:
    its norm scales are 1-D leaves there and not decayed, where the stacked
    layers' are 2-D and decayed (and the final norm is not). With zero
    gradients AdamW's update is the decay term alone."""
    _, tcfg, jp, _ = setup("deepseek-v2-236b")
    params = port_params("deepseek-v2-236b")
    with torch.no_grad():
        for p in params.values():
            p.add_(0.5)  # norm scales of 1.5: a decay term to see
    opt = tstep.make_optimizer_for(
        TrainConfig(learning_rate=1e-3, total_steps=10, warmup_steps=0),
        tcfg)
    zeros = {k: torch.zeros_like(p) for k, p in params.items()}
    before = {k: p.detach().clone() for k, p in params.items()}
    opt.step_(zeros, opt.init(params), params, opt.scalars(1))
    updates = {k: p.detach() - before[k] for k, p in params.items()}
    assert float(updates["layers.0.norm1.scale"].abs().max()) == 0.0
    assert float(updates["layers.0.attn.q_norm.scale"].abs().max()) == 0.0
    assert float(updates["final_norm.scale"].abs().max()) == 0.0
    assert float(updates["layers.1.norm1.scale"].abs().min()) > 0.0
    assert float(updates["layers.0.ffn.up.kernel"].abs().max()) > 0.0


@pytest.mark.parametrize("arch", ASSIGNED)
def test_launcher_trains_every_arch_with_adafactor_and_microbatches(
        arch, capsys):
    """``launch.train`` on the CPU with ``--optimizer adafactor
    --microbatches 2``: it runs to the end with a finite loss."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "32", "--log-every", "0",
            "--optimizer", "adafactor", "--microbatches", "2"]
    assert launch_train.main(argv) == 0
    line = [l for l in capsys.readouterr().out.splitlines()
            if l.startswith("final loss")][-1]
    assert np.isfinite(float(line.split()[2]))


@pytest.mark.parametrize("arch", ASSIGNED)
def test_serve_launcher_serves_every_arch_on_the_cpu(arch, capsys,
                                                     monkeypatch):
    """``launch.serve --reduced --device cpu`` on every assigned config: a
    token decoder serves a few requests through the continuous engine,
    every step's logits finite; the embeddings model (Pixtral's backbone)
    serves through ``--static-batch`` and the continuous engine refuses it
    with the reference's message; the encoder has no decode step and exits
    0 saying so, as the reference's launcher does."""
    cfg = get_arch(arch)
    if not cfg.has_decode:
        assert launch_serve.main(["--arch", arch, "--reduced", "--device",
                                  "cpu"]) == 0
        assert "encoder-only" in capsys.readouterr().out
        return
    runs = []
    serve = launch_serve.serve

    def kept(args):
        runs.append(serve(args))
        return runs[-1]

    monkeypatch.setattr(launch_serve, "serve", kept)
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--max-len", "64"]
    if cfg.input_mode != "tokens":
        with pytest.raises(SystemExit) as e:
            launch_serve.main(argv)
        assert e.value.code == 2
        assert ("continuous batching requires token inputs"
                in capsys.readouterr().err)
        with pytest.raises(ValueError, match="requires token inputs"):
            ContinuousBatchingEngine(reduced(cfg), tmodel.Runtime(
                torch.float32), port_params(arch), slots=2, max_len=8)
        assert launch_serve.main(argv + ["--static-batch", "--batch", "2",
                                         "--tokens", "4",
                                         "--prompt-len", "3"]) == 0
        assert "generated (2, 7)" in capsys.readouterr().out
        return
    assert launch_serve.main(argv + ["--num-requests", "6", "--slots", "2",
                                     "--prompt-len", "2,4",
                                     "--max-new", "2,4"]) == 0
    stats = runs[-1]["stats"]
    assert stats["requests"] == 6 and stats["tokens"] > 0
    assert stats["nonfinite_steps"] == 0
