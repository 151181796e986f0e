"""The port's mesh (`repro_torch.launch.mesh`, `models/sharding.py`, the
sharding levers of `models.model.Runtime`, the sharded MoE, the sharded
train step, the elastic checkpoint, ``launch.train --data-mesh``, the
COLLECTIVE layer read off the step) against the JAX package's, on the CPU.

(i) the partition specs equal the reference's for every registered
architecture, full size and reduced, on stand-in meshes (the reference's
rules read only ``mesh.shape``); (ii) one group of 8 gloo ranks on a
(2, 4) mesh runs the reference's sharded-test families from the
reference's own weights: the sharded loss within the reference's 5e-3 of
the local one, and where no (token, choice) pair drops at capacity the
loss within 1e-5 relative and every gradient within 1e-4 of its largest
entry (float32, summed in another order); the MoE bodies against the
local dispatch; (iii) ``remat`` ``full`` and ``dots`` equal ``none`` bit
for bit and the reference's remat loss within the model tolerance; (iv)
the COLLECTIVE rows of a monitored step at world size 2 are the
collectives the step dispatches; (v) a (2, 1) mesh's checkpoint restores
without a mesh and the reverse, bit for bit; sharded train steps follow
the local ones; the launcher under ``torchrun``.

Every process group has a finite timeout and every group of processes a
wall-clock limit, so no collective can hang the suite. The ranks run
`tests/torch_mesh_worker.py` (no JAX there).
"""
import contextlib
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_arch as jget_arch  # noqa: E402
from repro.config import reduced as jreduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.config import (get_arch, list_archs,  # noqa: E402
                                param_shapes, reduced, stack_layout)
from repro_torch.configs import ASSIGNED  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.models.sharding import (P, entry_axes, piece,  # noqa: E402
                                         placements)
from repro_torch.train import checkpoint as tckpt  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "torch_mesh_worker.py")
GROUP_TIMEOUT_S = 420
FAMILIES = ["deepseek-v2-236b", "arctic-480b", "zamba2-7b", "mamba2-2.7b",
            "h2o-danube-3-4b", "hubert-xlarge"]
MESHES = [(1, 1), (2, 4), (4, 2), (1, 4)]


# ---------------------------------------------------------------------------
# (i) spec parity
# ---------------------------------------------------------------------------


class StandIn:
    """A mesh as the spec rules see it: axis sizes by name."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}
        self.mesh_dim_names = ("data", "model")


def _norm(spec, rank):
    entries = tuple(spec) + (None,) * (rank - len(tuple(spec)))
    return tuple(entry_axes(e) for e in entries)


def _leaf_specs(tree):
    """The reference's spec tree -> {leaf path "a.b.0.c": spec}."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    out = {}
    for path, spec in flat:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out[".".join(parts)] = spec
    return out


@functools.lru_cache(maxsize=None)
def _shapes(arch, small):
    jcfg = jreduced(jget_arch(arch)) if small else jget_arch(arch)
    return jcfg, jax.eval_shape(
        lambda k: jmodel.init_params(k, jcfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_partition_specs_match_jax(arch, mesh):
    """param_partition_specs, cache_partition_specs, batch_spec and
    _seq_shard_spec equal the reference's, full size and reduced, fsdp on
    and off, strategy tp and dp."""
    for small in (False, True):
        jcfg, jshapes = _shapes(arch, small)
        tcfg = reduced(get_arch(arch)) if small else get_arch(arch)
        for fsdp in (False, True):
            for strategy in ("tp", "dp"):
                kw = dict(fsdp=fsdp, strategy=strategy)
                jrt = jmodel.Runtime(mesh=StandIn(*mesh), **kw)
                trt = tmodel.Runtime(mesh=StandIn(*mesh), **kw)
                want = _leaf_specs(jmodel.param_partition_specs(
                    jcfg, jrt, jshapes))
                got = tmodel.param_partition_specs(tcfg, trt,
                                                   param_shapes(tcfg))
                for name, (leaf, _, stacked) in stack_layout(tcfg).items():
                    rank = len(param_shapes(tcfg)[name])
                    w = _norm(want[leaf], len(stacked) + rank)
                    assert w[:len(stacked)] == ((),) * len(stacked), name
                    assert _norm(got[name], rank) == w[len(stacked):], \
                        (arch, small, mesh, kw, name)
                for B in (1, 2, 4, 6, 8):
                    assert _norm(P(trt.batch_spec(B)), 1) == \
                        _norm(jax.sharding.PartitionSpec(jrt.batch_spec(B)),
                              1)
                    for S in (1, 30, 32, 128):
                        j = jattn._seq_shard_spec(jrt, jcfg, B, S)
                        t = tattn._seq_shard_spec(trt, tcfg, B, S)
                        assert (j is None) == (t is None)
                        if j is not None:
                            assert _norm(t, 4) == _norm(j, 4)
                if not tcfg.has_decode:
                    continue
                B = 8
                jc = jax.eval_shape(lambda: jmodel.init_decode_caches(
                    jcfg, B, 64))
                want = _leaf_specs(jmodel.cache_partition_specs(
                    jcfg, jrt, jc, B))
                caches = tmodel.init_decode_caches(tcfg, B, 64,
                                                   device="meta")
                got = tmodel.cache_partition_specs(tcfg, trt, caches, B)
                for group, cs in caches.items():
                    for i, c in enumerate(cs):
                        for key, t in c.items():
                            leaf = (f"{group}.{i}.{key}"
                                    if group == "head_layers"
                                    else f"{group}.{key}")
                            n = len(want[leaf]) if len(want[leaf]) > \
                                t.dim() else t.dim()
                            w = _norm(want[leaf], max(n, t.dim()))
                            w = w[len(w) - t.dim():]
                            assert _norm(got[group][i][key], t.dim()) == w, \
                                (arch, mesh, kw, group, key)


_JAX_PIECES = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
devs = np.array(jax.devices()[:8]).reshape(2, 4)
mesh = Mesh(devs, ("data", "model"))
out = {}
for name, spec in (("both", P(("data", "model"))), ("data", P("data")),
                   ("model", P("model"))):
    idx = NamedSharding(mesh, spec).devices_indices_map((16,))
    out[name] = {f"{d},{m}": idx[devs[d, m]][0].start or 0
                 for d in range(2) for m in range(4)}
print(json.dumps(out))
"""


def test_multi_axis_entries_split_major_axis_first():
    """A dim split over ("data", "model") holds piece i_data * n_model +
    i_model on rank (i_data, i_model), where JAX's ``NamedSharding`` puts
    it (8 host devices, in a child process); DTensor's placements are
    ``Shard`` on both mesh dims in mesh order, and a spec ordering the axes
    against the mesh is refused."""
    from types import SimpleNamespace

    from torch.distributed.tensor import Replicate, Shard

    mesh = StandIn(2, 4)
    assert placements(P(("data", "model"), None), mesh) == [Shard(0),
                                                            Shard(0)]
    assert placements(P(None, "model"), mesh) == [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="orders"):
        placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="not axes"):
        placements(P("pod"), mesh)
    out = subprocess.run([sys.executable, "-c", _JAX_PIECES],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.splitlines()[-1])
    entries = {"both": ("data", "model"), "data": "data", "model": "model"}
    for name, entry in entries.items():
        for d in range(2):
            for m in range(4):
                axes = {"data": SimpleNamespace(size=2, rank=d),
                        "model": SimpleNamespace(size=4, rank=m)}
                assert piece(16, entry, axes)[0] == want[name][f"{d},{m}"]


# ---------------------------------------------------------------------------
# groups of ranks
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(n: int, task: str, args: dict):
    """Run ``task`` on ``n`` ranks (as torchrun would start them); rank 0's
    result. Every rank is killed at the group's time limit."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, task, json.dumps(args)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=GROUP_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    line = [l for l in outs[0][0].splitlines() if l.startswith("RESULT ")]
    assert line, outs[0][1][-4000:]
    return json.loads(line[-1][len("RESULT "):])


# ---------------------------------------------------------------------------
# (ii) sharded equals local
# ---------------------------------------------------------------------------


def _reference_batch(cfg, key):
    """The batch of `tests/test_system.py::test_sharded_matches_local_all_
    families`."""
    B, S = 4, 32
    if cfg.input_mode == "tokens":
        return {"tokens": jax.random.randint(key, (B, S), 0, cfg.vocab_size),
                "labels": jax.random.randint(key, (B, S), 0,
                                             cfg.vocab_size)}
    return {"embeddings": 0.1 * jax.random.normal(key, (B, S, cfg.d_model)),
            "labels": jax.random.randint(key, (B, S), 0, cfg.vocab_size)}


@functools.lru_cache(maxsize=None)
def families(tmp):
    """The 8-rank run: the reference's weights and batches for each
    family, written for the ranks; their results, and the reference's
    local losses."""
    arrays, jlocal = {}, {}
    for arch in FAMILIES + ["gpt2"]:
        jcfg = jreduced(jget_arch(arch))
        key = jax.random.PRNGKey(0)
        jp = jmodel.init_params(key, jcfg)
        jb = _reference_batch(jcfg, key)
        tp = params_from_jax(jax.tree.map(np.asarray, jp),
                             reduced(get_arch(arch)), device="cpu")
        for k, v in tp.items():
            arrays[f"{arch}/p/{k}"] = v.detach().numpy()
        for k, v in jb.items():
            arrays[f"{arch}/b/{k}"] = np.asarray(v)
        jrt = jmodel.Runtime(compute_dtype=jnp.float32)
        jlocal[arch] = float(jax.jit(lambda p, b: jmodel.loss_fn(
            p, jcfg, jrt, b)[0])(jp, jb))
    npz = os.path.join(tmp, "families.npz")
    np.savez(npz, **arrays)
    cases = [{"id": a, "arch": a, "mesh": [2, 4]} for a in FAMILIES]
    cases += [
        # the replicated MoE body: 4 x 31 tokens split over data, not model
        {"id": "deepseek-replicated", "arch": "deepseek-v2-236b",
         "mesh": [2, 4], "seq": 31},
        # attention's query rows split: 4 heads over a model axis of 8
        {"id": "gpt2-seq", "arch": "gpt2", "mesh": [1, 8]},
        {"id": "danube-seq", "arch": "h2o-danube-3-4b", "mesh": [1, 8]},
        {"id": "arctic-dp", "arch": "arctic-480b", "mesh": [2, 4],
         "strategy": "dp"},
        {"id": "zamba2-fsdp", "arch": "zamba2-7b", "mesh": [2, 4],
         "fsdp": True},
        {"id": "deepseek-fsdp", "arch": "deepseek-v2-236b", "mesh": [4, 2],
         "fsdp": True},
    ]
    return run_ranks(8, "families", {"npz": npz, "cases": cases}), jlocal


@pytest.fixture(scope="module")
def family_results(tmp_path_factory):
    return families(str(tmp_path_factory.mktemp("mesh")))


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_matches_local_all_families(arch, family_results):
    """The counterpart of `tests/test_system.py::test_sharded_matches_
    local_all_families`: on the (2, 4) mesh the sharded loss is within
    5e-3 of the local one, the port's local loss equals the reference's,
    and with no pair dropped the loss and gradients equal the local ones
    to float32 sums."""
    res, jlocal = family_results
    r = res[arch]
    assert abs(r["cf"]["sharded"] - r["cf"]["local"]) < 5e-3, r
    assert r["cf"]["local"] == pytest.approx(jlocal[arch], rel=1e-5)
    assert r["nodrop"]["sharded"] == pytest.approx(r["nodrop"]["local"],
                                                   rel=1e-5)
    assert r["nodrop"]["grad_rel"] < 1e-4, r
    if get_arch(arch).n_experts:
        assert r["dispatch"] == "a2a"


@pytest.mark.parametrize("case", ["deepseek-replicated", "gpt2-seq",
                                  "danube-seq", "arctic-dp", "zamba2-fsdp",
                                  "deepseek-fsdp"])
def test_sharded_paths_match_local(case, family_results):
    """The other sharded paths — the replicated MoE body, attention split
    over query rows, the dp strategy, fsdp — equal the local model where
    no pair drops."""
    res, _ = family_results
    r = res[case]
    assert r["nodrop"]["sharded"] == pytest.approx(r["nodrop"]["local"],
                                                   rel=1e-5)
    assert r["nodrop"]["grad_rel"] < 1e-4, r
    if case == "deepseek-replicated":
        assert r["dispatch"] == "replicated"
    if case == "arctic-dp":
        assert r["dispatch"] == "global"


@pytest.fixture(scope="module")
def moe_bodies():
    return run_ranks(8, "moe_bodies", {})


@pytest.mark.parametrize("body", ["a2a", "replicated"])
def test_moe_sharded_bodies_match_local(body, moe_bodies):
    """`_moe_sharded_a2a` and `_moe_sharded_replicated` on a (2, 4) mesh
    against `_moe_local` on the same tokens: outputs and the tokens'
    gradient."""
    r = moe_bodies[body]
    assert r["y"] < 1e-5 and r["dx"] < 1e-5, r


# ---------------------------------------------------------------------------
# (iii) remat
# ---------------------------------------------------------------------------


def _setup(arch):
    jcfg, tcfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    jp = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    b = SyntheticLMData(tcfg, seq_len=32, global_batch=2, seed=1).batch(0)
    return jcfg, tcfg, jp, b


@pytest.mark.parametrize("arch", ASSIGNED + ["gpt2"])
def test_remat_matches_none_bit_for_bit(arch):
    """``full`` and ``dots`` recompute each block in the backward: the
    loss and every gradient are ``none``'s bit for bit (float32, CPU); the
    reference's loss under the same remat within the model tolerance."""
    jcfg, tcfg, jp, b = _setup(arch)
    params = params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
    batch = tmodel.batch_to_device(b, torch.device("cpu"))
    out = {}
    for mode in ("none", "full", "dots"):
        rt = tmodel.Runtime(torch.float32, remat=mode)
        loss, _ = tmodel.loss_fn(params, tcfg, rt, batch)
        out[mode] = (loss.detach(),
                     torch.autograd.grad(loss, list(params.values())))
    for mode in ("full", "dots"):
        assert torch.equal(out[mode][0], out["none"][0])
        for g, g0 in zip(out[mode][1], out["none"][1]):
            assert torch.equal(g, g0)
        jrt = jmodel.Runtime(compute_dtype=jnp.float32, remat=mode)
        jl = jax.jit(lambda p, x: jmodel.loss_fn(p, jcfg, jrt, x)[0])(
            jp, jax.tree.map(jnp.asarray, b))
        assert float(out[mode][0]) == pytest.approx(float(jl), rel=1e-5)


def test_remat_dots_saves_the_unbatched_products():
    """Under ``dots`` the backward recomputes no ``aten.mm`` (the
    unbatched products are saved) but does recompute ``aten.bmm``; under
    ``full`` it recomputes both."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            key = func._overloadpacket.__name__
            self.n[key] = self.n.get(key, 0) + 1
            return func(*args, **(kwargs or {}))

    cfg = reduced(get_arch("gpt2"))
    params = tmodel.init_params(cfg, seed=0, device="cpu")
    batch = tmodel.batch_to_device(SyntheticLMData(
        cfg, seq_len=16, global_batch=2, seed=0).batch(0), torch.device("cpu"))
    counts = {}
    for mode in ("none", "full", "dots"):
        loss, _ = tmodel.loss_fn(params, cfg,
                                 tmodel.Runtime(torch.float32, remat=mode),
                                 batch)
        with Count() as c:
            torch.autograd.grad(loss, list(params.values()))
        counts[mode] = c.n
    extra = {m: {op: counts[m].get(op, 0) - counts["none"].get(op, 0)
                 for op in ("mm", "bmm")} for m in ("full", "dots")}
    assert extra["dots"]["mm"] == 0 and extra["dots"]["bmm"] > 0, extra
    assert extra["full"]["mm"] > 0 and extra["full"]["bmm"] > 0, extra


# ---------------------------------------------------------------------------
# (iv) the COLLECTIVE layer from the step's own collectives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    {"arch": "gpt2", "mesh": [2, 1]},
    {"arch": "deepseek-v2-236b", "mesh": [1, 2], "fsdp": False},
], ids=["gpt2-data2", "deepseek-model2"])
def test_collective_rows_are_the_step_s_collectives(case):
    """At world size 2 each step's COLLECTIVE rows are the collectives one
    real step dispatches, in order, each row's size the bytes of the
    collective's result; the schedule comes from the step itself."""
    r = run_ranks(2, "collective", case)
    issued = [tuple(x) for x in r["issued"]]
    assert issued and r["schedule"] == {"source": "step",
                                        "ops": len(issued)}
    steps = sorted({s for s, _, _ in r["rows"]})
    assert len(steps) == 3
    for s in steps:
        assert [(n, int(b)) for st, n, b in r["rows"] if st == s] == issued
    if case["mesh"] == [1, 2]:
        assert {"all-to-all", "all-reduce"} <= {n for n, _ in issued}


def test_one_rank_mesh_has_an_empty_collective_layer():
    """A 1 x 1 mesh issues no collective: its COLLECTIVE layer is empty
    and says so; it never replays a made-up schedule."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.collector import Collector
    from repro_torch.session.registry import build_probes
    from repro_torch.train.step import (init_train_state,
                                        make_optimizer_for, make_train_step)

    cfg = reduced(get_arch("gpt2"))
    with mesh_mod.process_group("cpu", timeout_s=60):
        rt = tmodel.Runtime(torch.float32,
                            mesh=mesh_mod.make_local_mesh(1, 1, "cpu"))
        opt = make_optimizer_for(TrainConfig(total_steps=4), cfg, rt)
        state = init_train_state(cfg, opt, device="cpu", rt=rt)
        step = make_train_step(cfg, rt, opt)
        data = SyntheticLMData(cfg, seq_len=16, global_batch=2, seed=0)
        col = Collector(build_probes(["operator", "collective", "step"], {}))
        with col.monitoring():
            fn = col.observe_step_fn(step, sample_args=(state, data.batch(0)))
            for i in range(2):
                state, _ = fn(state, data.batch(i))
        rows = [e for e in col.drain() if e.layer == "collective"]
    assert col.collective_schedule == {"source": "step", "ops": 0}
    assert rows == []


# ---------------------------------------------------------------------------
# (v) the elastic checkpoint, the sharded step, the launcher
# ---------------------------------------------------------------------------


def test_elastic_restore_both_ways(tmp_path):
    """A (2, 1) mesh's checkpoint (fsdp: each rank holds half of most
    tensors) restores into a state without a mesh, and a checkpoint saved
    without one restores onto the mesh, both bit for bit, for AdamW and
    Adafactor states."""
    from repro_torch.config import TrainConfig
    from repro_torch.train.step import init_train_state, make_optimizer_for

    cfg = reduced(get_arch("gpt2"))
    for name in ("adamw", "adafactor"):
        opt = make_optimizer_for(TrainConfig(total_steps=8, optimizer=name),
                                 cfg)
        plain = init_train_state(cfg, opt, seed=3, device="cpu")
        plain = plain._replace(step=3)
        tckpt.save_checkpoint(str(tmp_path / f"plain_{name}"), 3, plain)
        torch.save(plain, str(tmp_path / f"plain_{name}.pt"))
    r = run_ranks(2, "elastic", {"dir": str(tmp_path)})
    for name in ("adamw", "adafactor"):
        assert r[name]["restored_equal"], name
        opt = make_optimizer_for(TrainConfig(total_steps=8, optimizer=name),
                                 cfg)
        like = init_train_state(cfg, opt, seed=7, device="cpu")
        got, _ = tckpt.restore_checkpoint(str(tmp_path / f"mesh_{name}"), 2,
                                          like)
        want = torch.load(str(tmp_path / f"whole_{name}.pt"),
                          weights_only=False)
        for g, w in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            if isinstance(g, torch.Tensor):
                assert torch.equal(g.detach(), w.detach())
            else:
                assert g == w


@pytest.mark.parametrize("case", [
    {"arch": "gpt2", "mesh": [2, 1], "fsdp": True},
    {"arch": "llama3.2-1b", "mesh": [1, 2]},
], ids=["gpt2-data2-fsdp", "llama-model2"])
def test_sharded_train_steps_follow_local(case):
    """Three sharded steps (two microbatches each) give the local steps'
    losses and parameters, with AdamW and with Adafactor (whose factored
    moments and update RMS span the pieces)."""
    r = run_ranks(2, "steps", case)
    for name in ("adamw", "adafactor"):
        np.testing.assert_allclose(r[name]["mesh"], r[name]["local"],
                                   rtol=1e-5)
        assert r[name]["param_diff"] < 1e-5, r[name]


def test_launcher_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train
    --data-mesh 2 --reduced --device cpu``: both ranks train, rank 0 alone
    prints the report and the final loss and writes the checkpoints, rank
    1 prints its verdict; a run without a mesh resumes the checkpoint."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    ck = str(tmp_path / "ck")
    argv = ["--reduced", "--device", "cpu", "--steps", "24", "--batch", "4",
            "--seq", "16", "--checkpoint-dir", ck, "--checkpoint-every",
            "12", "--monitor-spec", '{"mode": "batch"}']
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port",
         str(_free_port()), "-m", "repro_torch.launch.train",
         "--data-mesh", "2", *argv],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=GROUP_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.count("monitor report") == 1
    assert out.stdout.count("final loss") == 1
    assert "mesh data=2xmodel=1" in out.stdout
    assert "[rank 1]" in out.stdout
    assert "COLLECTIVE layer:" in out.stdout
    assert tckpt.all_steps(ck) == [12, 24]
    argv[argv.index("--steps") + 1] = "30"
    again = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=GROUP_TIMEOUT_S)
    assert again.returncode == 0, again.stderr[-4000:]
    assert "restored checkpoint at step 24" in again.stdout
