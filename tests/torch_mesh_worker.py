"""One rank of the process groups that tests/test_torch_mesh.py starts: the
port on a gloo mesh of CPU processes, each on one intra-op thread.

    python tests/torch_mesh_worker.py TASK ARGS_JSON

with RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT set, as torchrun sets
them. Rank 0 prints one JSON line, ``RESULT {...}``; no task imports JAX.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from repro_torch.config import (TrainConfig, get_arch, param_shapes,  # noqa: E402
                                reduced)
from repro_torch.core.collector import Collector  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.sharding import (P, distribute,  # noqa: E402
                                         full_tensor)
from repro_torch.session.registry import build_probes  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import (init_train_state,  # noqa: E402
                                    make_optimizer_for, make_train_step,
                                    state_specs)
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

TIMEOUT_S = 120.0


def _mesh(data, model):
    return mesh_mod.make_local_mesh(data, model, device="cpu")


def _layout(params, cfg, rt):
    specs = M.param_partition_specs(cfg, rt, param_shapes(cfg))
    return {k: distribute(v.detach(), specs[k], rt.mesh).requires_grad_()
            for k, v in params.items()}, specs


def _loss_and_grads(params, cfg, rt, batch):
    loss, _ = M.loss_fn(params, cfg, rt, batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss), grads


def _grad_diff(cfg, rt, specs, params, grads, ref_grads) -> float:
    """The largest difference of the sharded gradients (made whole on
    every rank) from the local ones (rank 0's), relative to each
    gradient's largest entry."""
    worst = 0.0
    for (k, p), g, r in zip(params.items(), grads, ref_grads or grads):
        whole = full_tensor(g, specs[k], rt.mesh, p.shape)
        if ref_grads is not None:
            worst = max(worst, float((whole - r).abs().max()
                                     / (r.abs().max() + 1e-12)))
    return worst


def task_families(args):
    """The six reduced families on each mesh of ``args["meshes"]``: the
    sharded loss at the config's capacity factor and, at E / k (no pair
    dropped anywhere), the loss and gradients against the local ones."""
    data = np.load(args["npz"])
    out = {}
    for case in args["cases"]:
        arch, (d, m) = case["arch"], case["mesh"]
        cfg = reduced(get_arch(arch))
        mesh = _mesh(d, m)
        params = {k: torch.tensor(data[f"{arch}/p/{k}"]).requires_grad_()
                  for k in param_shapes(cfg)}
        batch = {k[len(f"{arch}/b/"):]: torch.tensor(data[k])
                 for k in data.files if k.startswith(f"{arch}/b/")}
        if case.get("seq"):
            batch = {k: v[:, :case["seq"]] for k, v in batch.items()}
        res = {}
        # without experts no pair drops at any capacity: one run
        cfs = ((("cf", 1.25), ("nodrop", cfg.n_experts / cfg.moe_top_k))
               if cfg.n_experts else (("cf", 1.25),))
        for cf_name, cf in cfs:
            kw = dict(moe_capacity_factor=cf,
                      strategy=case.get("strategy", "tp"),
                      fsdp=case.get("fsdp", False))
            loss0 = g0 = None
            if dist.get_rank() == 0:  # the local model: one rank's work
                loss0, g0 = _loss_and_grads(params, cfg,
                                            M.Runtime(torch.float32, **kw),
                                            batch)
            rt = M.Runtime(torch.float32, mesh=mesh, **kw)
            local, specs = _layout(params, cfg, rt)
            loss, g = _loss_and_grads(local, cfg, rt, batch)
            res[cf_name] = {"local": loss0, "sharded": loss,
                            "grad_rel": _grad_diff(cfg, rt, specs, params,
                                                   g, g0)}
        res.setdefault("nodrop", res["cf"])
        if cfg.n_experts:
            res["dispatch"] = moe_mod.dispatch_plan(
                cfg, M.Runtime(torch.float32, mesh=mesh,
                               strategy=case.get("strategy", "tp")),
                batch["labels"].numel())[0]
        out[case["id"]] = res
    return out


def task_moe_bodies(args):
    """``_moe_sharded_a2a`` and ``_moe_sharded_replicated`` against
    ``_moe_local`` on the same tokens (capacity large enough that no pair
    drops in any), forward and the tokens' gradient."""
    cfg = reduced(get_arch("deepseek-v2-236b"))
    mesh = _mesh(2, 4)
    gen = torch.Generator().manual_seed(0)
    E, k, d = cfg.n_experts, cfg.moe_top_k, cfg.d_model
    T = 64
    x = torch.randn(T, d, generator=gen)
    top_idx = torch.stack([torch.randperm(E, generator=gen)[:k]
                           for _ in range(T)])
    top_w = torch.rand(T, k, generator=gen)
    full = {f"l.moe.experts.{n}": torch.randn(E, *s, generator=gen) * 0.1
            for n, s in (("up", (d, cfg.d_ff_expert)),
                         ("gate", (d, cfg.d_ff_expert)),
                         ("down", (cfg.d_ff_expert, d)))}
    C = 64
    want_x = x.clone().requires_grad_()
    want = moe_mod._moe_local(want_x, top_idx, top_w, full, "l.moe", cfg, C)
    want.sum().backward()
    rt = M.Runtime(torch.float32, mesh=mesh, global_batch=T)
    spec = P(rt.model_axis, None, None)
    experts = {n: distribute(v, spec, mesh) for n, v in full.items()}
    out = {}
    for name, body in (("a2a", moe_mod._moe_sharded_a2a),
                       ("replicated", moe_mod._moe_sharded_replicated)):
        # a2a: this rank's tokens, split over (data, model); replicated:
        # the data piece's tokens, whole over the model axis
        tok = (("data", "model") if name == "a2a" else ("data",))
        src, dst = P(None, None), P(tok, None)
        xs = x.clone().requires_grad_()
        pieces = [rt.shard(t, dst, src) for t in (xs, top_idx, top_w)]
        y = body(*pieces, experts, "l.moe", cfg, C, rt)
        y = rt.shard(y, src, dst)
        y.sum().backward()
        out[name] = {"y": float((y - want).abs().max()),
                     "dx": float((xs.grad - want_x.grad).abs().max())}
    return out


class _Issued(TorchDispatchMode):
    """The functional collectives a run dispatches: (op, bytes)."""

    NAMES = {"all_reduce": "all-reduce",
             "all_gather_into_tensor": "all-gather",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all"}

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional" and name in self.NAMES:
            self.ops.append([self.NAMES[name],
                             out.numel() * out.element_size()])
        return out


def task_collective(args):
    """The COLLECTIVE layer of a monitored meshed step: its rows a step
    against the collectives one real step dispatches."""
    cfg = reduced(get_arch(args["arch"]))
    mesh = _mesh(*args["mesh"])
    rt = M.Runtime(torch.float32, mesh=mesh, fsdp=args.get("fsdp", False))
    opt = make_optimizer_for(TrainConfig(total_steps=8), cfg, rt)
    state = init_train_state(cfg, opt, seed=0, device="cpu", rt=rt)
    step = make_train_step(cfg, rt, opt)
    data = SyntheticLMData(cfg, seq_len=16, global_batch=4, seed=0)
    with _Issued() as issued:
        state, _ = step(state, data.batch(0))
    col = Collector(build_probes(["operator", "collective", "step"], {}))
    with col.monitoring():
        fn = col.observe_step_fn(step, sample_args=(state, data.batch(1)))
        for i in range(3):
            state, _ = fn(state, data.batch(2 + i))
    rows = [[int(e.step), e.name, float(e.size)] for e in col.drain()
            if e.layer == "collective" and not e.name.startswith("static/")]
    return {"issued": issued.ops, "rows": rows,
            "schedule": col.collective_schedule}


def task_elastic(args):
    """Save a sharded state at a (2, 1) mesh (fsdp: the pieces really
    differ) and restore one saved without a mesh; rank 0 returns what the
    parent compares bit for bit."""
    cfg = reduced(get_arch("gpt2"))
    mesh = _mesh(2, 1)
    rt = M.Runtime(torch.float32, mesh=mesh, fsdp=True)
    out = {}
    for name in ("adamw", "adafactor"):
        opt = make_optimizer_for(TrainConfig(total_steps=8, optimizer=name),
                                 cfg, rt)
        state = init_train_state(cfg, opt, seed=0, device="cpu", rt=rt)
        step = make_train_step(cfg, rt, opt)
        data = SyntheticLMData(cfg, seq_len=16, global_batch=4, seed=0)
        for i in range(2):
            state, _ = step(state, data.batch(i))
        sh = ckpt.shardings_of(state, state_specs(cfg, rt, state), mesh)
        ckpt.save_checkpoint(os.path.join(args["dir"], f"mesh_{name}"), 2,
                             state, shardings=sh)
        whole = ckpt._whole(state, sh)
        if dist.get_rank() == 0:
            torch.save(whole, os.path.join(args["dir"],
                                           f"whole_{name}.pt"))
        # the reverse: the parent's unsharded checkpoint onto this mesh
        like = init_train_state(cfg, opt, seed=1, device="cpu", rt=rt)
        sh = ckpt.shardings_of(like, state_specs(cfg, rt, like), mesh)
        got, _ = ckpt.restore_checkpoint(
            os.path.join(args["dir"], f"plain_{name}"), 3, like,
            shardings=sh)
        plain = torch.load(os.path.join(args["dir"], f"plain_{name}.pt"),
                           weights_only=False)
        flat_got = torch.utils._pytree.tree_leaves(got)
        flat_want = torch.utils._pytree.tree_leaves(plain)
        flat_sh = torch.utils._pytree.tree_flatten(like)[1].flatten_up_to(sh)
        equal = True
        for g, w, s in zip(flat_got, flat_want, flat_sh):
            if isinstance(g, torch.Tensor):
                w = distribute(w, s.spec, mesh) if s is not None else w
                equal &= bool(torch.equal(g.detach(), w))
            else:
                equal &= g == w
        out[name] = {"restored_equal": equal}
    return out


def task_steps(args):
    """Sharded train steps (AdamW and Adafactor, microbatches) against the
    same steps without a mesh: the losses and the final parameters."""
    cfg = reduced(get_arch(args["arch"]))
    mesh = _mesh(*args["mesh"])
    out = {}
    for name in ("adamw", "adafactor"):
        res = {}
        for tag, rt in (("local", M.Runtime(torch.float32)),
                        ("mesh", M.Runtime(torch.float32, mesh=mesh,
                                           fsdp=args.get("fsdp", False)))):
            tcfg = TrainConfig(total_steps=8, optimizer=name,
                               learning_rate=1e-2)
            opt = make_optimizer_for(tcfg, cfg, rt)
            state = init_train_state(cfg, opt, seed=0, device="cpu", rt=rt)
            step = make_train_step(cfg, rt, opt, microbatches=2)
            data = SyntheticLMData(cfg, seq_len=16, global_batch=4, seed=0)
            losses = []
            for i in range(3):
                state, m = step(state, data.batch(i))
                losses.append(float(m["loss"]))
            if rt.mesh is not None:
                specs = M.param_partition_specs(cfg, rt, param_shapes(cfg))
                params = {k: full_tensor(p, specs[k], mesh,
                                         param_shapes(cfg)[k])
                          for k, p in state.params.items()}
            else:
                params = {k: p.detach() for k, p in state.params.items()}
            res[tag] = (losses, params)
        worst = max(float((res["mesh"][1][k] - p).abs().max())
                    for k, p in res["local"][1].items())
        out[name] = {"local": res["local"][0], "mesh": res["mesh"][0],
                     "param_diff": worst}
    return out


TASKS = {"families": task_families, "moe_bodies": task_moe_bodies,
         "collective": task_collective, "elastic": task_elastic,
         "steps": task_steps}


def main() -> int:
    task, args = sys.argv[1], json.loads(sys.argv[2])
    with mesh_mod.process_group("cpu", timeout_s=TIMEOUT_S):
        out = TASKS[task](args)
        if dist.get_rank() == 0:
            print("RESULT " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
