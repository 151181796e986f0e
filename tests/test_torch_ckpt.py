"""The port's checkpointing (`repro_torch.train.checkpoint`) against the JAX
package's: the checkpoint half of tests/test_data_optim_ckpt.py on the
same NumPy state in both packages (round trip, retention and latest,
atomicity, the async manager and resume, a structure mismatch), the
resume of a reduced training run, and the launcher's ``--checkpoint-dir``:
a run stopped by SIGINT and resumed equals the uninterrupted run, and the
governor's checkpoint_now is followed by a save at that step.

Tolerances: checkpoints restore bit for bit, and a resumed run's losses and
weights equal the uninterrupted run's bit for bit on the CPU (the reference
asks 1e-6 of its resumed weights).
"""
import os
import signal

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.config import TrainConfig, get_arch, reduced  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.model import Runtime  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.step import (TrainState, init_train_state,  # noqa: E402
                                    make_optimizer_for, make_train_step)


def _numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 8)).astype(np.float32),
            "b": rng.standard_normal(3).astype(np.float32)}


def _both(seed=0):
    """The same state in each package: (port's, reference's)."""
    a = _numpy_state(seed)
    mine = {"params": {k: torch.from_numpy(v.copy()) for k, v in a.items()},
            "step": 7}
    theirs = {"params": {k: jnp.asarray(v) for k, v in a.items()},
              "step": jnp.int32(7)}
    return mine, theirs


def test_checkpoint_roundtrip(tmp_path):
    mine, theirs = _both()
    ckpt.save_checkpoint(str(tmp_path / "t"), 7, mine, meta={"loss": 1.5})
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, theirs, meta={"loss": 1.5})
    got, meta = ckpt.restore_checkpoint(str(tmp_path / "t"), 7, mine)
    jgot, jmeta = jckpt.restore_checkpoint(str(tmp_path / "j"), 7, theirs)
    for k in ("w", "b"):
        np.testing.assert_array_equal(got["params"][k].numpy(),
                                      np.asarray(jgot["params"][k]))
        np.testing.assert_array_equal(got["params"][k].numpy(),
                                      _numpy_state()[k])
    assert got["step"] == int(jgot["step"]) == 7
    assert meta == jmeta == {"loss": 1.5}


def test_checkpoint_retention_and_latest(tmp_path):
    mine, theirs = _both()
    for step in [1, 2, 3, 4, 5]:
        ckpt.save_checkpoint(str(tmp_path / "t"), step, mine, keep=2)
        jckpt.save_checkpoint(str(tmp_path / "j"), step, theirs, keep=2)
    assert ckpt.all_steps(str(tmp_path / "t")) == \
        jckpt.all_steps(str(tmp_path / "j")) == [4, 5]
    assert ckpt.latest_step(str(tmp_path / "t")) == 5
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    # a staging dir left by a crash is neither a step nor the latest
    os.makedirs(tmp_path / "t" / "step_00000009.tmp")
    assert ckpt.latest_step(str(tmp_path / "t")) == 5


def test_checkpoint_atomicity_no_tmp_left(tmp_path):
    mine, _ = _both()
    ckpt.save_checkpoint(str(tmp_path), 1, mine)
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]
    assert sorted(os.listdir(tmp_path / "step_00000001")) == \
        ["manifest.json", "state.pt"]


def test_checkpoint_manager_async_and_resume(tmp_path):
    mine, theirs = _both(3)
    mgr = ckpt.CheckpointManager(str(tmp_path / "t"), keep=3)
    jmgr = jckpt.CheckpointManager(str(tmp_path / "j"), keep=3)
    for m, s in ((mgr, mine), (jmgr, theirs)):
        m.save(10, s, meta={"loss": 2.0})
        m.save(20, s, meta={"loss": 1.0})
        m.wait()
    got, meta, step = mgr.restore_latest(mine)
    jgot, jmeta, jstep = jmgr.restore_latest(theirs)
    assert step == jstep == 20 and meta["loss"] == jmeta["loss"] == 1.0
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  np.asarray(jgot["params"]["w"]))
    assert [s["step"] for s in mgr.saves] == [10, 20]
    assert all(s["write_s"] > 0 and s["stall_s"] >= 0 for s in mgr.saves)
    assert mgr.saves[0]["bytes"] == (64 + 3) * 4
    mgr.close()
    jmgr.close()
    empty = ckpt.CheckpointManager(str(tmp_path / "e"))
    assert empty.restore_latest(mine) == (None, None, None)
    empty.close()


def test_checkpoint_manager_snapshots_before_in_place_updates(tmp_path):
    """Training updates its tensors in place right after a save: the
    write must hold the values at the save."""
    state, _ = _both()
    want = state["params"]["w"].clone()
    mgr = ckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    state["params"]["w"].add_(1.0)
    mgr.close()
    got, _ = ckpt.restore_checkpoint(str(tmp_path), 1, state)
    torch.testing.assert_close(got["params"]["w"], want, rtol=0, atol=0)


def test_checkpoint_structure_mismatch_raises(tmp_path):
    mine, theirs = _both()
    ckpt.save_checkpoint(str(tmp_path / "t"), 1, mine)
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, theirs)
    bad = {"params": {"w": torch.zeros(8, 8), "b": torch.zeros(3),
                      "extra": torch.zeros(3)}, "step": 0}
    jbad = {"params": {"w": jnp.zeros((8, 8)), "b": jnp.zeros(3),
                       "extra": jnp.zeros(3)}, "step": jnp.int32(0)}
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(str(tmp_path / "t"), 1, bad)
    with pytest.raises(ValueError):
        jckpt.restore_checkpoint(str(tmp_path / "j"), 1, jbad)
    wrong = {"params": {"w": torch.zeros(4, 8), "b": torch.zeros(3)},
             "step": 0}
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore_checkpoint(str(tmp_path / "t"), 1, wrong)


def test_restore_follows_the_like_state_s_leaves(tmp_path):
    """A `TrainState` comes back as one: each tensor in the dtype and with
    the ``requires_grad`` of ``like``'s leaf, the host numbers as saved."""
    cfg = reduced(get_arch("gpt2"))
    opt = make_optimizer_for(TrainConfig(total_steps=4), cfg)
    state = init_train_state(cfg, opt, seed=0, device="cpu")._replace(step=3)
    ckpt.save_checkpoint(str(tmp_path), 3, state)
    like = init_train_state(cfg, opt, seed=1, device="cpu")
    k0 = next(iter(like.params))
    like.params[k0] = like.params[k0].detach().bfloat16()
    got, _ = ckpt.restore_checkpoint(str(tmp_path), 3, like)
    assert isinstance(got, TrainState) and got.step == 3
    for k, p in got.params.items():
        assert p.dtype == like.params[k].dtype
        assert p.requires_grad == like.params[k].requires_grad
        torch.testing.assert_close(p, state.params[k].detach().to(p.dtype),
                                   rtol=0, atol=0)
    assert got.params[k0].dtype == torch.bfloat16
    assert not got.params[k0].requires_grad
    assert got.opt_state["step"] == state.opt_state["step"]


def test_full_train_resume_equivalence(tmp_path):
    """Crash/restart must reproduce the uninterrupted run exactly
    (deterministic pipeline + checkpoint restore)."""
    cfg = reduced(get_arch("gpt2"))
    rt = Runtime(compute_dtype=torch.float32)
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=8, warmup_steps=1)
    opt = make_optimizer_for(tcfg, cfg)
    data = SyntheticLMData(cfg, seq_len=16, global_batch=4, seed=1)
    step_fn = make_train_step(cfg, rt, opt)

    # uninterrupted
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    for s in range(8):
        state, m = step_fn(state, data.batch(s))
    w_full = [p.detach().clone() for p in state.params.values()]

    # interrupted at step 4 + resumed
    state = init_train_state(cfg, opt, seed=0, device="cpu")
    for s in range(4):
        state, m = step_fn(state, data.batch(s))
    ckpt.save_checkpoint(str(tmp_path), 4, state)
    like = init_train_state(cfg, opt, seed=5, device="cpu")
    state2, _ = ckpt.restore_checkpoint(str(tmp_path), 4, like)
    for s in range(4, 8):
        state2, m = step_fn(state2, data.batch(s))
    for a, b in zip(w_full, state2.params.values()):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=0)


def _launcher(ckpt_dir, steps=12, every=4, spec='{"mode": "off"}'):
    return launch_train.parser().parse_args(
        ["--reduced", "--device", "cpu", "--steps", str(steps), "--batch",
         "2", "--seq", "16", "--log-every", "0", "--monitor-spec", spec,
         "--checkpoint-dir", str(ckpt_dir), "--checkpoint-every",
         str(every)])


def _interrupt_at(monkeypatch, step):
    """SIGINT to this process while the launcher fetches ``step``'s batch
    (mid-step, before the step runs)."""
    batch = SyntheticLMData.batch

    def batch_then_sigint(self, s):
        if s == step:
            signal.raise_signal(signal.SIGINT)
        return batch(self, s)

    monkeypatch.setattr(SyntheticLMData, "batch", batch_then_sigint)


def test_launcher_resume_after_sigint_equals_the_uninterrupted_run(
        tmp_path, monkeypatch):
    """Preemption the reference's way: SIGINT, KeyboardInterrupt, a save.
    The step in flight finishes first; the resumed run starts at the saved
    step, and the two halves' losses are the uninterrupted run's."""
    full = launch_train.train(_launcher(tmp_path / "full"))
    assert not full["interrupted"] and len(full["losses"]) == 12
    assert [s["step"] for s in full["saves"]] == [4, 8, 12]

    with monkeypatch.context() as m:
        _interrupt_at(m, 6)
        first = launch_train.train(_launcher(tmp_path / "cut"))
    assert first["interrupted"] and len(first["losses"]) == 7  # 0..6
    assert [s["step"] for s in first["saves"]] == [4, 7]
    assert ckpt.all_steps(str(tmp_path / "cut")) == [4, 7]
    second = launch_train.train(_launcher(tmp_path / "cut"))
    assert second["start_step"] == 7 and not second["interrupted"]
    assert first["losses"] + second["losses"] == full["losses"]
    assert not [d for d in os.listdir(tmp_path / "cut")
                if d.endswith(".tmp")]
    cfg = reduced(get_arch("gpt2"))
    like = init_train_state(cfg, make_optimizer_for(TrainConfig(
        total_steps=12), cfg), device="cpu")
    w_full, _ = ckpt.restore_checkpoint(str(tmp_path / "full"), 12, like)
    w_cut, _ = ckpt.restore_checkpoint(str(tmp_path / "cut"), 12, like)
    for k in w_full.params:
        torch.testing.assert_close(w_full.params[k], w_cut.params[k],
                                   rtol=0, atol=0)
    assert launch_train.main(["--reduced", "--device", "cpu", "--steps",
                              "12", "--batch", "2", "--seq", "16",
                              "--log-every", "0", "--checkpoint-dir",
                              str(tmp_path / "cut")]) == 0


def test_second_sigint_interrupts_at_once():
    with launch_train.interrupt_between_steps() as stop:
        signal.raise_signal(signal.SIGINT)
        assert stop.is_set()
        with pytest.raises(KeyboardInterrupt):
            signal.raise_signal(signal.SIGINT)
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler


def test_second_sigint_mid_step_keeps_the_last_periodic_checkpoint(
        tmp_path, monkeypatch):
    """Two SIGINTs inside step 6, after its in-place update and before its
    loss is logged: the second interrupts at once, the launcher saves
    nothing more, and the run resumed from step 4 still equals the
    uninterrupted one."""
    full = launch_train.train(_launcher(tmp_path / "full"))
    make = launch_train.make_train_step

    def make_cut(*a, **k):
        step_fn, calls = make(*a, **k), []

        def cut(state, batch):
            out = step_fn(state, batch)
            calls.append(None)
            if len(calls) == 7:  # step 6 has updated the state in place
                signal.raise_signal(signal.SIGINT)
                signal.raise_signal(signal.SIGINT)
            return out

        return cut

    with monkeypatch.context() as m:
        m.setattr(launch_train, "make_train_step", make_cut)
        first = launch_train.train(_launcher(tmp_path / "cut"))
    assert first["interrupted"] and len(first["losses"]) == 6  # 0..5
    assert [s["step"] for s in first["saves"]] == [4]
    assert ckpt.all_steps(str(tmp_path / "cut")) == [4]
    second = launch_train.train(_launcher(tmp_path / "cut"))
    assert second["start_step"] == 4 and not second["interrupted"]
    assert first["losses"][:4] + second["losses"] == full["losses"]


def test_governor_checkpoint_now_is_followed_by_a_save(tmp_path,
                                                       monkeypatch):
    """A diagnosis planted at the stream cadence point of step 8 blames
    python_latency, whose policy is checkpoint_now: the launcher saves the
    state after that step."""
    from repro_torch.core.governor import Governor
    from repro_torch.diagnosis.engine import Diagnosis
    from repro_torch.session.session import Session

    planted = Diagnosis(incident_id=1, fault_kind="python_latency",
                        family="straggler", confidence=0.9, severity=0.5,
                        blamed_nodes=[0], causal_chain=[], action=None,
                        steps=[7, 8], t_start=0.0, t_end=0.1,
                        candidates={"python_latency": 0.9}, evidence={})
    planted.action = Governor().act(planted)
    assert planted.action.kind == "checkpoint_now"
    detect = Session._detect_step

    def detect_planted(self, step, out):
        detect(self, step, out)
        if step == 8:
            out.diagnoses.append(planted)

    monkeypatch.setattr(Session, "_detect_step", detect_planted)
    run = launch_train.train(_launcher(
        tmp_path, steps=16, every=100,
        spec='{"mode": "stream", "detector": {"flush_every": 4}}'))
    kinds = [a.kind for a in run["actions"]]
    now = [s for a, s in zip(run["actions"], run["action_steps"])
           if a.kind == "checkpoint_now"]
    assert "checkpoint_now" in kinds and 8 in now
    saved = [(s["step"], s["reason"]) for s in run["saves"]]
    assert all((s + 1, "governor") in saved for s in set(now))
    assert saved[-1] == (16, "periodic")
