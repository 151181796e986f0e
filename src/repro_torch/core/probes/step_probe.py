"""Step-level observer: runtime wrapping of the already-built step callable.

The monitor (not the user) wraps the step function at attach time — exactly
the eBPF model of hooking a symbol at runtime: the training loop's code is
unchanged, the launcher simply executes whatever callable the monitor hands
back. Records wall-time per step and drives the dependent probes (operator
latency attribution, collective schedule replay, device duty cycle).
"""
from __future__ import annotations

import os
import time
from typing import Callable

import torch

from repro_torch.core.events import Layer
from repro_torch.core.probes import runtime_probe
from repro_torch.core.probes.base import Probe
from repro_torch.core.probes.device_probe import H100_PEAK_FLOPS


# steps that last this long or more wait on a blocking CUDA event, shorter
# ones spin (`StepProbe.wrap`): on the H100 a spinning wait took the 0.7 ms
# synthetic eval step's p50 from 0.75 to 0.54 ms, and a blocking one cut
# the 10 ms GPT-2 step's multi-ms stalls
SPIN_BELOW_S = 0.002


class StepProbe(Probe):
    name = "step"

    def __init__(self, operator_probe=None, collective_probe=None,
                 device_probe=None, flops_per_step: float = 0.0,
                 peak_flops: float = H100_PEAK_FLOPS,
                 mem_gb_per_step: float = 0.0):
        super().__init__()
        self.operator_probe = operator_probe
        self.collective_probe = collective_probe
        self.device_probe = device_probe
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.mem_gb_per_step = mem_gb_per_step
        self.step_count = 0
        self.extra_latency = 0.0  # chaos hook: python-layer delay (real sleep)
        # chaos hooks per monitored layer (seconds added to that layer's view):
        self.extra_xla = 0.0   # DCGM kernel-timeout analogue
        self.extra_op = 0.0    # pytorchfi operator-delay analogue
        # the CUDA events a step waits on, by blocking (see `wrap`), and the
        # last step's measured execution time, which picks between them
        self._done = {}
        self._last_exec = float("inf")

    def _attach(self) -> None:
        pass

    def _detach(self) -> None:
        pass

    def wrap(self, fn: Callable) -> Callable:
        """Return a monitored version of `fn` (user code untouched)."""

        def monitored(*args, **kwargs):
            runtime_probe.hold()  # its rows wait until the step is timed
            try:
                return timed(*args, **kwargs)
            finally:
                runtime_probe.release()

        def timed(*args, **kwargs):
            t0 = self.now()
            out = fn(*args, **kwargs)
            # PyTorch returns before the card finishes: wait for the step's
            # kernels (its stream, not the device: the detection plane's
            # sweeps run on a stream of their own) so the duration is the
            # step's, not its enqueue time. A step that took SPIN_BELOW_S or
            # more waits on a blocking event: the thread sleeps until the
            # card signals, where a spinning thread is late whenever its
            # core is taken from it while the step ends. A shorter one
            # spins: waking a sleeping thread costs a short step a large
            # share of its time, and the wake-up's spread with it. The wait
            # is the monitor's, not the job's: the runtime probe does not
            # record it (the reference's block_until_ready raises no
            # runtime event either)
            if torch.cuda.is_initialized():
                blocking = self._last_exec >= SPIN_BELOW_S
                done = self._done.get(blocking)
                if done is None:
                    done = self._done[blocking] = torch.cuda.Event(
                        blocking=blocking)
                done.record()
                with runtime_probe.unobserved():
                    done.synchronize()
            exec_dur = self.now() - t0
            self._last_exec = exec_dur
            if self.extra_latency:  # python-layer fault: real host-side stall
                time.sleep(self.extra_latency)
            t1 = self.now()
            dur = (t1 - t0) + self.extra_xla + self.extra_op
            step = self.step_count
            self.step_count += 1
            # runtime layer: the executable-run duration an eBPF uprobe on
            # the runtime's launch symbols would time (CUDA-layer analogue)
            pid = os.getpid()
            self.emit_rows(Layer.XLA, "executable_run", t0,
                           dur=exec_dur + self.extra_xla, step=step, pid=pid)
            self.emit_rows(Layer.STEP, "train_step", t0, dur=dur, step=step,
                           pid=pid)
            comm = 0.0
            if self.collective_probe is not None and self.collective_probe.attached:
                comm = self.collective_probe.observe_step(step, t0)
            if self.operator_probe is not None and self.operator_probe.attached:
                self.operator_probe.observe_step(
                    step, max(exec_dur - comm, 0.0) + self.extra_op, t0)
            if self.device_probe is not None:
                duty = 0.0
                if dur > 0 and self.flops_per_step:
                    duty = min(1.0, self.flops_per_step / self.peak_flops / dur)
                elif dur > 0:
                    duty = min(1.0, 0.7 + 0.1 * (dur % 0.1))
                self.device_probe.current_duty = duty
                self.device_probe.current_mem_gb = self.mem_gb_per_step
                # the sampler process's finished sweeps join the table here,
                # after the step's timed window, on the thread that owns it
                self.device_probe.step_done(t1, self.step_count)
            return out

        monitored.__wrapped__ = fn
        return monitored
