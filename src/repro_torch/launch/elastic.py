"""Fault tolerance for long training runs (port of
`repro.launch.elastic`): checkpoint / restart, failure injection and
straggler detection.

  * `TrainSupervisor.run`: the step loop with periodic and on-signal
    checkpoints (SIGTERM, a preemption notice, checkpoints and stops),
    a restore from the latest checkpoint at start (a crash restart is
    the same command run again), straggler detection from step times,
    and `fail_at`, which raises at a given step to simulate a node
    failure.
  * Elastic re-mesh: `run(..., shardings=)` restores the latest
    checkpoint with the CURRENT mesh's placements
    (`checkpoint.manager.restore`), so a checkpoint saved on one mesh
    resumes on another (lose a pod, keep training); a sharded state's
    checkpoints are written whole by rank 0.
  * Data is keyed by (seed, step, host): there is no sampler state to
    save.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint import manager as ckpt


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps slower than `threshold` x the running median (of at
    least 8 steps in a window of `window`)."""

    window: int = 32
    threshold: float = 3.0
    times: list = dataclasses.field(default_factory=list)
    flagged: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        slow = len(self.times) >= 8 and dt > self.threshold * med
        if slow:
            self.flagged.append((step, dt, med))
        return slow


@dataclasses.dataclass
class TrainSupervisor:
    train_step: Callable        # (trainable, opt, batch) -> (loss, tr, opt)
    make_batch: Callable        # step -> device batch
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    monitor: StragglerMonitor = dataclasses.field(
        default_factory=StragglerMonitor)
    # raise at this step to simulate a node failure
    fail_at: Optional[int] = None

    def run(self, trainable, opt_state, *, n_steps: int,
            shardings=None) -> dict:
        """Runs or resumes training; -> a summary dict ("status",
        "step", "losses" of the steps run, "stragglers").  `shardings`
        ({"trainable": .., "opt": ..} of `sharding.rules.Sharding`s)
        places a restored state on the current mesh."""
        state = {"trainable": trainable, "opt": opt_state}
        start = 0
        last = ckpt.latest_step(self.ckpt_dir)
        if last is not None:
            state = ckpt.restore(self.ckpt_dir, last, state,
                                 shardings=shardings)
            start = last
        losses = []
        preempted = {"flag": False}

        def _on_signal(signum, frame):  # SIGTERM = preemption notice
            preempted["flag"] = True

        old = signal.signal(signal.SIGTERM, _on_signal)
        try:
            for step in range(start, n_steps):
                if self.fail_at is not None and step == self.fail_at:
                    raise RuntimeError(f"injected node failure @ {step}")
                t0 = time.time()
                batch = self.make_batch(step)
                loss, tr, opt = self.train_step(
                    state["trainable"], state["opt"], batch)
                loss = float(loss)
                state = {"trainable": tr, "opt": opt}
                dt = time.time() - t0
                slow = self.monitor.observe(step, dt)
                losses.append(loss)
                if slow:
                    print(f"[straggler] step {step}: {dt:.3f}s")
                if preempted["flag"] or (step + 1) % self.ckpt_every == 0:
                    ckpt.save(self.ckpt_dir, step + 1, state, keep=self.keep)
                    if preempted["flag"]:
                        return {"status": "preempted", "step": step + 1,
                                "losses": losses}
        finally:
            signal.signal(signal.SIGTERM, old)
        ckpt.save(self.ckpt_dir, n_steps, state, keep=self.keep)
        return {"status": "done", "step": n_steps, "losses": losses,
                "stragglers": list(self.monitor.flagged)}
