"""Fault tolerance: failure injection, the restart-from-checkpoint
driver and straggler monitoring, the port's copy of the reference's
``runtime/fault.py``.

The contract: the data is a pure function of the step, checkpoints are
periodic and asynchronous, and the driver restores the latest
checkpoint on a failure and replays, ending BITWISE-identical to an
uninterrupted run.  Straggler mitigation watches each step's wall time
against a running EMA and records the steps past a threshold multiple.

Under data parallelism every rank runs ``run_with_restarts`` with the
same injector, so an injected failure is raised on every rank at the
same step, before the step's collectives; the checkpointer, built on
the mesh's data-parallel group, writes from rank 0, and its ``wait`` and
``latest_step`` are collective, so every rank restores the same
checkpoint and replays the same steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

__all__ = ["SimulatedFailure", "FailureInjector", "StragglerMonitor",
           "run_with_restarts"]


class SimulatedFailure(RuntimeError):
    """Stands in for a node crash / preemption in tests and drills."""


@dataclass
class FailureInjector:
    fail_at_steps: frozenset = frozenset()
    failed: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self.failed:
            self.failed.add(step)     # fail once per step, then recover
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclass
class StragglerMonitor:
    """EMA step-time watchdog."""
    threshold: float = 3.0
    alpha: float = 0.2
    ema: float | None = None
    events: list = field(default_factory=list)

    def record(self, step: int, dt: float) -> bool:
        is_straggler = (self.ema is not None
                        and dt > self.threshold * self.ema)
        if is_straggler:
            self.events.append((step, dt, self.ema))
        else:
            # stragglers don't poison the EMA
            self.ema = dt if self.ema is None else (
                (1 - self.alpha) * self.ema + self.alpha * dt)
        return is_straggler


def run_with_restarts(*, n_steps: int, state, train_step, data, ckpt,
                      checkpoint_every: int, injector=None, monitor=None,
                      max_restarts: int = 10, log_every: int = 0,
                      on_metrics=None):
    """The restartable training driver.

    Replays from the latest checkpoint on an (injected or real) failure.
    Returns ``(final_state, info)``, ``info`` holding the restarts and
    the straggler events.  ``data.batch(step)`` must be pure, so replay
    reproduces the uninterrupted run exactly.  ``ckpt.restore`` writes
    the checkpoint into the state's own tensors (the model's parameters
    among them)."""
    restarts = 0
    start = int(state.step)
    step = start
    if checkpoint_every and ckpt.latest_step() is None:
        ckpt.save(start, state, blocking=True)   # recovery anchor
    while step < n_steps:
        try:
            while step < n_steps:
                t0 = time.perf_counter()
                if injector is not None:
                    injector.check(step)
                batch = data.batch(step)
                state, metrics = train_step(state, batch)
                dt = time.perf_counter() - t0
                if monitor is not None:
                    monitor.record(step, dt)
                step += 1
                if checkpoint_every and step % checkpoint_every == 0:
                    ckpt.save(step, state)
                if log_every and step % log_every == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    print(f"step {step}: " + " ".join(
                        f"{k}={v:.4f}" for k, v in sorted(m.items())))
                if on_metrics is not None:
                    on_metrics(step, metrics)
        except SimulatedFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            ckpt.wait()
            last = ckpt.latest_step()
            if last is None:
                raise SimulatedFailure(
                    "failure before any checkpoint") from e
            state = ckpt.restore(last, state)
            step = last
    ckpt.wait()
    info = {"restarts": restarts,
            "straggler_events": list(monitor.events) if monitor else []}
    return state, info
