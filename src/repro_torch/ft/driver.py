"""Fault-tolerant training driver: checkpoint/restart, failure injection,
straggler watchdog (a port of ``repro/ft/driver.py``).

Restart contract: state = (params, opt_state, step). Data is a pure
function of step (``data/lm_data.py``), so resume is exact: kill the
process at any step, relaunch, and the loss history continues as if
uninterrupted (the port's training step repeats exactly on the card:
the attention backward uses no atomics and the MoE dispatch and combine
fix their order; ``chip_smoke.py``'s phase ``train`` checks a resume).
Each step ends in a device synchronisation (the JAX driver's
``block_until_ready``), so the step times are the device's. The straggler watchdog flags steps slower
than ``straggler_factor`` times the median; SIGTERM stops after the
current step, with a checkpoint.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Optional

import torch

from ..checkpoint import CheckpointManager

__all__ = ["DriverConfig", "TrainDriver", "FailureInjector"]


@dataclasses.dataclass
class DriverConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    async_save: bool = True
    straggler_factor: float = 3.0   # step slower than factor x median -> flag
    log_every: int = 10


class FailureInjector:
    """Deterministic crash for FT tests: raises at a chosen step."""

    def __init__(self, fail_at_step: Optional[int] = None):
        self.fail_at_step = fail_at_step
        self.fired = False

    def maybe_fail(self, step: int) -> None:
        if self.fail_at_step is not None and step == self.fail_at_step \
                and not self.fired:
            self.fired = True
            raise RuntimeError(f"injected failure at step {step}")


def _sync(metrics: dict) -> None:
    """Wait for the devices that hold the step's metrics."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


class TrainDriver:
    def __init__(self, cfg: DriverConfig, step_fn: Callable,
                 init_state: Callable[[], tuple],
                 batch_fn: Callable[[int], tuple],
                 injector: Optional[FailureInjector] = None):
        """step_fn(params, opt_state, *batch) -> (params, opt_state, metrics);
        init_state() -> (params, opt_state); batch_fn(step) -> batch tuple."""
        self.cfg = cfg
        self.step_fn = step_fn
        self.init_state = init_state
        self.batch_fn = batch_fn
        self.injector = injector or FailureInjector()
        self.mgr = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep,
                                     async_save=cfg.async_save)
        self.step_times: list[float] = []
        self.stragglers: list[int] = []
        self.history: list[dict] = []
        self._stop = False

    def _install_signals(self) -> None:
        def handler(signum, frame):
            self._stop = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on main thread (tests)

    def run(self) -> dict:
        self._install_signals()
        params, opt_state = self.init_state()
        start = 0
        last = self.mgr.latest_step()
        if last is not None:
            (params, opt_state), start, extra = self.mgr.restore(
                (params, opt_state))
            start += 1
        t_wall = time.perf_counter()
        for step in range(start, self.cfg.total_steps):
            self.injector.maybe_fail(step)
            t0 = time.perf_counter()
            batch = self.batch_fn(step)
            params, opt_state, metrics = self.step_fn(params, opt_state,
                                                      *batch)
            _sync(metrics)
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            med = sorted(self.step_times)[len(self.step_times) // 2]
            if len(self.step_times) > 5 and dt > self.cfg.straggler_factor * med:
                self.stragglers.append(step)
            self.history.append({"step": step,
                                 **{k: float(v) for k, v in metrics.items()}})
            if (step + 1) % self.cfg.ckpt_every == 0 or self._stop \
                    or step + 1 == self.cfg.total_steps:
                self.mgr.save(step, (params, opt_state),
                              extra={"wall": time.perf_counter() - t_wall})
            if self._stop:
                break
        self.mgr.wait()
        return {"params": params, "opt_state": opt_state,
                "history": self.history, "stragglers": self.stragglers}
