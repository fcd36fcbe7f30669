"""Training hooks of the port: its copy of compare_gan_tpu/hooks.py.

The reference's SessionRunHook classes (compare_gan/hooks.py) map onto plain
callables invoked by the training loop (runner_lib.train) at host syncs:

  EveryNSteps (hooks.py:49-113)             -> EveryNSteps below
  ReportProgressHook (hooks.py:116-148)     -> ReportProgressHook below

(The checkpoint hook is checkpoint.AsyncCheckpointSaver.)
"""

from __future__ import annotations

import time
from typing import Optional


class EveryNSteps:
    """Triggers every_n_steps after restarts stay aligned to multiples
    (reference EveryNSteps, hooks.py:49-113)."""

    def __init__(self, every_n_steps: int):
        self._every = every_n_steps
        self._last_triggered: Optional[int] = None

    def should_trigger(self, step: int) -> bool:
        if self._every <= 0:
            return False
        if self._last_triggered is None:
            return True
        return step >= self._last_triggered + self._every

    def mark_triggered(self, step: int) -> None:
        if self._every <= 0:
            return  # Disabled (should_trigger never fires).
        # Align to the previous multiple so a restart mid-interval keeps
        # the original cadence (reference hooks.py:37-46 realignment).
        self._last_triggered = (step // self._every) * self._every


class ReportProgressHook:
    """steps/sec + ETA progress strings to the TaskManager every
    `every_n_steps` (reference ReportProgressHook, hooks.py:116-148)."""

    def __init__(self, task_manager, max_steps: int, every_n_steps=100):
        assert max_steps > 0
        self._task_manager = task_manager
        self._max_steps = max_steps
        self._timer = EveryNSteps(every_n_steps)
        self._start_time: Optional[float] = None
        self._start_step: Optional[int] = None

    def report(self, step: int) -> None:
        now = time.time()
        if self._start_time is None:
            self._start_time = now
            self._start_step = step
            self._timer.mark_triggered(step)
            return
        if not self._timer.should_trigger(step):
            return
        self._timer.mark_triggered(step)
        steps_per_sec = (step - self._start_step) / max(
            now - self._start_time, 1e-9)
        eta_seconds = (self._max_steps - step) / max(steps_per_sec, 1e-9)
        message = (f"{step}/{self._max_steps} steps, "
                   f"{steps_per_sec:.1f} steps/sec, "
                   f"ETA: {eta_seconds / 3600.0:.2f} hours")
        self._task_manager.report_progress(message)
