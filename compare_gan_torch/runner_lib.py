"""Schedules, task manager and the training loop (counterpart of
compare_gan_tpu/runner_lib.py; the `train` schedule only).

The loop runs `iterations_per_loop` steps between host syncs. At each sync
it reads the loop's mean losses (which waits for the device), reports
progress and, on the save cadence or at the last step, checkpoints. A run
resumes from the latest checkpoint in model_dir and fast-forwards the input
stream so it consumes the batches an unbroken run would.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch import datasets
from compare_gan_torch import hooks as hooks_lib

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RunConfig:
    model_dir: str
    tf_random_seed: Optional[int] = None
    iterations_per_loop: int = 100
    save_checkpoints_steps: int = 5000
    keep_checkpoint_max: int = 1000
    device: str = "cuda"


@gin.configurable("options")
def get_options_dict(batch_size=None, gan_class=None, architecture=None,
                     training_steps=None, discriminator_normalization=None,
                     lamba=1, disc_iters=1, z_dim=128):
    """Legacy options dict from gin `options.*` (`lamba` [sic] keeps the
    reference's binding name)."""
    del discriminator_normalization
    for req, name in [(batch_size, "batch_size"), (gan_class, "gan_class"),
                      (architecture, "architecture"),
                      (training_steps, "training_steps")]:
        if req is None:
            raise gin.ConfigError(f"options.{name} is required.")
    return {"batch_size": batch_size, "gan_class": gan_class,
            "architecture": architecture, "training_steps": training_steps,
            "lambda": lamba, "disc_iters": disc_iters, "z_dim": z_dim}


class TaskManager:
    """The TRAIN_DONE marker and progress reports."""

    def __init__(self, model_dir):
        self._model_dir = model_dir

    @property
    def model_dir(self):
        return self._model_dir

    def mark_training_done(self):
        os.makedirs(self.model_dir, exist_ok=True)
        with open(os.path.join(self.model_dir, "TRAIN_DONE"), "w") as f:
            f.write("")

    def report_progress(self, message):
        logger.info("%s", message)


@dataclasses.dataclass
class TrainReport:
    """What `train` did: the final TrainState (None when the model_dir was
    already trained) and, per host sync, the step reached, the wall seconds
    per step of that loop (device work included) and the mean losses."""
    state: object = None
    steps: List[int] = dataclasses.field(default_factory=list)
    seconds_per_step: List[float] = dataclasses.field(default_factory=list)
    metrics: List[Dict[str, float]] = dataclasses.field(default_factory=list)


def _save_operative_config(model_dir, step):
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, f"operative_config-{step}.gin"),
              "w") as f:
        f.write(gin.operative_config_str())


def train(gan, run_config: RunConfig, task_manager: TaskManager,
          batch_size: int, max_steps: int) -> TrainReport:
    model_dir = run_config.model_dir
    os.makedirs(model_dir, exist_ok=True)
    report = TrainReport()
    latest = ckpt_lib.latest_checkpoint(model_dir)
    if latest and ckpt_lib.step_of(latest) >= max_steps:
        return report  # Nothing to do; the device is never touched.

    seed = (547 if run_config.tf_random_seed is None
            else run_config.tf_random_seed)
    ts = gan.init_state(seed)
    for module in (ts.generator, ts.discriminator):
        logger.info("%s: %d variables, %s parameters", module.name,
                    len(module.jax_variables()[0]),
                    f"{core.count_params(module):,}")
    if latest:
        ts = ckpt_lib.restore_checkpoint(latest, ts)
    report.state = ts
    start_step = ts.step
    if start_step == 0:
        ckpt_lib.save_checkpoint(model_dir, ts, 0,
                                 run_config.keep_checkpoint_max)
    if start_step >= max_steps:
        return report

    train_step = gan.make_train_step(batch_size)
    saver = ckpt_lib.AsyncCheckpointSaver(
        model_dir, run_config.save_checkpoints_steps,
        run_config.keep_checkpoint_max)
    saver.align(start_step)
    _save_operative_config(model_dir, start_step)
    batches = gan.input_batches(batch_size, skip_batches=start_step)
    loop_steps = run_config.iterations_per_loop
    progress = hooks_lib.ReportProgressHook(
        task_manager, max_steps=max_steps, every_n_steps=min(100, loop_steps))
    progress.report(start_step)

    step = start_step
    if gan.device.type == "cuda":
        torch.cuda.synchronize(gan.device)  # Set-up is not a step's time.
    while step < max_steps:
        n = min(loop_steps, max_steps - step)
        t0 = time.perf_counter()
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(n):
            ts, metrics = train_step(ts, next(batches))
            for k, v in metrics.items():
                sums[k] = sums[k] + v if k in sums else v
        # Reading the means waits for every step of the loop: the copy to
        # the host is queued after all of the loop's device work.
        means = {k: float(v) / n for k, v in sums.items()}
        report.seconds_per_step.append((time.perf_counter() - t0) / n)
        step += n
        report.steps.append(step)
        report.metrics.append(means)
        logger.info("step %d: %s", step, " ".join(
            f"{k}={v:.6g}" for k, v in sorted(means.items())))
        progress.report(step)
        if saver.should_save(step) or step >= max_steps:
            saver.save(ts, step)
    saver.join()
    return report


def run_with_schedule(schedule, run_config: RunConfig,
                      task_manager: TaskManager, options: Dict):
    """Run a schedule; returns the TrainReport of the `train` schedule."""
    if schedule != "train":
        raise NotImplementedError(
            f"Schedule {schedule!r} is not ported yet: the eval stack "
            f"(eval_after_train, continuous_eval) is listed in ROADMAP.md.")
    device = torch.device(run_config.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device=cuda but no CUDA device is available.")
    if run_config.tf_random_seed is not None:
        np.random.seed(run_config.tf_random_seed)
    seed = run_config.tf_random_seed
    dataset = datasets.get_dataset(seed=547 if seed is None else seed)
    gan = options["gan_class"](dataset=dataset, parameters=options,
                               model_dir=run_config.model_dir, device=device)
    report = train(gan, run_config, task_manager,
                   batch_size=options["batch_size"],
                   max_steps=options["training_steps"])
    task_manager.mark_training_done()
    return report
