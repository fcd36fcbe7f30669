"""Checkpoint evaluation (counterpart of compare_gan_tpu/eval_gan_lib.py).

A checkpoint is restored into the GAN's TrainState; then, on the GAN's
device:

* the BN accumulators are filled: `accu/update_accus` is set to 1,
  `num_accu_examples // batch_size` batches (204,800 samples by default,
  eval_gan_lib.py:65-92 of the reference) go through G in eval mode with
  the inference (EMA) params, committing state, and the switch is set back
  to 0; the filled TrainState is saved to `<model_dir>/tfhub/<step>`;
* `num_averaging_runs` fake sets of `eval_test_samples` images are sampled
  with the inference params; images of runs > 0 are freed once their
  features exist, unless a task reads the images themselves (MS-SSIM,
  fractal dimension): those see the images of every run;
* Inception features of the fakes and of the real eval split (computed
  once per `EvalCache`), then each task's metrics, averaged over the runs;
* the tasks that need G or D (`run_with_gan`: GILBO, D accuracy, Jacobian
  conditioning) run once per checkpoint, with `_std` 0.0. They are
  refused for conditional models, and each task's `validate_gan` runs
  before any of the checkpoint's work;
* NaN anywhere raises NanFoundError; the runner writes sentinel 31337.0.

The JAX package frees the images of runs > 0 whatever the tasks, so its
MS-SSIM and fractal dimension fail at more than one averaging run; the
two packages agree at one run.

Every eval batch draws its z (gin scope `eval_z`) and labels from its own
`torch.Generator`, seeded by (42, stream, batch): every checkpoint sees the
same latents. The bits differ from the JAX package's threefry draws, so the
two packages sample different images from one checkpoint; parity tests
hand the JAX draws to the port through the `draw` argument.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from compare_gan_torch import checkpoint as ckpt_lib
from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch import datasets as datasets_lib
from compare_gan_torch import eval_utils
from compare_gan_torch import export as export_lib
from compare_gan_torch import utils
from compare_gan_torch.ops import rng

NAN_DETECTED = 31337.0
NanFoundError = eval_utils.NanFoundError
EVAL_SEED = 42


@gin.configurable("eval_z", denylist=["shape", "generator"])
def z_generator(shape, generator, distribution_fn=rng.uniform, minval=-1.0,
                maxval=1.0, stddev=1.0):
    """Eval-time z distribution, gin scope `eval_z`
    (eval_gan_lib.py:43-63)."""
    return utils.call_with_accepted_args(
        distribution_fn, shape=shape, generator=generator, minval=minval,
        maxval=maxval, stddev=stddev)


def eval_draws(gan, batch_size, stream: str, index: int):
    """(z, labels or None) of one eval batch: `stream` is "accu" for the
    accumulator fill and "run<r>" for averaging run r."""
    gen = torch.Generator(device=gan.device)
    gen.manual_seed(core.seed_for(EVAL_SEED, f"eval/{stream}/{index}"))
    z = z_generator([batch_size, gan.z_dim], gen)
    labels = (rng.randint([batch_size], 0, gan.dataset.num_classes, gen)
              if gan.conditional else None)
    return z, labels


@dataclasses.dataclass
class EvalCache:
    """What the evaluations of one run's checkpoints share: the TrainState
    every checkpoint is restored into (the models are built once; after
    training, the trained TrainState itself) and the real split's
    features, which do not depend on the checkpoint."""
    template: object = None
    real: Dict = dataclasses.field(default_factory=dict)


def restored_state(gan, checkpoint_path, cache: EvalCache):
    """The checkpoint's TrainState, restored in place into the cache's
    template (built by `gan.init_state` when it has none)."""
    if cache.template is None:
        cache.template = gan.init_state(0)
    return ckpt_lib.restore_checkpoint(checkpoint_path, cache.template)


@dataclasses.dataclass
class PhaseLog:
    """Per eval phase: wall seconds, summed over its occurrences, and on a
    CUDA device the peak bytes allocated while it ran (the allocator's peak
    is reset when a phase starts). `task_seconds`: each task's seconds,
    summed over the averaging runs."""
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    task_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def task(self, task, device):
        """Time one task, the device's queued work included."""
        name = type(task).__name__
        t0 = time.perf_counter()
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.task_seconds[name] = (self.task_seconds.get(name, 0.0)
                                   + time.perf_counter() - t0)

    @contextlib.contextmanager
    def phase(self, name: str, device):
        """Time the block, the device's queued work included."""
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(device)
            self.peak_bytes[name] = max(
                self.peak_bytes.get(name, 0),
                torch.cuda.max_memory_allocated(device))
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)


def _update_bn_accumulators(gan, ts, batch_size, num_accu_examples,
                            draw: Optional[Callable] = None) -> bool:
    """Fill the BN accumulators of `ts` in place (eval_gan_lib.py:65-92);
    returns whether it has any. `draw(stream, index) -> (z, labels)`
    replaces `eval_draws` (tests)."""
    switches = [v for k, v in ts.state().items() if "accu/update_accus" in k]
    if not switches:
        return False
    draw = draw or (lambda s, i: eval_draws(gan, batch_size, s, i))
    with torch.no_grad():
        for s in switches:
            s.fill_(1)
        for i in range(num_accu_examples // batch_size):
            z, labels = draw("accu", i)
            gan.sample(ts, z, labels, is_training=False, commit_state=True)
        for s in switches:
            s.fill_(0)
    return True


def _make_sampler(gan, ts, draw: Callable):
    """`sample(run, i) -> [B, H, W, C]` numpy images in [0, 1]: batch i of
    averaging run `run`, G in eval mode with the inference params,
    committing no state."""

    def sample(run, i):
        z, labels = draw(f"run{run}", i)
        return gan.sample(ts, z, labels).float().cpu().numpy()

    return sample


def evaluate_checkpoint(gan, checkpoint_path, eval_tasks, batch_size=64,
                        num_averaging_runs=1, num_accu_examples=204800,
                        draw=None, ts=None, cache: Optional[EvalCache] = None,
                        log: Optional[PhaseLog] = None,
                        export_accu_checkpoint=True) -> Dict[str, float]:
    """Evaluate one checkpoint (reference evaluate_tfhub_module,
    eval_gan_lib.py:95-212). Returns {metric_{mean,std,list}: value}.
    `ts`, when given, is the checkpoint already restored (it is changed in
    place); `cache` carries the restore template and the real features
    from one checkpoint to the next; `log` gets each phase's seconds and
    peak memory. Without `export_accu_checkpoint` the filled state is not
    saved to `<model_dir>/tfhub/<step>`."""
    cache = cache if cache is not None else EvalCache()
    if ts is None:
        ts = restored_state(gan, checkpoint_path, cache)
    return _evaluate(gan, ts, eval_tasks, batch_size=batch_size,
                     num_averaging_runs=num_averaging_runs,
                     num_accu_examples=num_accu_examples,
                     checkpoint_path=checkpoint_path, draw=draw,
                     cache=cache, log=log,
                     export_accu_checkpoint=export_accu_checkpoint)


def evaluate_tfhub_module(export_dir, eval_tasks, dataset=None,
                          batch_size=64, num_averaging_runs=1,
                          num_accu_examples=204800, device="cuda",
                          draw=None) -> Dict[str, float]:
    """Evaluate a module export directory (`export.export_module`): its
    inference params and state, under its own gin snapshot, with no
    checkpoint and no live config."""
    spec, generator = export_lib._loaded(export_dir, "gen", device)
    with export_lib._export_config_scope(spec):
        if dataset is None:
            if "dataset" not in spec:
                raise ValueError("Pass the dataset used for training.")
            dataset = datasets_lib.get_dataset(spec["dataset"])
        gan = _ExportGAN(export_dir, spec, generator, dataset, device)
        return _evaluate(gan, gan, eval_tasks, batch_size=batch_size,
                         num_averaging_runs=num_averaging_runs,
                         num_accu_examples=num_accu_examples,
                         checkpoint_path=None, draw=draw)


class _ExportGAN:
    """Just enough GAN and TrainState surface for `_evaluate` over an
    export, the tasks that need G or D included: the export's G
    (`export._loaded`), holding its (already EMA-resolved) params and its
    state, its D (built on first use), and its training prior."""

    model_dir = None

    def __init__(self, export_dir, spec, generator, dataset, device):
        self._export_dir = export_dir
        self._spec = spec
        self.dataset = dataset
        self.device = torch.device(device)
        self.z_dim = spec["z_dim"]
        self.conditional = spec["conditional"]
        self.generator = generator
        self._discriminator = None

    @property
    def discriminator(self):
        if self._discriminator is None:
            _, self._discriminator = export_lib._loaded(
                self._export_dir, "disc", self.device)
        return self._discriminator

    def state(self):
        return self.generator.jax_variables()[1]

    def z_generator(self, shape, generator):
        """The export's training prior (gin scope `z` of its snapshot)."""
        return export_lib.snapshot_z(self._spec, shape, generator)

    def sample(self, ts, z, labels=None, is_training=False,
               commit_state=False, differentiable=False):
        del ts  # The export is its own state.
        z = torch.as_tensor(z, device=self.device)
        y = export_lib._one_hot(self._spec, labels, len(z), self.device)
        no_commit = (contextlib.nullcontext() if commit_state
                     else core.no_state_updates())
        with torch.set_grad_enabled(differentiable), no_commit:
            return self.generator(z, y=y, is_training=is_training)

    def discriminate(self, ts, images, labels=None):
        """(prediction, logits, features) of D in eval mode."""
        del ts
        images = torch.as_tensor(images, device=self.device)
        y = export_lib._one_hot(self._spec, labels, len(images), self.device)
        with torch.no_grad(), core.no_state_updates():
            return self.discriminator(images, y=y, is_training=False)


_IMAGE_KWARGS = ("train_images", "eval_images", "test_images")


def _gan_tasks(gan, eval_tasks):
    """The tasks that need G or D, checked before any eval work, and the
    image arguments that some task's `run_with_gan` accepts (a **kwargs
    signature accepts all of them)."""
    gan_tasks = [t for t in eval_tasks
                 if getattr(t, "run_with_gan", None) is not None]
    if gan_tasks and gan.conditional:
        raise ValueError(
            "The generator/discriminator-access tasks "
            f"({[type(t).__name__ for t in gan_tasks]}) are label-free and "
            "only support unconditional models. Remove them from "
            "eval_tasks.")
    accepted = set()
    for task in gan_tasks:
        validate = getattr(task, "validate_gan", None)
        if validate is not None:
            validate(gan)
        params = inspect.signature(task.run_with_gan).parameters
        accepted |= set(params)
        if any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values()):
            accepted |= set(_IMAGE_KWARGS)
    return gan_tasks, accepted & set(_IMAGE_KWARGS)


def _evaluate(gan, ts, eval_tasks, batch_size, num_averaging_runs,
              num_accu_examples, checkpoint_path, draw=None,
              cache: Optional[EvalCache] = None,
              log: Optional[PhaseLog] = None,
              export_accu_checkpoint=True) -> Dict[str, float]:
    """Fill, then (with tasks) sample, featurize and score. With a
    `checkpoint_path` and `export_accu_checkpoint`, the filled TrainState
    is saved to `<model_dir>/tfhub/<step>`."""
    np.random.seed(42)
    dataset = gan.dataset
    device = gan.device
    num_test_examples = dataset.eval_test_samples
    num_batches = int(np.ceil(num_test_examples / batch_size))
    draw = draw or (lambda s, i: eval_draws(gan, batch_size, s, i))
    cache = cache if cache is not None else EvalCache()
    log = log if log is not None else PhaseLog()
    gan_tasks, image_kwargs = _gan_tasks(gan, eval_tasks)
    session_tasks = [t for t in eval_tasks if t not in gan_tasks]
    keep_images = any(getattr(t, "reads_images", False)
                      for t in session_tasks)
    need_real_images = bool({"eval_images", "test_images"} & image_kwargs)

    with log.phase("fill", device):
        had_accus = _update_bn_accumulators(gan, ts, batch_size,
                                            num_accu_examples, draw)
    if had_accus and checkpoint_path is not None and export_accu_checkpoint:
        step = ckpt_lib.step_of(checkpoint_path)
        with log.phase("save_accu", device):
            ckpt_lib.save_checkpoint(
                os.path.join(gan.model_dir, "tfhub", str(step)), ts, step)

    if not eval_tasks:
        return {}

    sample = _make_sampler(gan, ts, draw)
    fake_dsets: List[eval_utils.EvalDataSample] = []
    for run in range(num_averaging_runs):
        with log.phase("sampling", device):
            fake_dset = eval_utils.EvalDataSample(
                eval_utils.sample_fake_dataset(
                    functools.partial(sample, run), num_batches,
                    batch_size))
        fake_dsets.append(fake_dset)
        with log.phase("inception_fake", device):
            fake_dset.set_data(*eval_utils.inception_transform_np(
                fake_dset.images, batch_size, device))
        fake_dset.set_num_examples(num_test_examples)
        if run != 0 and not keep_images:
            fake_dset.discard_images()  # Bound host memory.

    # The real split's features do not depend on the checkpoint: computed
    # once per cache. Its images stay only while a task wants them.
    real_key = (dataset.name, num_test_examples)
    real_dset = cache.real.get(real_key)
    if real_dset is None:
        with log.phase("inception_real", device):
            real_dset = eval_utils.EvalDataSample(
                dataset.load_eval_images(num_test_examples))
            real_dset.set_data(*eval_utils.inception_transform_np(
                real_dset.images, batch_size, device))
        real_dset.set_num_examples(num_test_examples)
        cache.real[real_key] = real_dset
    elif need_real_images and not len(real_dset.images):
        real_dset.images = dataset.load_eval_images(num_test_examples)
        real_dset.set_num_examples(num_test_examples)
    if not need_real_images:
        real_dset.discard_images()

    result_dict: Dict[str, float] = {}
    with log.phase("metrics", device):
        for task in session_tasks:
            # MS-SSIM and PRD run on the eval's device.
            accepted = utils.accepted_args(task.run_after_session)
            on_device = ({"device": device}
                         if accepted is None or "device" in accepted else {})
            with log.task(task, device):
                task_results = [task.run_after_session(fd, real_dset,
                                                       **on_device)
                                for fd in fake_dsets]
            for key in task_results[0]:
                scores = np.array([d[key] for d in task_results])
                result_dict[key + "_mean"] = float(np.mean(scores))
                result_dict[key + "_std"] = float(np.std(scores))
                result_dict[key + "_list"] = "_".join(str(x) for x in scores)
    if gan_tasks:
        # Once per checkpoint, not per averaging run: these tasks train
        # their own probes with their own seeds. train_images and
        # eval_images in [0, 1] (GILBO), test_images in [0, 255] (D
        # accuracy).
        images = {}
        if "train_images" in image_kwargs:
            images["train_images"] = dataset.load_eval_images(
                num_test_examples, split="train",
                failure_on_insufficient_examples=False) / 255.0
        if "eval_images" in image_kwargs:
            images["eval_images"] = real_dset.images / 255.0
        if "test_images" in image_kwargs:
            images["test_images"] = real_dset.images
        with log.phase("gan_tasks", device):
            for task in gan_tasks:
                with log.task(task, device):
                    out = utils.call_with_accepted_args(
                        task.run_with_gan, gan=gan, ts=ts,
                        batch_size=batch_size, **images)
                for key, value in out.items():
                    result_dict[key + "_mean"] = float(value)
                    result_dict[key + "_std"] = 0.0
                    result_dict[key + "_list"] = str(value)
    return result_dict
