"""Discriminator accuracy (counterpart of
compare_gan_tpu/metrics/accuracy.py): D's accuracy and loss on train
images, test images and fresh fakes. D runs in eval mode through
`gan.discriminate`; the binary cross-entropy is f64 on the host."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from compare_gan_torch import core
from compare_gan_torch.metrics import eval_task


class AccuracyTask(eval_task.EvalTask):
    """Accuracy and loss of D (accuracy.py:36-48)."""

    def metric_list(self):
        return frozenset(["train_accuracy", "test_accuracy", "fake_accuracy",
                          "train_d_loss", "test_d_loss"])

    def run_after_session(self, fake_dset, real_dset=None):
        raise NotImplementedError(
            "AccuracyTask needs discriminator access; call "
            "run_with_gan(gan, ts, test_images).")

    def run_with_gan(self, gan, ts, test_images, max_train_examples=50000,
                     num_repeat=5, batch_size=64, seed=0,
                     draw: Optional[Callable] = None):
        """D's accuracy and loss on train, test and fake images
        (accuracy.py:51-145). `test_images` are [N, H, W, C] in [0, 255];
        a prediction >= 0.5 on a real image and < 0.5 on a fake counts as
        correct. Each (repeat, batch) draws its own z from the GAN's prior
        (`z` gin scope); `draw(repeat, batch) -> z` replaces the draw
        (tests)."""
        train_images = gan.dataset.load_eval_images(
            min(max_train_examples, 10 * len(test_images)), split="train",
            failure_on_insufficient_examples=False)
        if train_images.shape[0] < test_images.shape[0]:
            raise ValueError(
                f"num_train {train_images.shape[0]} must be larger than "
                f"num_test {test_images.shape[0]}.")

        def d_fn(images):
            if not isinstance(images, torch.Tensor):
                images = torch.from_numpy(np.asarray(images, np.float32))
            return gan.discriminate(ts, images)[0].float().cpu().numpy()

        def default_draw(rep, i):
            gen = torch.Generator(device=gan.device)
            gen.manual_seed(core.seed_for(seed, f"accuracy/{rep}/{i}"))
            return gan.z_generator([batch_size, gan.z_dim], gen)

        draw = draw or default_draw

        def bce(pred, label):
            p = np.clip(np.asarray(pred, np.float64), 1e-7, 1 - 1e-7)
            return -(label * np.log(p) + (1 - label) * np.log(1 - p))

        rng = np.random.default_rng(seed)
        num_batches = len(test_images) // batch_size
        ret = {k: [] for k in self.metric_list()}
        for rep in range(num_repeat):
            idx = rng.choice(len(train_images), len(test_images))
            train_subset = train_images[idx]
            accs = {"train": [], "test": [], "fake": []}
            losses = {"train": [], "test": []}
            for i in range(num_batches):
                sl = slice(i * batch_size, (i + 1) * batch_size)
                test_p = d_fn(test_images[sl] / 255.0)
                train_p = d_fn(train_subset[sl] / 255.0)
                fake_p = d_fn(gan.sample(ts, draw(rep, i)))
                accs["test"].append((test_p >= 0.5).mean())
                accs["train"].append((train_p >= 0.5).mean())
                accs["fake"].append((fake_p < 0.5).mean())
                losses["test"].append(bce(test_p, 1.0).mean())
                losses["train"].append(bce(train_p, 1.0).mean())
            ret["train_accuracy"].append(np.mean(accs["train"]))
            ret["test_accuracy"].append(np.mean(accs["test"]))
            ret["fake_accuracy"].append(np.mean(accs["fake"]))
            ret["train_d_loss"].append(np.mean(losses["train"]))
            ret["test_d_loss"].append(np.mean(losses["test"]))
        return {k: float(np.mean(v)) for k, v in ret.items()}
