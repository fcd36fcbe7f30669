"""Self-Supervised GAN (counterpart of compare_gan_tpu/gans/ssgan.py; Chen et
al., arXiv:1811.11212).

A 4-way rotation classifier on D's penultimate features
(`discriminator_rotation/score_classify`, with D's spectral-norm setting)
and rotation cross-entropies: weight 1.0 into D on real images, 0.2 into G
on fakes. `rotated_batch_size` counts the whole batch, as in the JAX
package.

The rotated examples are the last rows of the global batch (ssgan.py:69-90
there). In a data-parallel step they lie on the last worker or workers:
each worker rotates those of its rows that are among them (perhaps none),
so the workers' D batches differ in length, and the rotation losses are
each worker's share of the mean over the global rotated rows.
"""

from __future__ import annotations

import torch

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch import utils
from compare_gan_torch.gans import loss_lib, modular_gan
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import mesh_utils, tpu_ops

NUM_ROTATIONS = 4


def rotation_labels(num_rot, device):
    """[0]*num_rot + [1]*num_rot + ...: the rotation of each row that
    `utils.rotate_images(x, (0, 1, 2, 3))` returns."""
    return torch.arange(NUM_ROTATIONS, device=device).repeat_interleave(
        num_rot)


def rotation_loss(logits, labels, count=None):
    """-mean(sum(onehot * log(softmax(logits) + 1e-10))) in f32, the JAX
    package's form (not log_softmax); the mean over `count` rows of the
    global batch (`tpu_ops.batch_mean`)."""
    probs = torch.softmax(logits.float(), dim=-1)
    log_p = torch.log(probs + 1e-10)
    return -tpu_ops.batch_mean(log_p.gather(1, labels[:, None]), count)


def local_rotated_rows(num_rot, bs):
    """(start, n): of the last `num_rot` rows of the global batch, this
    worker holds rows [start, bs) of its `bs`, n = bs - start of them."""
    replicas = mesh_utils.active()
    rank, world = (0, 1) if replicas is None else (replicas.rank,
                                                   replicas.world)
    start = min(max(bs * world - num_rot - rank * bs, 0), bs)
    return start, bs - start


def global_rows(bs):
    """The rows of the global batch of which this worker holds `bs`."""
    replicas = mesh_utils.active()
    return bs if replicas is None else bs * replicas.world


def rotation_head(feature_dim, use_sn, device):
    """The `discriminator_rotation` scope: one linear layer to 4 logits."""
    scope = core.Module()
    scope.score_classify = ops.Linear(feature_dim, NUM_ROTATIONS,
                                      use_sn=use_sn, device=device)
    return scope


@gin.configurable("SSGAN",
                  denylist=["dataset", "parameters", "model_dir", "device"])
class SSGAN(modular_gan.ModularGAN):
    """Self-Supervised GAN (ssgan.py:28-140)."""
    SPATIAL = False

    def __init__(self, self_supervision="rotation_gan",
                 rotated_batch_size=None, weight_rotation_loss_d=1.0,
                 weight_rotation_loss_g=0.2, **kwargs):
        super().__init__(**kwargs)
        if rotated_batch_size is None:
            raise gin.ConfigError("SSGAN.rotated_batch_size is required.")
        self._self_supervision = self_supervision
        self._rotated_batch_size = rotated_batch_size
        self._weight_rotation_loss_d = weight_rotation_loss_d
        self._weight_rotation_loss_g = weight_rotation_loss_g
        if self._deprecated_split_disc_calls:
            raise ValueError(
                "Splitting discriminator calls is not supported in SSGAN.")

    def make_heads(self):
        # The head exists in every mode, as in the JAX package: with
        # self_supervision "none" its logits go unused.
        heads = modular_gan.DiscriminatorHeads()
        heads.discriminator_rotation = rotation_head(
            self.discriminator.feature_dim,
            self.discriminator._spectral_norm, self._device)
        return heads

    def discriminator_with_rotation_head(self, x, y, is_training):
        """(probs, logits, rotation logits) of D and the rotation head
        (ssgan.py:46-56)."""
        real_probs, real_scores, final = self.discriminator(
            x, y=y, is_training=is_training)
        rotation_scores = self.heads.discriminator_rotation.score_classify(
            final.reshape(x.shape[0], -1))
        return real_probs, real_scores, rotation_scores

    def create_loss(self, features, labels, is_training=True):
        """GAN loss + rotation self-supervision (ssgan.py:58-140)."""
        images = features["images"]
        generated = features["generated"]
        y = sampled_y = all_y = None
        if self.conditional:
            y = self._get_one_hot_labels(labels)
            sampled_y = self._get_one_hot_labels(features["sampled_labels"])

        bs = images.shape[0]
        rotated_bs = self._rotated_batch_size
        if rotated_bs % NUM_ROTATIONS:
            raise ValueError(f"rotated_batch_size {rotated_bs} is not a "
                             f"multiple of {NUM_ROTATIONS}.")
        num_rot = rotated_bs // NUM_ROTATIONS
        rotation = "rotation" in self._self_supervision

        if rotation:
            if num_rot > global_rows(bs):
                raise ValueError(f"{num_rot} rotated examples per rotation "
                                 f"but a batch of {global_rows(bs)}.")
            start, n_rot = local_rotated_rows(num_rot, bs)
            images_rotated = utils.rotate_images(images[start:],
                                                 rot90_scalars=(1, 2, 3))
            generated_rotated = utils.rotate_images(generated[start:],
                                                    rot90_scalars=(1, 2, 3))
            rotate_labels = rotation_labels(n_rot, images.device)
            all_images = torch.cat(
                [images, images_rotated, generated, generated_rotated], 0)
            if self.conditional:
                y_rotated = y[start:].repeat(3, 1)
                # The fakes' rotated labels are tiled from the REAL y, not
                # from sampled_y: a quirk of the reference (ssgan.py:88)
                # that the JAX package keeps, and so does the port.
                sampled_y_rotated = y[start:].repeat(3, 1)
                all_y = torch.cat([y, y_rotated, sampled_y,
                                   sampled_y_rotated], 0)
        else:
            all_images = torch.cat([images, generated], 0)
            if self.conditional:
                all_y = torch.cat([y, sampled_y], 0)

        d_all, d_all_logits, c_all_logits = (
            self.discriminator_with_rotation_head(
                all_images, y=all_y, is_training=is_training))
        d_real, d_fake = torch.chunk(d_all, 2)
        d_real_logits, d_fake_logits = torch.chunk(d_all_logits, 2)
        c_real_logits, c_fake_logits = torch.chunk(c_all_logits, 2)

        # The GAN loss reads the un-rotated rows only.
        d_loss, _, _, g_loss = loss_lib.get_losses(
            d_real=d_real[:bs], d_fake=d_fake[:bs],
            d_real_logits=d_real_logits[:bs],
            d_fake_logits=d_fake_logits[:bs])
        penalty_loss = self._penalty_loss(images, generated, y, is_training,
                                          features.get("penalty_draw"))
        d_loss = d_loss + self._lambda * penalty_loss

        if rotation:
            # The last 4 * n_rot rows: the un-rotated originals of the
            # rotated examples and their three rotations.
            c_real_logits = c_real_logits[c_real_logits.shape[0] - 4 * n_rot:]
            c_fake_logits = c_fake_logits[c_fake_logits.shape[0] - 4 * n_rot:]
            accuracy = tpu_ops.batch_mean(
                (c_real_logits.argmax(-1) == rotate_labels).float(),
                rotated_bs)
            c_real_loss = rotation_loss(c_real_logits, rotate_labels,
                                        rotated_bs)
            c_fake_loss = rotation_loss(c_fake_logits, rotate_labels,
                                        rotated_bs)
            if self._self_supervision == "rotation_only":
                d_loss = d_loss * 0.0
                g_loss = g_loss * 0.0
            d_loss = d_loss + c_real_loss * self._weight_rotation_loss_d
            g_loss = g_loss + c_fake_loss * self._weight_rotation_loss_g
        else:
            c_real_loss = c_fake_loss = accuracy = torch.zeros(
                (), dtype=torch.float32, device=images.device)

        return {"d_loss": d_loss, "g_loss": g_loss,
                "penalty_loss": penalty_loss,
                "c_real_loss": c_real_loss, "c_fake_loss": c_fake_loss,
                "rotation_accuracy": accuracy}
