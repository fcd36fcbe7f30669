"""S3GAN: a semi-supervised GAN with auxiliary heads on D (counterpart of
compare_gan_tpu/gans/s3gan.py; "High-Fidelity Image Generation With Fewer
Labels", Lucic et al. 2019, arXiv:1903.02271).

D gains up to three heads on its features: a rotation classifier (SSGAN's
mechanism, `discriminator_rotation`), a label predictor that imputes labels
for unlabeled examples (`discriminator_predictor`, soft or hard) and a
projection <embed(y), h> with the imputed-or-real labels
(`discriminator_projection`, glorot-normal init). An example counts as
labeled when its label row sums to more than 0.5. S3GAN applies no penalty.

As in SSGAN, the rotated examples are the last rows of the global batch
(turned whole and cut into bands in the spatial layout), and in a
data-parallel step the losses are each worker's share: the class loss
divides its worker's sum by the labeled rows of every worker (in the
spatial layout each data rank's counted on each of its model ranks, so
that the model ranks' shares sum to their data rank's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch.gans import loss_lib, modular_gan, ssgan
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.parallel import tpu_ops

NUM_ROTATIONS = ssgan.NUM_ROTATIONS


@gin.configurable("S3GAN",
                  denylist=["dataset", "parameters", "model_dir", "device"])
class S3GAN(modular_gan.ModularGAN):
    """S3GAN (s3gan.py:28-238)."""

    def __init__(self, self_supervision="rotation",
                 rotated_batch_fraction=None, weight_rotation_loss_d=1.0,
                 weight_rotation_loss_g=0.2, project_y=False,
                 use_predictor=False, use_soft_pred=False,
                 weight_class_loss=1.0, use_soft_labels=False, **kwargs):
        super().__init__(**kwargs)
        if rotated_batch_fraction is None:
            raise gin.ConfigError(
                "S3GAN.rotated_batch_fraction is required.")
        if use_predictor and not project_y:
            raise ValueError("Using predictor requires projection.")
        if self_supervision not in ("none", "rotation"):
            raise ValueError(f"Unknown self_supervision {self_supervision!r}"
                             f" (none, rotation).")
        if project_y and not self.conditional:
            raise ValueError("project_y needs a conditional GAN.")
        self._self_supervision = self_supervision
        self._rotated_batch_fraction = rotated_batch_fraction
        self._weight_rotation_loss_d = weight_rotation_loss_d
        self._weight_rotation_loss_g = weight_rotation_loss_g
        self._project_y = project_y
        self._use_predictor = use_predictor
        self._use_soft_pred = use_soft_pred
        self._weight_class_loss = weight_class_loss
        self._use_soft_labels = use_soft_labels
        if self._deprecated_split_disc_calls:
            raise ValueError(
                "Splitting discriminator calls is not supported in S3GAN.")

    # -- heads -------------------------------------------------------------

    def make_heads(self):
        """The heads the options ask for, under their JAX scopes."""
        heads = modular_gan.DiscriminatorHeads()
        features = self.discriminator.feature_dim
        use_sn = self.discriminator._spectral_norm
        if self._self_supervision == "rotation":
            heads.discriminator_rotation = ssgan.rotation_head(
                features, use_sn, self._device)
        if self._project_y:
            num_classes = self._dataset.num_classes
            if self._use_predictor:
                scope = core.Module()
                scope.predictor_linear = ops.Linear(
                    features, num_classes, use_sn=use_sn, device=self._device)
                heads.discriminator_predictor = scope
            heads.discriminator_projection = ops.SpectralNormKernel(
                (num_classes, features), ops.glorot_normal_init(), use_sn,
                device=self._device)
        return heads

    def discriminator_with_additional_heads(self, x, y, is_training):
        """(d_probs, d_logits, rotation_logits, aux_logits,
        is_label_available) of D and its heads (s3gan.py:68-113)."""
        d_probs, d_logits, x_rep = self.discriminator(
            x, y=y, is_training=is_training)
        if x_rep.dim() != 2:
            raise ValueError(f"D's features must be rank 2, got "
                             f"{tuple(x_rep.shape)}.")
        if y is not None:
            is_label_available = (y.sum(dim=1, keepdim=True) > 0.5).float()
        else:
            is_label_available = torch.zeros((x.shape[0], 1),
                                             device=x.device)
        heads = self.heads
        rotation_logits = None
        if self._self_supervision == "rotation":
            rotation_logits = heads.discriminator_rotation.score_classify(
                x_rep)
        if not self._project_y:
            return (d_probs, d_logits, rotation_logits, None,
                    is_label_available)

        aux_logits = None
        if self._use_predictor:
            aux_logits = heads.discriminator_predictor.predictor_linear(x_rep)
            if self._use_soft_pred:
                y_predicted = torch.softmax(aux_logits, dim=1)
            else:
                y_predicted = F.one_hot(aux_logits.argmax(1),
                                        aux_logits.shape[1]).float()
            y = ((1.0 - is_label_available) * y_predicted
                 + is_label_available * y).detach()
        class_embedding = y @ heads.discriminator_projection().to(y.dtype)
        # A bf16 logit becomes f32 here, as in JAX.
        d_logits = d_logits + (class_embedding * x_rep).sum(dim=1,
                                                            keepdim=True)
        return (torch.sigmoid(d_logits), d_logits, rotation_logits,
                aux_logits, is_label_available)

    def merge_with_rotation_data(self, real, fake, real_labels, fake_labels,
                                 num_rot_examples):
        """The [real, real-rot, fake, fake-rot] batch (s3gan.py:115-133),
        rotating the last `num_rot_examples` rows (perhaps none)."""
        start = real.shape[0] - num_rot_examples
        real_rotated = tpu_ops.rotate_bands(real[start:],
                                            rot90_scalars=(1, 2, 3))
        fake_rotated = tpu_ops.rotate_bands(fake[start:],
                                            rot90_scalars=(1, 2, 3))
        all_features = torch.cat([real, real_rotated, fake, fake_rotated], 0)
        all_labels = None
        if self.conditional:
            all_labels = torch.cat(
                [real_labels, real_labels[start:].repeat(3, 1),
                 fake_labels, fake_labels[start:].repeat(3, 1)], 0)
        return all_features, all_labels

    # -- loss --------------------------------------------------------------

    def create_loss(self, features, labels, is_training=True):
        """GAN + rotation + predictor losses (s3gan.py:137-238)."""
        real_images = features["images"]
        fake_images = features["generated"]
        real_labels = fake_labels = None
        if self.conditional:
            if self._use_soft_labels:
                num_classes = self._dataset.num_classes
                if labels.dim() != 2 or labels.shape[1] != num_classes:
                    raise ValueError(
                        f"Need soft labels of dimension {num_classes} but "
                        f"got labels of shape {tuple(labels.shape)}")
                real_labels = labels.float()
            else:
                real_labels = self._get_one_hot_labels(labels)
            fake_labels = self._get_one_hot_labels(
                features["sampled_labels"])

        bs = real_images.shape[0]
        global_bs = ssgan.global_rows(bs)
        rotation = self._self_supervision == "rotation"
        if rotation:
            if global_bs % self._rotated_batch_fraction:
                raise ValueError(
                    f"Rotated batch fraction is invalid: "
                    f"{self._rotated_batch_fraction} doesn't divide "
                    f"{global_bs}")
            rotated_bs = global_bs // self._rotated_batch_fraction
            num_rot_examples = rotated_bs // NUM_ROTATIONS
            if num_rot_examples <= 0:
                raise ValueError(f"A batch of {global_bs} leaves no rotated "
                                 f"example at rotated_batch_fraction "
                                 f"{self._rotated_batch_fraction}.")
            _, n_rot = ssgan.local_rotated_rows(num_rot_examples, bs)
            all_features, all_labels = self.merge_with_rotation_data(
                real_images, fake_images, real_labels, fake_labels, n_rot)
        else:
            all_features = torch.cat([real_images, fake_images], 0)
            all_labels = (torch.cat([real_labels, fake_labels], 0)
                          if self.conditional else None)

        (d_predictions, d_logits, rot_logits, aux_logits,
         is_label_available) = self.discriminator_with_additional_heads(
            all_features, y=all_labels, is_training=is_training)

        expected_batch_size = 2 * bs
        if rotation:
            expected_batch_size += 2 * (NUM_ROTATIONS - 1) * n_rot
        if d_logits.shape[0] != expected_batch_size:
            raise ValueError(f"Batch size unexpected: got {d_logits.shape[0]}"
                             f" expected {expected_batch_size}")

        prob_real, prob_fake = torch.chunk(d_predictions, 2)
        logits_real, logits_fake = torch.chunk(d_logits, 2)
        d_loss, _, _, g_loss = loss_lib.get_losses(
            d_real=prob_real[:bs], d_fake=prob_fake[:bs],
            d_real_logits=logits_real[:bs], d_fake_logits=logits_fake[:bs])

        # No penalty: the reference's S3GAN.create_loss applies none.
        metrics = {"penalty_loss": torch.zeros((), dtype=torch.float32,
                                               device=real_images.device)}
        if rotation:
            rot_real_logits, rot_fake_logits = torch.chunk(rot_logits, 2)
            first = rot_real_logits.shape[0] - NUM_ROTATIONS * n_rot
            rot_real_logits = rot_real_logits[first:]
            rot_fake_logits = rot_fake_logits[first:]
            labels_rotated = ssgan.rotation_labels(n_rot, real_images.device)
            real_loss = ssgan.rotation_loss(rot_real_logits, labels_rotated,
                                            rotated_bs)
            fake_loss = ssgan.rotation_loss(rot_fake_logits, labels_rotated,
                                            rotated_bs)
            d_loss = d_loss + real_loss * self._weight_rotation_loss_d
            g_loss = g_loss + fake_loss * self._weight_rotation_loss_g
            metrics["rotation_real_loss"] = real_loss
            metrics["rotation_fake_loss"] = fake_loss
            metrics["rotation_accuracy_real"] = tpu_ops.batch_mean(
                (rot_real_logits.argmax(1) == labels_rotated).float(),
                rotated_bs)

        if self._use_predictor:
            real_aux_logits = torch.chunk(aux_logits, 2)[0][:bs]
            avail = torch.chunk(is_label_available, 2)[0][:bs, 0]
            # Softmax CE over the labeled rows only: sum(w * ce) / sum(w).
            log_p = F.log_softmax(real_aux_logits.float(), dim=1)
            ce = -(real_labels * log_p).sum(dim=1)
            class_loss_real = (avail * ce).sum() / torch.clamp(
                tpu_ops.batch_sum(avail), min=1e-8)
            d_loss = d_loss + self._weight_class_loss * class_loss_real
            metrics["class_loss_real"] = class_loss_real
            metrics["label_frac"] = tpu_ops.batch_mean(avail)

        return {"d_loss": d_loss, "g_loss": g_loss, **metrics}
