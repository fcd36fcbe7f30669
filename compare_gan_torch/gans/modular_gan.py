"""ModularGAN: the GAN trainer (counterpart of
compare_gan_tpu/gans/modular_gan.py).

One train step is `disc_iters` D sub-steps and one G sub-step, each on its
own slice of a batch of `batch_size * (disc_iters + 1)`, then the EMA of G's
weights (gated on `step >= ema_start_step`). Which forward commits which
state follows the JAX trainer exactly:

* the D sub-step's G forward commits G's state, unless the fakes were
  precomputed by `experimental_joint_gen_for_disc` (one G forward over the
  concatenated draws of all D sub-steps, committing G's state once);
* the D sub-step's D forward commits D's state;
* the G sub-step commits both G's state and the SN `u` of its D forward;
* penalty forwards commit nothing (`core.no_state_updates`).

A penalty's draws ("alpha", "dragan_noise") come from the named stream of
their sub-step, or from the step's `draws` when a test hands them in. The G
sub-step reads only `g_loss`, so ModularGAN's computes no penalty there: the
JAX step computes one and drops it. SSGAN's `create_loss` takes no `g_step`
and computes it, as JAX does.

The port updates weights, optimizer moments, state buffers and the EMA in
place; `train_step` returns the same TrainState it was given. D's optimizer
steps D and its auxiliary heads (`DiscriminatorHeads`, built by subclasses
such as SSGAN and S3GAN), and the step's metrics carry a subclass's extra
losses as `loss/<key>`.

Mixed precision is explicit, as in `_cast_compute`: z and images are cast to
`compute_dtype`, the ops follow their input's type, and parameters,
optimizer moments, BN moments and losses stay f32. No autocast, so the f32
CPU path and the bf16 GPU path are one code path.

Data parallelism (`make_train_step(batch_size, replicas)`): each worker
takes its rows of every sub-step's global batch of `batch_size`
(`parallel.mesh_utils`), draws every sub-step's global z, sampled labels
and penalty draws from the same named streams as one process does and
keeps its rows, and runs the step inside `replica_context`, so batch norm
and the losses reduce over the global batch and each loss is its share of
the global one. The gradients are summed over the workers before each of
the `disc_iters` D updates and before the G update; spectral norm's power
iteration, the optimizers and the EMA then run alike on every worker, and
the step's metrics are the global values. The step equals the one-process
step at the same global batch, up to the order of the sums.

The spatial layout (`replicas.model_size` k > 1, counterpart of
`compile_train_step(spatial=True)` there): a data rank's rows go whole to
each of its k model ranks, each keeping its band of image height, and
the z, labels and draws whole. The architecture's layers exchange the
rows they read across bands; the losses are computed whole on every model
rank, each taking 1 / world of them (`tpu_ops.loss_shares`), and the
gradients are summed over the whole grid. Every architecture, GAN class,
penalty and normalization runs in it, at any k that divides the image
height: a map whose height does not split into k bands the next layer
can run on is held whole on every model rank (`parallel.tpu_ops`).

`sample` and `discriminate` are the inference surface (the reference's hub
"gen" and "disc" tags): G runs with its EMA shadows swapped in for its
weights, in the type of its z, committing no state unless asked (the BN
accumulator fill of eval_gan_lib commits).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch import utils
from compare_gan_torch.gans import loss_lib, optimizers, penalty_lib
from compare_gan_torch.gans.abstract_gan import AbstractGAN
from compare_gan_torch.ops import rng
from compare_gan_torch.parallel import mesh_utils, tpu_ops

Tensor = torch.Tensor


class DiscriminatorHeads(core.Module):
    """D's auxiliary heads (SSGAN, S3GAN), held beside D. Each child is
    named by its JAX scope (`discriminator_rotation`, ...), so its variables
    carry their JAX names with no prefix. The JAX package gives D every
    variable whose name starts with "discriminator" (abstract_arch.py:27-33):
    D's optimizer steps the heads."""
    name = ""

    def jax_variables(self):
        """({jax_name: parameter}, {jax_name: buffer})."""
        return core.named_variables(self, self.name)


@dataclasses.dataclass
class TrainState:
    """Everything that persists across train steps (and into checkpoints).
    `params()` and `state()` give the variables under their JAX names."""
    generator: torch.nn.Module
    discriminator: torch.nn.Module
    ema_params: Dict[str, Tensor]       # EMA shadows of G ({} if unused)
    g_opt: Any                          # the optimizers' states
    d_opt: Any
    step: int                           # G steps (tf global_step)
    disc_step: int                      # D sub-steps
    seed: int                           # base of the per-step draws
    heads: DiscriminatorHeads           # D's auxiliary heads (may be empty)

    def _variables(self, modules, which):
        return {k: v for m in modules
                for k, v in m.jax_variables()[which].items()}

    def params(self) -> Dict[str, Tensor]:
        return self._variables(
            (self.generator, self.discriminator, self.heads), 0)

    def state(self) -> Dict[str, Tensor]:
        return self._variables(
            (self.generator, self.discriminator, self.heads), 1)

    def d_params(self) -> Dict[str, Tensor]:
        """What D's optimizer steps: D's parameters and its heads'."""
        return self._variables((self.discriminator, self.heads), 0)


@gin.configurable("ModularGAN",
                  denylist=["dataset", "parameters", "model_dir", "device"])
class ModularGAN(AbstractGAN):
    """GAN with modular losses/penalties/architectures."""

    def __init__(self, dataset, parameters, model_dir, device="cpu",
                 deprecated_split_disc_calls=False,
                 experimental_joint_gen_for_disc=False,
                 experimental_force_graph_unroll=False,
                 g_use_ema=False, ema_decay=0.9999, ema_start_step=40000,
                 g_optimizer_fn=optimizers.adam_optimizer,
                 d_optimizer_fn=None,
                 g_lr=0.0002, d_lr=None,
                 conditional=False, fit_label_distribution=False,
                 compute_dtype=None,
                 experimental_fake_only_g_loss=False):
        super().__init__(dataset=dataset, parameters=parameters,
                         model_dir=model_dir)
        del experimental_force_graph_unroll  # Unrolled is the only way.
        self._device = torch.device(device)
        self._deprecated_split_disc_calls = deprecated_split_disc_calls
        self._experimental_joint_gen_for_disc = experimental_joint_gen_for_disc
        self._experimental_fake_only_g_loss = experimental_fake_only_g_loss
        if experimental_fake_only_g_loss and "g_step" not in \
                inspect.signature(self.create_loss).parameters:
            raise ValueError(
                f"{type(self).__name__}.create_loss does not support "
                "experimental_fake_only_g_loss (no g_step parameter).")
        self._g_use_ema = g_use_ema
        self._ema_decay = ema_decay
        self._ema_start_step = ema_start_step
        self._g_optimizer_fn = g_optimizer_fn
        self._d_optimizer_fn = d_optimizer_fn or g_optimizer_fn
        self._g_lr = g_lr
        self._d_lr = g_lr if d_lr is None else d_lr
        if conditional and not dataset.num_classes:
            raise ValueError(
                f"Option 'conditional' selected but dataset {dataset.name} "
                f"does not have labels.")
        self._conditional = conditional
        self._fit_label_distribution = fit_label_distribution
        self._compute_dtype = (getattr(torch, compute_dtype)
                               if isinstance(compute_dtype, str)
                               else compute_dtype)
        self._architecture = self._parameters["architecture"]
        self._z_dim = self._parameters["z_dim"]
        self._lambda = self._parameters["lambda"]
        self._disc_iters = self._parameters.get("disc_iters", 1)
        self._generator = None
        self._discriminator = None
        self._heads = None

    # -- properties --------------------------------------------------------

    @property
    def conditional(self):
        return self._conditional

    @property
    def num_sub_steps(self):
        return self._disc_iters + 1

    @property
    def z_dim(self):
        return self._z_dim

    @property
    def device(self):
        return self._device

    @property
    def generator(self):
        from compare_gan_torch.architectures import GENERATORS
        if self._generator is None:
            if self._architecture not in GENERATORS:
                raise NotImplementedError(
                    f"Generator architecture {self._architecture} is not "
                    f"ported.")
            self._generator = GENERATORS[self._architecture](
                image_shape=self._dataset.image_shape, z_dim=self._z_dim,
                num_classes=self._num_classes(), device=self._device)
        return self._generator

    @property
    def discriminator(self):
        from compare_gan_torch.architectures import DISCRIMINATORS
        if self._discriminator is None:
            if self._architecture not in DISCRIMINATORS:
                raise NotImplementedError(
                    f"Discriminator architecture {self._architecture} is "
                    f"not ported.")
            self._discriminator = DISCRIMINATORS[self._architecture](
                image_shape=self._dataset.image_shape,
                num_classes=self._num_classes(), device=self._device)
        return self._discriminator

    @property
    def heads(self) -> DiscriminatorHeads:
        """D's auxiliary heads, built by `make_heads` on first use."""
        if self._heads is None:
            self._heads = self.make_heads()
        return self._heads

    def make_heads(self) -> DiscriminatorHeads:
        """A subclass whose loss reads heads on D's features builds them
        here; ModularGAN's are empty (no variables)."""
        return DiscriminatorHeads()

    def _num_classes(self):
        return self._dataset.num_classes if self._conditional else None

    # -- samplers ----------------------------------------------------------

    @gin.configurable("z", denylist=["shape", "generator"])
    def z_generator(self, shape, generator, distribution_fn=rng.uniform,
                    minval=-1.0, maxval=1.0, stddev=1.0):
        """Noise sampler, gin key `z.distribution_fn`."""
        return utils.call_with_accepted_args(
            distribution_fn, shape=shape, generator=generator, minval=minval,
            maxval=maxval, stddev=stddev)

    def _get_one_hot_labels(self, labels):
        if not self.conditional:
            raise ValueError("_get_one_hot_labels() called but GAN is not "
                             "conditional.")
        if labels.dim() == 2:  # Soft labels pass through.
            return labels.float()
        # As jax.nn.one_hot: a label outside [0, num_classes), such as the
        # -1 of an unlabeled example, is an all-zero row.
        classes = torch.arange(self._dataset.num_classes,
                               device=labels.device)
        return (labels.long()[:, None] == classes).float()

    def _cast_compute(self, x):
        if self._compute_dtype is not None and x is not None and \
                x.is_floating_point():
            return x.to(self._compute_dtype)
        return x

    def draw_sub_step_inputs(self, batch_size, labels, seed, step, sub_step):
        """z and sampled labels of one sub-step from the named streams of
        (seed, step, sub_step)."""
        gen = rng.stream(seed, step, sub_step, "z", self._device)
        draws = {"z": self.z_generator([batch_size, self._z_dim], gen)}
        if self.conditional:
            if self._fit_label_distribution:
                draws["sampled_labels"] = labels
            else:
                gen = rng.stream(seed, step, sub_step, "sampled_labels",
                                 self._device)
                draws["sampled_labels"] = rng.randint(
                    [batch_size], 0, self._dataset.num_classes, gen)
        return draws

    def _to_device(self, x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))  # A writable host copy.
        return x.to(self._device)

    def _features(self, draws, seed, step, sub_step, replicas=None):
        """Sub-step features from draws (numpy arrays or tensors), with the
        sub-step's `penalty_draw(name, shape)`: uniform [0, 1) f32 draws
        from the named stream of (seed, step, sub_step), or `draws[name]`
        where the caller handed one in. Every draw is of the global batch;
        with `replicas`, the features hold this worker's rows of it, and
        `penalty_draw` takes this worker's shape and returns its rows of
        the global draw."""

        def mine(x):  # A data rank's rows, the same on its model ranks.
            return x if replicas is None else replicas.rows(x, x.shape[0])

        features = {"z": self._cast_compute(self._to_device(
            mine(draws["z"])))}
        if self.conditional:
            features["sampled_labels"] = self._to_device(
                mine(draws["sampled_labels"]))

        def penalty_draw(name, shape):
            data = 1 if replicas is None else replicas.data_size
            shape = (shape[0] * data,) + tuple(shape[1:])
            if name not in draws:
                return mine(rng.uniform(shape, rng.stream(
                    seed, step, sub_step, name, self._device)))
            value = self._to_device(draws[name]).float()
            if tuple(value.shape) != tuple(shape):
                raise ValueError(f"Draw {name} has shape "
                                 f"{tuple(value.shape)}, not {tuple(shape)}.")
            return mine(value)

        features["penalty_draw"] = penalty_draw
        return features

    # -- loss --------------------------------------------------------------

    def _penalty_loss(self, images, generated, y, is_training, draw):
        """Penalty term (modular_gan.py:241-255): its D forwards commit no
        state; `l2_penalty` reads D's trainable parameters by JAX name (D's
        and its heads', as D's optimizer steps them), gathered only for a
        penalty that reads them."""

        def d_logits_fn(xx):
            with core.no_state_updates():
                return self.discriminator(xx, y=y,
                                          is_training=is_training)[1]

        def d_params_fn():
            return {**self.discriminator.jax_variables()[0],
                    **self.heads.jax_variables()[0]}

        return penalty_lib.get_penalty_loss(
            x=images, x_fake=generated, y=y, is_training=is_training,
            d_logits_fn=d_logits_fn, d_params_fn=d_params_fn, draw=draw,
            device=self._device)

    def create_loss(self, features, labels, is_training=True, g_step=False):
        """D and G losses + lambda * penalty (modular_gan.py:256-330)."""
        images = features["images"]
        generated = features["generated"]
        if self.conditional:
            y = self._get_one_hot_labels(labels)
            sampled_y = self._get_one_hot_labels(features["sampled_labels"])
            all_y = torch.cat([y, sampled_y], dim=0)
        else:
            y = sampled_y = all_y = None

        if g_step and self._experimental_fake_only_g_loss:
            # D on the fakes only: exact for every loss_lib loss as long as
            # D does not normalize by the batch's moments (modular_gan.py
            # :100-113, :269-309).
            with core.collect_tags() as tags:
                d_fake, d_fake_logits, _ = self.discriminator(
                    generated, y=sampled_y, is_training=is_training)
            gen_prefix = self.generator.name + "/"
            if any(t.rsplit("/", 1)[-1] == "batch_coupled"
                   and not t.startswith(gen_prefix) for t in tags):
                raise ValueError(
                    "experimental_fake_only_g_loss requires a discriminator "
                    "without batch-coupled normalization: this D normalizes "
                    "by moments of the current batch, so the fake-only "
                    "batch changes its output.")
            _, _, _, g_loss = loss_lib.get_losses(
                d_real=d_fake.detach(), d_fake=d_fake,
                d_real_logits=d_fake_logits.detach(),
                d_fake_logits=d_fake_logits)
            zero = torch.zeros((), dtype=torch.float32, device=self._device)
            return {"d_loss": zero, "g_loss": g_loss, "penalty_loss": zero}

        if self._deprecated_split_disc_calls:
            d_real, d_real_logits, _ = self.discriminator(
                images, y=y, is_training=is_training)
            d_fake, d_fake_logits, _ = self.discriminator(
                generated, y=sampled_y, is_training=is_training)
        else:
            all_images = torch.cat([images, generated], dim=0)
            d_all, d_all_logits, _ = self.discriminator(
                all_images, y=all_y, is_training=is_training)
            d_real, d_fake = torch.chunk(d_all, 2)
            d_real_logits, d_fake_logits = torch.chunk(d_all_logits, 2)

        d_loss, _, _, g_loss = loss_lib.get_losses(
            d_real=d_real, d_fake=d_fake, d_real_logits=d_real_logits,
            d_fake_logits=d_fake_logits)
        if g_step:  # Nothing reads the G sub-step's d_loss.
            penalty_loss = torch.zeros((), dtype=torch.float32,
                                       device=self._device)
        else:
            penalty_loss = self._penalty_loss(
                images, generated, y, is_training,
                features.get("penalty_draw"))
        d_loss = d_loss + self._lambda * penalty_loss
        return {"d_loss": d_loss, "g_loss": g_loss,
                "penalty_loss": penalty_loss}

    # -- init --------------------------------------------------------------

    def init_state(self, seed) -> TrainState:
        """Build G, D and D's heads on the device and fill every variable
        from its own seeded stream (core.initialize)."""
        g, d, heads = self.generator, self.discriminator, self.heads
        for module, seed_name in ((g, "init/generator"),
                                  (d, "init/discriminator"),
                                  (heads, "init/discriminator_heads")):
            core.assign_scopes(module, module.name)
            core.initialize(module, module.name,
                            core.seed_for(seed, seed_name))
        g_params = g.jax_variables()[0]
        g_tx, d_tx = self._make_optimizers()
        ts = TrainState(
            generator=g, discriminator=d,
            ema_params=({k: v.detach().clone() for k, v in g_params.items()}
                        if self._g_use_ema else {}),
            g_opt=g_tx.init(g_params), d_opt=None,
            step=0, disc_step=0, seed=int(seed), heads=heads)
        ts.d_opt = d_tx.init(ts.d_params())
        return ts

    def _make_optimizers(self):
        return (self._g_optimizer_fn(self._g_lr),
                self._d_optimizer_fn(self._d_lr))

    # -- training ----------------------------------------------------------

    def _disc_sub_step(self, ts, images, labels, features, d_tx,
                       precomputed_fake=None, replicas=None):
        """One D training sub-step (modular_gan.py:386-420)."""
        if precomputed_fake is None:
            sampled_y = (self._get_one_hot_labels(features["sampled_labels"])
                         if self.conditional else None)
            with torch.no_grad():
                fake = self.generator(features["z"], y=sampled_y,
                                      is_training=True)
        else:
            fake = precomputed_fake
        features = dict(features, generated=fake.detach(),
                        images=self._cast_compute(images))
        losses = self.create_loss(features, labels, is_training=True)
        d_params = ts.d_params()
        # A head the loss does not read (SSGAN's rotation head with
        # self_supervision "none") gets a zero gradient, as under jax.grad.
        grads = torch.autograd.grad(losses["d_loss"], list(d_params.values()),
                                    materialize_grads=True)
        mesh_utils.sum_over_replicas(list(grads), replicas)
        d_tx.step(d_params, dict(zip(d_params, grads)), ts.d_opt)
        return losses

    def _gen_sub_step(self, ts, images, labels, features, g_tx,
                      replicas=None):
        """The G training sub-step + EMA (modular_gan.py:422-459)."""
        sampled_y = (self._get_one_hot_labels(features["sampled_labels"])
                     if self.conditional else None)
        features = dict(features, images=self._cast_compute(images))
        features["generated"] = self.generator(features["z"], y=sampled_y,
                                               is_training=True)
        losses = utils.call_with_accepted_args(
            self.create_loss, features=features, labels=labels,
            is_training=True, g_step=True)
        g_params = self.generator.jax_variables()[0]
        grads = torch.autograd.grad(losses["g_loss"], list(g_params.values()))
        mesh_utils.sum_over_replicas(list(grads), replicas)
        g_tx.step(g_params, dict(zip(g_params, grads)), ts.g_opt)
        if self._g_use_ema:
            # decay = ema_decay * (step >= start), in f32 as in JAX.
            decay = np.float32(self._ema_decay) * np.float32(
                ts.step >= self._ema_start_step)
            with torch.no_grad():
                names = list(ts.ema_params)
                ema = [ts.ema_params[k] for k in names]
                torch._foreach_mul_(ema, float(decay))
                torch._foreach_add_(ema, torch._foreach_mul(
                    [g_params[k].detach() for k in names],
                    float(np.float32(1) - decay)))
        return losses

    def make_train_step(self, batch_size, replicas=None):
        """`train_step(ts, batch, draws=None) -> (ts, metrics)`.
        `batch_size` is the global batch of a sub-step. `batch` holds
        images/labels of this host's share of the global step batch
        (batch_size * num_sub_steps rows over the hosts of `replicas`);
        `draws`, when given, is one {"z", "sampled_labels"} dict per
        sub-step of the global batch, which replaces the port's own draws
        (used by parity tests). With `replicas`, the step is this worker's
        part of the data-parallel step."""
        g_tx, d_tx = self._make_optimizers()
        num_sub_steps = self.num_sub_steps
        total = batch_size * num_sub_steps
        data = 1 if replicas is None else replicas.data_size
        if batch_size % data:
            raise ValueError(f"A sub-step batch of {batch_size} does not "
                             f"split over {data} data ranks.")

        def rows(x):
            return x if replicas is None else replicas.rows(x, batch_size)

        def band(x):
            return x if replicas is None else replicas.band(x)

        def train_step(ts: TrainState, batch,
                       draws: Optional[List[Dict]] = None):
            images, labels = batch["images"], batch["labels"]
            hosts = 1 if replicas is None else replicas.num_hosts
            if images.shape[0] * hosts != total:
                raise ValueError(f"Global batch {images.shape[0] * hosts} "
                                 f"!= {batch_size}*{num_sub_steps}")
            labels = self._to_device(labels)
            if hosts > 1:
                labels = replicas.gather_hosts(labels)
                images_s = [band(x) for x in torch.split(
                    replicas.exchange_blocks(self._to_device(images),
                                             batch_size), batch_size // data)]
            else:
                images_s = [self._to_device(band(rows(
                    images[i * batch_size:(i + 1) * batch_size])))
                    for i in range(num_sub_steps)]
            global_labels = torch.split(labels, batch_size)
            labels_s = [rows(x) for x in global_labels]
            if draws is None:
                draws = [self.draw_sub_step_inputs(
                    batch_size, global_labels[i], ts.seed, ts.step, i)
                    for i in range(num_sub_steps)]
            features = [self._features(d, ts.seed, ts.step, i, replicas)
                        for i, d in enumerate(draws)]
            with mesh_utils.replica_context(replicas):
                metrics = self._step(
                    ts, [tpu_ops.as_band(x) for x in images_s], labels_s,
                    features, g_tx, d_tx, replicas)
            if replicas is not None:  # Every worker's share, summed.
                names = sorted(metrics)
                stacked = torch.stack([metrics[k].float() for k in names])
                mesh_utils.sum_over_replicas([stacked], replicas)
                metrics = dict(zip(names, stacked))
            ts.step += 1
            ts.disc_step += self._disc_iters
            return ts, metrics

        return train_step

    def _step(self, ts, images_s, labels_s, features, g_tx, d_tx, replicas):
        """The sub-steps of one train step on this worker's rows; returns
        its metrics (its shares of them in a data-parallel step)."""
        metrics = {}
        fakes = [None] * self._disc_iters
        if self._experimental_joint_gen_for_disc:
            z = torch.cat([f["z"] for f in features[:-1]], dim=0)
            y = (self._get_one_hot_labels(torch.cat(
                [f["sampled_labels"] for f in features[:-1]], dim=0))
                if self.conditional else None)
            with torch.no_grad():
                joint = self.generator(z, y=y, is_training=True)
            fakes = list(torch.split(joint, images_s[0].shape[0]))

        for i in range(self._disc_iters):
            losses = self._disc_sub_step(
                ts, images_s[i], labels_s[i], features[i], d_tx,
                precomputed_fake=fakes[i], replicas=replicas)
            metrics[f"loss/d_{i}"] = losses["d_loss"].detach()
            if i == 0:
                metrics["loss/penalty"] = losses["penalty_loss"].detach()

        losses = self._gen_sub_step(ts, images_s[-1], labels_s[-1],
                                    features[-1], g_tx, replicas)
        metrics["loss/g"] = losses["g_loss"].detach()
        # A subclass's extra losses and rates (SSGAN, S3GAN), as the JAX
        # step passes them on (modular_gan.py:523-528).
        for k, v in losses.items():
            if k not in ("d_loss", "g_loss", "penalty_loss"):
                metrics[f"loss/{k}"] = v.detach()
        return metrics

    # -- inference (the reference's TF-Hub module surface) -----------------

    def _inference_params(self, ts: TrainState, use_ema=None
                          ) -> Dict[str, Tensor]:
        """Every parameter by JAX name, G's swapped for their EMA shadows
        when the GAN keeps an EMA (the custom_getter of modular_gan.py
        :266-284). State (SN u, BN accumulators) is not part of it."""
        use_ema = self._g_use_ema if use_ema is None else use_ema
        params = ts.params()
        if use_ema:
            if not ts.ema_params:
                # An explicit EMA request on a non-EMA checkpoint must not
                # silently evaluate raw weights as "EMA results".
                raise ValueError(
                    "use_ema=True but this TrainState has no EMA shadows "
                    "(trained with g_use_ema=False).")
            params.update(ts.ema_params)
        return params

    @contextlib.contextmanager
    def _inference_weights(self, ts: TrainState, use_ema=None):
        """G's parameters point at the inference params inside the block
        (a swap of storage, no copy) and at their own storage after it."""
        params = self._inference_params(ts, use_ema)
        saved = []
        try:
            for name, p in ts.generator.jax_variables()[0].items():
                if params[name] is not p:
                    saved.append((p, p.data))
                    p.data = params[name]
            yield
        finally:
            for p, data in saved:
                p.data = data

    def sample(self, ts: TrainState, z, labels=None, use_ema=None,
               is_training=False, commit_state=False, differentiable=False):
        """Images [B, H, W, C] in [0, 1] from z (and labels, for a
        conditional GAN) with the inference params (the hub "gen" tag,
        modular_gan.py:225-287). z runs in its own type: `compute_dtype`
        does not apply, as in the JAX package. The forward commits no state
        unless `commit_state` (the JAX function returns its new state,
        which its eval callers drop except when filling BN accumulators).
        With `differentiable`, the images carry their graph back to z."""
        z = self._to_device(z)
        y = (self._get_one_hot_labels(self._to_device(labels))
             if self.conditional else None)
        no_commit = (contextlib.nullcontext() if commit_state
                     else core.no_state_updates())
        with torch.set_grad_enabled(differentiable), no_commit, \
                self._inference_weights(ts, use_ema):
            return ts.generator(z, y=y, is_training=is_training)

    def discriminate(self, ts: TrainState, images, labels=None):
        """The hub "disc" tag: (prediction, logits, features) of D in eval
        mode with the raw params; commits no state."""
        images = self._to_device(images)
        y = (self._get_one_hot_labels(self._to_device(labels))
             if self.conditional else None)
        with torch.no_grad(), core.no_state_updates():
            return ts.discriminator(images, y=y, is_training=False)

    # -- input -------------------------------------------------------------

    def input_batches(self, batch_size, skip_batches=0):
        """Host iterator of numpy {images, labels}: this host's share,
        1 / num_hosts, of every global step batch of batch_size *
        num_sub_steps rows, from its own stream (seed + host_id), as the
        JAX package's per-host input (modular_gan.py:605-625 there). The
        hosts and this host's index are those of the process group
        (`mesh_utils.process_topology`): one host outside data
        parallelism."""
        num_hosts, host_id = mesh_utils.process_topology()
        total = batch_size * self.num_sub_steps
        if total % num_hosts:
            raise ValueError(
                f"Global per-step batch {total} (= {batch_size} x "
                f"{self.num_sub_steps} sub-steps) must divide over "
                f"{num_hosts} hosts.")
        return self._dataset.train_input_fn(
            total // num_hosts, host_id=host_id, skip_batches=skip_batches)
