"""GILBO, the generative information lower bound (counterpart of
compare_gan_tpu/metrics/gilbo.py; arXiv:1802.04874).

A regressor E(x) -> Beta posterior over each z coordinate is trained
against the frozen generator to lower-bound I(z; G(z)):

    GILBO = E_{z, x = G(z)} [log q(z | x) - log p(z)]

with z ~ U(-1, 1)^d, so log p(z) = -d log 2. The regressor (conv 64 and
128, 4x4 stride 2, lrelu, fc 1024, fc 2d; a, b = 1 + softplus(. - 5))
keeps the JAX scope names (`conv1/kernel`, ...), and trains with the
port's Adam (held to optax). Training is a fixed number of steps or the
reference's cycle protocol with learning-rate decay. The consistency
metrics encode images, draw z from the posterior (Beta draws from a seeded
stream), regenerate, re-encode and report the symmetric KL between the two
posteriors.

Every z, image and Beta draw comes from a generator seeded by (seed,
stream, index). With `outdir`, the regressor is checkpointed there as
`gilbo_model-<generator fingerprint>-<cycle>.p`: a run resumes only from
files of the generator it evaluates, and a shared outdir serves several
checkpoints' evaluations, each resumable.
"""

from __future__ import annotations

import glob
import hashlib
import logging
import os
import pickle
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from compare_gan_torch import config as gin
from compare_gan_torch import core
from compare_gan_torch import interop
from compare_gan_torch import utils
from compare_gan_torch.gans import optimizers
from compare_gan_torch.metrics import eval_task
from compare_gan_torch.ops import arch_ops as ops
from compare_gan_torch.ops import rng as rng_ops

logger = logging.getLogger(__name__)


class Regressor(core.Module):
    """Beta(a, b) parameters per z coordinate from an image
    (gilbo.py:101-119 of the reference), variables under no prefix."""

    name = ""

    def __init__(self, image_shape, z_dim, device=None):
        super().__init__()
        h, w, colors = image_shape
        self.z_dim = z_dim
        self.conv1 = ops.Conv2d(colors, 64, 4, 4, 2, 2, device=device)
        self.conv2 = ops.Conv2d(64, 128, 4, 4, 2, 2, device=device)
        # Two SAME convs of stride 2: ceil(ceil(size / 2) / 2).
        flat = -(-h // 4) * -(-w // 4) * 128
        self.fc1 = ops.Linear(flat, 1024, device=device)
        self.fc2 = ops.Linear(1024, 2 * z_dim, device=device)

    def forward(self, x):
        net = ops.lrelu(self.conv1(x))
        net = ops.lrelu(self.conv2(net))
        net = ops.lrelu(self.fc1(net.reshape(net.shape[0], -1)))
        net = self.fc2(net)
        a = 1.0 + F.softplus(net[:, :self.z_dim] - 5.0)
        b = 1.0 + F.softplus(net[:, self.z_dim:] - 5.0)
        return a, b

    def jax_variables(self):
        return core.named_variables(self, self.name)


def _beta_log_prob(a, b, u):
    """log Beta(a, b) density at u in (0, 1)."""
    log_norm = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
    return (a - 1.0) * torch.log(u) + (b - 1.0) * torch.log1p(-u) - log_norm


def _log_qz(a, b, z, eps=1e-6):
    """log q(z | x) for z in (-1, 1): the Beta density of u = (z + 1) / 2,
    whose Jacobian adds -log 2 per coordinate."""
    u = torch.clamp((z + 1.0) / 2.0, eps, 1.0 - eps)
    return torch.sum(_beta_log_prob(a, b, u) - np.log(2.0), dim=-1)


def _beta_kl(a1, b1, a2, b2):
    """Elementwise KL(Beta(a1, b1) || Beta(a2, b2)); the shared affine map
    to z leaves it unchanged (gilbo.py:470-480)."""
    def log_beta_fn(a, b):
        return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)

    return (log_beta_fn(a2, b2) - log_beta_fn(a1, b1)
            + (a1 - a2) * torch.digamma(a1) + (b1 - b2) * torch.digamma(b1)
            + (a2 - a1 + b2 - b1) * torch.digamma(a1 + b1))


def _generator(seed, stream, index, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(core.seed_for(seed, f"gilbo/{stream}/{index}"))
    return gen


class _Gilbo:
    """The regressor, its Adam, and the draws of one GILBO computation.
    `draw(stream, index) -> z` replaces the uniform z draws (tests)."""

    def __init__(self, gan, ts, batch_size, learning_rate, seed,
                 draw: Optional[Callable] = None):
        self.gan, self.ts = gan, ts
        self.device = gan.device
        self.z_dim = gan.z_dim
        self.batch_size = batch_size
        self.seed = seed
        self._draw = draw
        self.log_pz = -self.z_dim * np.log(2.0)
        _, self.x0 = self.gen("init", 0)
        # A fixed-draw sample is a function of G's weights: it names the
        # regressor's checkpoint files.
        self.fingerprint = hashlib.sha256(
            self.x0.float().cpu().numpy().tobytes()).hexdigest()[:16]
        self.regressor = Regressor(tuple(self.x0.shape[1:]), self.z_dim,
                                   device=self.device)
        self.tx = optimizers.Adam(learning_rate)
        self.reset()

    def reset(self):
        core.initialize(self.regressor, "",
                        core.seed_for(self.seed, "gilbo/regressor"))
        self.params = self.regressor.jax_variables()[0]
        self.opt_state = self.tx.init(self.params)

    def z(self, stream, index, n=None):
        if self._draw is not None:
            return torch.as_tensor(np.array(self._draw(stream, index)),
                                   device=self.device)
        gen = _generator(self.seed, stream, index, self.device)
        return rng_ops.uniform([n or self.batch_size, self.z_dim], gen,
                               minval=-1.0, maxval=1.0)

    def gen(self, stream, index):
        z = self.z(stream, index)
        return z, self.gan.sample(self.ts, z).float()

    def train_step(self, index):
        z, x = self.gen("train", index)
        with torch.enable_grad():
            a, b = self.regressor(x)
            loss = -torch.mean(_log_qz(a, b, z))
            grads = torch.autograd.grad(loss, list(self.params.values()))
        self.tx.step(self.params, dict(zip(self.params, grads)),
                     self.opt_state)
        return loss.detach()

    def gilbo_batch(self, index):
        z, x = self.gen("eval", index)
        with torch.no_grad():
            a, b = self.regressor(x)
            return torch.mean(_log_qz(a, b, z)) - self.log_pz, a, b, x

    @torch.no_grad()
    def consistency_batch(self, x, stream, index):
        """Encode x, draw z1 from that posterior, regenerate x2 = G(z1),
        re-encode: the per-example forward and reverse KLs between the two
        posteriors, x2 and the posteriors (gilbo.py:377-480)."""
        a1, b1 = self.regressor(x)
        devices = [self.device] if self.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(core.seed_for(self.seed,
                                            f"gilbo/{stream}/{index}"))
            u = torch.distributions.Beta(a1, b1).sample()
        z1 = 2.0 * torch.clamp(u, 1e-6, 1.0 - 1e-6) - 1.0
        x2 = self.gan.sample(self.ts, z1.float()).float()
        a2, b2 = self.regressor(x2)
        kl = torch.sum(_beta_kl(a1, b1, a2, b2), dim=-1)
        rkl = torch.sum(_beta_kl(a2, b2, a1, b1), dim=-1)
        return kl, rkl, x2, (a1, b1, a2, b2)

    # -- regressor checkpoints ----------------------------------------------

    def save(self, outdir, tag, meta):
        path = os.path.join(outdir, "gilbo_model-%s-%05d.p"
                            % (self.fingerprint, tag))
        payload = dict(
            params={k: interop.to_jax(v) for k, v in self.params.items()},
            opt_state=dict(count=self.opt_state.count, **{
                m: {k: interop.to_jax(v) for k, v in
                    getattr(self.opt_state, m).items()}
                for m in ("mu", "nu")}),
            meta=meta)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)

    def load_latest(self, outdir):
        """The meta of the newest checkpoint of this generator whose
        variables match the regressor's, loaded into it; else None."""
        paths = glob.glob(os.path.join(
            outdir, "gilbo_model-%s-*.p" % self.fingerprint))
        if not paths:
            return None
        path = max(paths, key=lambda p: int(
            os.path.basename(p).rsplit("-", 1)[1].split(".")[0]))
        with open(path, "rb") as f:
            payload = pickle.load(f)
        params = payload["params"]
        if set(params) != set(self.params) or any(
                tuple(np.shape(params[k])) != tuple(interop.to_jax(v).shape)
                for k, v in self.params.items()):
            logger.warning("Ignoring incompatible GILBO checkpoint %s.", path)
            return None
        logger.info("Resuming GILBO regressor from %s.", path)
        with torch.no_grad():
            for k, v in self.params.items():
                v.copy_(interop.to_port(params[k]))
            opt = payload["opt_state"]
            self.opt_state.count = int(opt["count"])
            for m in ("mu", "nu"):
                for k, v in getattr(self.opt_state, m).items():
                    v.copy_(interop.to_port(opt[m][k]))
        return payload["meta"]


def train_gilbo(gan, ts, train_images=None, eval_images=None,
                batch_size=64, train_steps=2000, eval_batches=64,
                learning_rate=4e-4, seed=0, options=None, outdir=None,
                draw: Optional[Callable] = None):
    """Train the regressor against the frozen generator; returns (gilbo,
    train_consistency, eval_consistency, self_consistency): GILBO in nats,
    the consistencies as symmetric Beta-posterior KLs (lower: more
    consistent; gilbo.py:200-213,470-480). Images are [N, H, W, C] in
    [0, 1].

    With `options=None` the regressor trains `train_steps` steps at a fixed
    learning rate. An options dict selects the reference's protocol
    (gilbo.py:216-266), with its option names and defaults: up to
    `gilbo_max_train_cycles` cycles of `gilbo_train_steps_per_cycle`
    steps; after a cycle whose mean GILBO misses the required improvement
    the learning rate is scaled by `gilbo_lr_scale`, and training stops
    once it is below `gilbo_min_lr` (or on NaN).

    With `outdir`, the reference's artifacts go there: `eval_dists.p`
    (posteriors and images of the first <= 1000 eval samples),
    `{train,eval,self}_consistency_dists.p`,
    `consistency_image_<mode>_*.png` strips, a `z_hist_000.png` when
    matplotlib imports; and the regressor's checkpoints after every cycle
    (once after training on the fixed-steps path), from which a rerun
    resumes exactly: draws, Adam state and the cycle bookkeeping."""
    g = _Gilbo(gan, ts, batch_size, learning_rate, seed, draw)
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
    meta = g.load_latest(outdir) if outdir is not None else None
    # Only a checkpoint of the same protocol continues.
    if meta is not None and ("steps" in meta) != (options is None):
        logger.warning("Ignoring GILBO checkpoint from a different "
                       "training protocol.")
        meta = None
        g.reset()

    if options is None:
        start_step = meta["steps"] if meta is not None else 0
        if start_step > train_steps:
            # A longer-trained regressor answers another budget.
            logger.warning("Ignoring GILBO checkpoint trained for %d steps > "
                           "requested budget %d; retraining.", start_step,
                           train_steps)
            start_step = 0
            g.reset()
        for i in range(start_step, train_steps):
            g.train_step(i)
        if outdir is not None and start_step < train_steps:
            g.save(outdir, 0, dict(steps=train_steps))
    else:
        lr_scale = options.get("gilbo_lr_scale", 0.5)
        min_lr = options.get("gilbo_min_lr", 1e-8)
        min_ai_step_scale = options.get("gilbo_min_ai_step_scale", 0.75)
        min_ai_step_value = options.get("gilbo_min_ai_step_value", 0.5)
        max_train_cycles = options.get("gilbo_max_train_cycles", 50)
        steps_per_cycle = options.get("gilbo_train_steps_per_cycle", 10000)
        lr, ais, min_ai = learning_rate, [0.0], -2.0
        step_index, start_cycle = 0, 0
        if meta is not None and "cycle" in meta:
            lr, ais, min_ai = meta["lr"], meta["ais"], meta["min_ai"]
            step_index, start_cycle = meta["step_index"], meta["cycle"]
        for cycle in range(start_cycle, max_train_cycles):
            if lr < min_lr:
                break
            # optax's inject_hyperparams keeps the rate in f32.
            g.tx.lr = float(np.float32(lr))
            ai = 0.0
            for j in range(steps_per_cycle):
                loss = float(g.train_step(step_index))
                step_index += 1
                # Streaming mean of the batch GILBO (= -loss - log p).
                ai += (-loss - g.log_pz - ai) / (j + 1)
            if ai < min_ai:
                lr *= lr_scale
            if lr < min_lr or np.isnan(ai):
                break
            ais.append(ai)
            # The next cycle must improve on this one by a share of its
            # gain (capped), else the rate decays (gilbo.py:255-266).
            min_ai = max(min_ai, ai + max(0.0, min(
                min_ai_step_value, (ai - ais[-2]) * min_ai_step_scale)))
            if outdir is not None:
                g.save(outdir, cycle + 1,
                       dict(cycle=cycle + 1, lr=lr, ais=ais, min_ai=min_ai,
                            step_index=step_index))

    # The eval pass; the first <= 1000 samples' posteriors and images go
    # to eval_dists.p (gilbo.py:295-320).
    values, p1s, p2s, dist_images = [], [], [], []
    save_dist_batches = -(-1000 // batch_size) if outdir else 0
    for i in range(eval_batches):
        value, a, b, x = g.gilbo_batch(i)
        values.append(float(value))
        if i < save_dist_batches:
            p1s.append(a.cpu().numpy())
            p2s.append(b.cpu().numpy())
            dist_images.append(x.cpu().numpy())
    gilbo = float(np.mean(np.nan_to_num(values)))
    if outdir is not None and p1s:
        with open(os.path.join(outdir, "eval_dists.p"), "wb") as f:
            pickle.dump(dict(dist_p1=np.concatenate(p1s)[:1000],
                             dist_p2=np.concatenate(p2s)[:1000],
                             images=np.concatenate(dist_images)[:1000]), f)
        _save_z_histogram(g, outdir, 0)

    def consistency(images, mode, save_images=20):
        """Symmetric posterior KL between encodings of `images` and of
        their regenerations (the reference's _run_gilbo_consistency)."""
        if images is None:
            return float("nan")
        kls, rkls, p1s, p2s, cp1s, cp2s = [], [], [], [], [], []
        for bi, i in enumerate(range(
                0, min(len(images), eval_batches * batch_size), batch_size)):
            x = torch.as_tensor(np.asarray(images[i:i + batch_size],
                                           np.float32), device=g.device)
            if x.shape[0] < batch_size:
                break
            kl, rkl, x2, posteriors = g.consistency_batch(
                x, f"{mode}_consistency", bi)
            kls.append(kl.cpu().numpy())
            rkls.append(rkl.cpu().numpy())
            if outdir is not None:
                for acc, p in zip((p1s, p2s, cp1s, cp2s), posteriors):
                    acc.append(p.cpu().numpy())
                if bi < save_images:
                    # [B, H, W, C] -> one [B * H, W, C] strip.
                    utils.save_images(
                        x2.cpu().numpy().reshape(-1, *x2.shape[2:]),
                        os.path.join(outdir,
                                     "consistency_image_%s_%06d_%06d.png"
                                     % (mode, i, i + batch_size - 1)))
        if not kls:
            return float("nan")
        kls, rkls = np.concatenate(kls), np.concatenate(rkls)
        skls = (kls + rkls) / 2.0
        if outdir is not None:
            with open(os.path.join(outdir, "%s_consistency_dists.p" % mode),
                      "wb") as f:
                pickle.dump(dict(
                    dist_p1=np.concatenate(p1s), dist_p2=np.concatenate(p2s),
                    consist_dist_p1=np.concatenate(cp1s),
                    consist_dist_p2=np.concatenate(cp2s),
                    consistency_kl=kls, consistency_rkl=rkls,
                    consistency_skl=skls), f)
        return float(np.mean(skls))

    _, self_images = g.gen("self", 0)
    return (gilbo, consistency(train_images, "train"),
            consistency(eval_images, "eval"),
            consistency(self_images.cpu().numpy(), "self"))


def _save_z_histogram(g, outdir, step):
    """Per-dimension posterior histogram (the reference's
    _save_z_histograms, gilbo.py:478-507): one z, its image, its posterior,
    10,000 draws a dimension against the true z (dashed). Drawn only when
    matplotlib imports; the metric never depends on it."""
    try:
        import matplotlib
    except ImportError:
        logger.info("Skipping the GILBO z histogram: no matplotlib.")
        return
    try:
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        z = g.z("eval", 10 ** 6, n=1)
        with torch.no_grad():
            a, b = g.regressor(g.gan.sample(g.ts, z).float())
        a, b = a[0].cpu().numpy(), b[0].cpu().numpy()
        z = z.cpu().numpy()
        draws = 2.0 * np.random.RandomState(0).beta(
            a, b, size=(10000, g.z_dim)) - 1.0
        n = min(64, g.z_dim)
        fig, axs = plt.subplots(8, -(-n // 8), figsize=(15, 10))
        bins = np.linspace(-1, 1, 70)
        for j in range(n):
            axs.flat[j].hist(draws[:, j], bins, histtype="stepfilled",
                             density=True)
            axs.flat[j].vlines(z[0, j], 0, 1.0, linestyle="dashed")
        plt.tight_layout()
        fig.savefig(os.path.join(outdir, "z_hist_%03d.png" % step))
        plt.close(fig)
    except Exception as e:  # A chart must never fail the metric.
        logger.info("Skipping the GILBO z histogram: %r", e)


def _check_uniform_z_prior():
    """GILBO's log p(z) and Beta posterior assume z ~ U(-1, 1)^d
    (gilbo.py:116-125): any other configured prior (the BigGAN recipes'
    normal z) is refused. Read from gin at call time, so an export's eval
    sees its own snapshot."""
    dist = gin.query("z.distribution_fn", default=rng_ops.uniform)
    minval = float(gin.query("z.minval", default=-1.0))
    maxval = float(gin.query("z.maxval", default=1.0))
    if dist is not rng_ops.uniform or (minval, maxval) != (-1.0, 1.0):
        raise ValueError(
            "GILBO requires z ~ U(-1, 1)^d (its log p(z) and Beta "
            f"posterior support assume it); the configured prior is "
            f"{getattr(dist, '__name__', dist)}[{minval}, {maxval}]. "
            "Remove GILBOTask from eval_tasks for this recipe.")


@gin.configurable("GILBOTask")
class GILBOTask(eval_task.EvalTask):
    """GILBO and its consistency metrics (gilbo.py:52-77). Needs the
    generator: it runs once per checkpoint through `run_with_gan`."""

    def __init__(self, outdir=None, task_workdir=None, dataset_name=None,
                 **train_kwargs):
        """`train_kwargs` (train_steps, options, batch_size, ...) are
        train_gilbo's defaults for this task."""
        self.outdir = outdir
        self.task_workdir = task_workdir
        self.dataset = dataset_name
        self._train_kwargs = train_kwargs

    def metric_list(self):
        return frozenset(["gilbo", "gilbo_train_consistency",
                          "gilbo_eval_consistency",
                          "gilbo_self_consistency"])

    def run_after_session(self, fake_dset, real_dset=None):
        raise NotImplementedError(
            "GILBOTask needs generator access; call run_with_gan(gan, ts).")

    def validate_gan(self, gan):
        """Called by the eval before any of a checkpoint's work: a
        non-uniform prior fails first."""
        del gan  # The check reads the config, not the weights.
        _check_uniform_z_prior()

    def run_with_gan(self, gan, ts, train_images=None, eval_images=None,
                     **kwargs):
        """Images in [0, 1]. The constructor's train_kwargs win over the
        eval's (which always passes its batch size); kwargs train_gilbo
        does not take are dropped."""
        _check_uniform_z_prior()
        kwargs = {**kwargs, **self._train_kwargs}
        kwargs.setdefault("outdir", self.outdir)
        g, tc, ec, sc = utils.call_with_accepted_args(
            train_gilbo, gan=gan, ts=ts, train_images=train_images,
            eval_images=eval_images, **kwargs)
        return {"gilbo": g, "gilbo_train_consistency": tc,
                "gilbo_eval_consistency": ec,
                "gilbo_self_consistency": sc}
