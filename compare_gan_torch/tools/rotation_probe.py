"""Measure whether the rot90 pretext task is learnable on a dataset
(counterpart of tools/rotation_probe.py of the JAX package).

The S3GAN/SSGAN self-supervision asks a head to predict which of 4
rotations was applied to an image. That task is learnable only if the data
distribution is not invariant to 90-degree rotations: `convex_polygons*`
draws each polygon's orientation uniformly, so no classifier beats 0.25
test accuracy there, while the `*_oriented` variants add a vertical shading
ramp that makes the task trivial.

The probe is a small standalone CNN (conv3x3(16), ReLU, max-pool 2 VALID,
conv3x3(32), ReLU, global mean, fc(4)), trained with Adam at 1e-3 (optax's
`adam` at its defaults is the same update) on a sliding window over the
shuffled rotation task. One `RandomState(seed)` draws the shuffle and then
the glorot-uniform weights (HWIO, as the JAX tool draws them), so the probe
starts where the JAX tool's does. Accuracies are unweighted means over
chunks of 512, as there.

Usage:
  COMPARE_GAN_DATA_DIR=... python -m compare_gan_torch.tools.rotation_probe \
      --datasets convex_polygons_partial convex_polygons_partial_oriented \
      [--n_train=4096] [--steps=400] [--out=/tmp/probe.json] [--device=cuda]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

CHUNK = 512


def make_rotation_task(images: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """All 4 rot90 copies of every image, labeled by k (balanced 4-way)."""
    xs = np.concatenate([np.rot90(images, k, axes=(1, 2)) for k in range(4)])
    ys = np.repeat(np.arange(4), images.shape[0])
    return xs.astype(np.float32) / 255.0, ys.astype(np.int32)


def _init_cnn(rng: np.random.RandomState, channels: int):
    """The JAX tool's weights, drawn in its order: HWIO kernels, fc
    [in, out]."""
    def glorot(*shape):
        fan_in = int(np.prod(shape[:-1]))
        fan_out = int(shape[-1])
        lim = np.sqrt(6.0 / (fan_in + fan_out))
        return rng.uniform(-lim, lim, size=shape).astype(np.float32)

    return {
        "conv1": glorot(3, 3, channels, 16), "b1": np.zeros(16, np.float32),
        "conv2": glorot(3, 3, 16, 32), "b2": np.zeros(32, np.float32),
        "fc": glorot(32, 4), "bfc": np.zeros(4, np.float32),
    }


class ProbeCNN(nn.Module):
    """The probe on NHWC images."""

    def __init__(self, params, device):
        super().__init__()
        channels = params["conv1"].shape[2]
        self.conv1 = nn.Conv2d(channels, 16, 3, padding=1, device=device)
        self.conv2 = nn.Conv2d(16, 32, 3, padding=1, device=device)
        self.fc = nn.Linear(32, 4, device=device)
        with torch.no_grad():
            for layer, kernel, bias in ((self.conv1, "conv1", "b1"),
                                        (self.conv2, "conv2", "b2")):
                layer.weight.copy_(torch.from_numpy(
                    params[kernel].transpose(3, 2, 0, 1)))  # HWIO -> OIHW
                layer.bias.copy_(torch.from_numpy(params[bias]))
            self.fc.weight.copy_(torch.from_numpy(params["fc"].T))
            self.fc.bias.copy_(torch.from_numpy(params["bfc"]))

    def forward(self, x):
        h = F.relu(self.conv1(x.permute(0, 3, 1, 2)))
        h = F.max_pool2d(h, 2, 2)  # VALID: a trailing odd row is dropped.
        h = F.relu(self.conv2(h))
        return self.fc(h.mean(dim=(2, 3)))

    def jax_params(self):
        """The weights in the JAX tool's layout (HWIO, fc [in, out])."""
        def np_(t):
            return t.detach().cpu().numpy()
        return {"conv1": np_(self.conv1.weight).transpose(2, 3, 1, 0),
                "b1": np_(self.conv1.bias),
                "conv2": np_(self.conv2.weight).transpose(2, 3, 1, 0),
                "b2": np_(self.conv2.bias),
                "fc": np_(self.fc.weight).T, "bfc": np_(self.fc.bias)}


def train_probe(dataset: str, n_train: int = 4096, n_test: int = 1024,
                steps: int = 400, batch_size: int = 256, seed: int = 0,
                device="cuda"):
    """(result, trained ProbeCNN) on `dataset`'s train split, evaluated on
    its test split."""
    device = torch.device(device)
    data_dir = os.environ["COMPARE_GAN_DATA_DIR"]
    with np.load(os.path.join(data_dir, dataset, "train.npz")) as z:
        train_images = z["images"][:n_train]
    with np.load(os.path.join(data_dir, dataset, "test.npz")) as z:
        test_images = z["images"][:n_test]

    rng = np.random.RandomState(seed)
    train_x, train_y = make_rotation_task(train_images)
    test_x, test_y = make_rotation_task(test_images)
    perm = rng.permutation(train_x.shape[0])
    train_x, train_y = train_x[perm], train_y[perm]
    model = ProbeCNN(_init_cnn(rng, train_x.shape[-1]), device)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)

    def tensors(x, y):
        return (torch.from_numpy(np.ascontiguousarray(x)).to(device),
                torch.from_numpy(y).long().to(device))

    n = train_x.shape[0]
    # A probe set smaller than the batch trains on full-set batches (the
    # sliding window's divisor would not be positive).
    batch_size = min(batch_size, n)
    for step in range(steps):
        lo = (step * batch_size) % (n - batch_size + 1)
        x, y = tensors(train_x[lo:lo + batch_size],
                       train_y[lo:lo + batch_size])
        loss = F.cross_entropy(model(x), y)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    @torch.no_grad()
    def batched_acc(x, y):
        accs = []
        for i in range(0, x.shape[0], CHUNK):
            xb, yb = tensors(x[i:i + CHUNK], y[i:i + CHUNK])
            accs.append(float((model(xb).argmax(-1) == yb).float().mean()))
        return float(np.mean(accs))

    result = {
        "dataset": dataset,
        "n_train_images": int(train_images.shape[0]),
        "steps": steps,
        "train_accuracy": batched_acc(train_x[:4096], train_y[:4096]),
        "test_accuracy": batched_acc(test_x, test_y),
        "chance": 0.25,
    }
    return result, model


def probe_dataset(dataset: str, n_train: int = 4096, n_test: int = 1024,
                  steps: int = 400, batch_size: int = 256, seed: int = 0,
                  device="cuda"):
    """Train the probe CNN on `dataset`'s train split; eval on its test
    split."""
    return train_probe(dataset, n_train, n_test, steps, batch_size, seed,
                       device)[0]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--datasets", nargs="+", required=True)
    parser.add_argument("--n_train", type=int, default=4096)
    parser.add_argument("--n_test", type=int, default=1024)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--out", default=None)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the probe.")
    args = parser.parse_args(argv)

    results = [probe_dataset(d, args.n_train, args.n_test, args.steps,
                             device=args.device)
               for d in args.datasets]
    line = json.dumps(results)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return results


if __name__ == "__main__":
    main()
