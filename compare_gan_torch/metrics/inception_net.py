"""The Inception network of FID and IS, in PyTorch (counterpart of
compare_gan_tpu/metrics/inception_net.py).

The architecture is the 2015-12-05 Inception-v3 graph
(`inceptionv1_for_inception_score.pb`: 2048-d `pool_3` features, 1008-way
`logits`). Its weights come from that frozen graph (`read_frozen_graph`:
the port's own GraphDef reader, no TensorFlow) or from the `.npz` that
`convert_frozen_graph` writes from it (the JAX package's converter writes
the same file): one entry per weight, keyed by the graph's op name, conv
kernels HWIO. This module transposes conv kernels to OIHW when it loads
them. The network takes over from the graph's `Mul:0`, after its own
preprocessing, as the JAX package's TF session is fed.

Activations are NCHW inside. Every pad is symmetric: the stride-2 convs
and the pools that reduce are VALID, and the SAME convs are stride 1 with
odd kernels, so `padding=k//2` is TF's SAME. The 3x3 average pools divide
by the count of cells inside the image (`count_include_pad=False`), as the
JAX package's `_avg_pool` does. Every conv is conv -> batchnorm (beta only,
eps 1e-3) -> relu.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from compare_gan_torch.tf_io import protobuf

Params = Dict[str, torch.Tensor]


def _conv_bn_relu(params: Params, x, scope, stride=1, padding="SAME"):
    w = params[f"{scope}/conv2d_params"]
    k_h, k_w = w.shape[2:]
    if padding == "SAME":
        if stride != 1 or k_h % 2 == 0 or k_w % 2 == 0:
            raise ValueError(f"{scope}: SAME padding is symmetric only at "
                             f"stride 1 with odd kernels.")
        pad = (k_h // 2, k_w // 2)
    else:
        pad = 0
    out = F.conv2d(x, w, stride=stride, padding=pad)
    beta, mean, var = (params[f"{scope}/batchnorm/{k}"][None, :, None, None]
                       for k in ("beta", "moving_mean", "moving_variance"))
    return F.relu((out - mean) * torch.rsqrt(var + 1e-3) + beta)


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)


def _avg_pool(x):
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def _inception_a(params, x, scope):
    """35x35 block `mixed`/`mixed_1`/`mixed_2`."""
    b0 = _conv_bn_relu(params, x, f"{scope}/conv")
    b1 = _conv_bn_relu(params, x, f"{scope}/tower/conv")
    b1 = _conv_bn_relu(params, b1, f"{scope}/tower/conv_1")
    b2 = _conv_bn_relu(params, x, f"{scope}/tower_1/conv")
    b2 = _conv_bn_relu(params, b2, f"{scope}/tower_1/conv_1")
    b2 = _conv_bn_relu(params, b2, f"{scope}/tower_1/conv_2")
    b3 = _conv_bn_relu(params, _avg_pool(x), f"{scope}/tower_2/conv")
    return torch.cat([b0, b1, b2, b3], dim=1)


def _reduction_a(params, x, scope):
    """`mixed_3`: 35x35 -> 17x17."""
    b0 = _conv_bn_relu(params, x, f"{scope}/conv", stride=2, padding="VALID")
    b1 = _conv_bn_relu(params, x, f"{scope}/tower/conv")
    b1 = _conv_bn_relu(params, b1, f"{scope}/tower/conv_1")
    b1 = _conv_bn_relu(params, b1, f"{scope}/tower/conv_2", stride=2,
                       padding="VALID")
    return torch.cat([b0, b1, _max_pool(x)], dim=1)


def _inception_b(params, x, scope):
    """17x17 block `mixed_4`..`mixed_7` (1x7 / 7x1 factorized)."""
    b0 = _conv_bn_relu(params, x, f"{scope}/conv")
    b1 = _conv_bn_relu(params, x, f"{scope}/tower/conv")
    b1 = _conv_bn_relu(params, b1, f"{scope}/tower/conv_1")
    b1 = _conv_bn_relu(params, b1, f"{scope}/tower/conv_2")
    b2 = _conv_bn_relu(params, x, f"{scope}/tower_1/conv")
    for i in range(1, 5):
        b2 = _conv_bn_relu(params, b2, f"{scope}/tower_1/conv_{i}")
    b3 = _conv_bn_relu(params, _avg_pool(x), f"{scope}/tower_2/conv")
    return torch.cat([b0, b1, b2, b3], dim=1)


def _reduction_b(params, x, scope):
    """`mixed_8`: 17x17 -> 8x8."""
    b0 = _conv_bn_relu(params, x, f"{scope}/tower/conv")
    b0 = _conv_bn_relu(params, b0, f"{scope}/tower/conv_1", stride=2,
                       padding="VALID")
    b1 = _conv_bn_relu(params, x, f"{scope}/tower_1/conv")
    b1 = _conv_bn_relu(params, b1, f"{scope}/tower_1/conv_1")
    b1 = _conv_bn_relu(params, b1, f"{scope}/tower_1/conv_2")
    b1 = _conv_bn_relu(params, b1, f"{scope}/tower_1/conv_3", stride=2,
                       padding="VALID")
    return torch.cat([b0, b1, _max_pool(x)], dim=1)


def _inception_c(params, x, scope):
    """8x8 block `mixed_9`/`mixed_10` (split 1x3 / 3x1 towers)."""
    b0 = _conv_bn_relu(params, x, f"{scope}/conv")
    b1 = _conv_bn_relu(params, x, f"{scope}/tower/conv")
    b1a = _conv_bn_relu(params, b1, f"{scope}/tower/mixed/conv")
    b1b = _conv_bn_relu(params, b1, f"{scope}/tower/mixed/conv_1")
    b2 = _conv_bn_relu(params, x, f"{scope}/tower_1/conv")
    b2 = _conv_bn_relu(params, b2, f"{scope}/tower_1/conv_1")
    b2a = _conv_bn_relu(params, b2, f"{scope}/tower_1/mixed/conv")
    b2b = _conv_bn_relu(params, b2, f"{scope}/tower_1/mixed/conv_1")
    b3 = _conv_bn_relu(params, _avg_pool(x), f"{scope}/tower_2/conv")
    return torch.cat([b0, b1a, b1b, b2a, b2b, b3], dim=1)


def inception_features(params: Params, images):
    """images: [N, H, W, 3] in [-1, 1] (H = W = 299 for the graph's
    features; any size the strides fit also runs) -> (pool_3 [N, 2048],
    logits [N, 1008])."""
    x = images.permute(0, 3, 1, 2)
    x = _conv_bn_relu(params, x, "conv", stride=2, padding="VALID")
    x = _conv_bn_relu(params, x, "conv_1", padding="VALID")
    x = _conv_bn_relu(params, x, "conv_2", padding="SAME")
    x = _max_pool(x)
    x = _conv_bn_relu(params, x, "conv_3", padding="VALID")
    x = _conv_bn_relu(params, x, "conv_4", padding="VALID")
    x = _max_pool(x)
    for scope in ("mixed", "mixed_1", "mixed_2"):
        x = _inception_a(params, x, scope)
    x = _reduction_a(params, x, "mixed_3")
    for scope in ("mixed_4", "mixed_5", "mixed_6", "mixed_7"):
        x = _inception_b(params, x, scope)
    x = _reduction_b(params, x, "mixed_8")
    x = _inception_c(params, x, "mixed_9")
    x = _inception_c(params, x, "mixed_10")
    pool = x.mean(dim=(2, 3))  # pool_3
    logits = pool @ params["softmax/weights"] + params["softmax/biases"]
    return pool, logits


def _resize_bilinear(images, size):
    """TF1 `tf.image.resize_bilinear` (align_corners=False, legacy scaling
    src = dst_idx * in/out), the resize inside tfgan.eval's preprocess_image.
    `F.interpolate` centres pixels at +0.5 instead, which moves the
    features. images: [N, H, W, C] float."""
    n, h, w, c = images.shape
    if h == size and w == size:
        return images
    dev = images.device
    fy = torch.arange(size, dtype=torch.float32, device=dev) * float(
        np.float32(h) / np.float32(size))
    fx = torch.arange(size, dtype=torch.float32, device=dev) * float(
        np.float32(w) / np.float32(size))
    y0 = torch.clamp(fy.to(torch.int64), max=h - 1)
    x0 = torch.clamp(fx.to(torch.int64), max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    wy = (fy - y0.float())[None, :, None, None]
    wx = (fx - x0.float())[None, None, :, None]
    rows0, rows1 = images[:, y0], images[:, y1]
    top = rows0[:, :, x0] + (rows0[:, :, x1] - rows0[:, :, x0]) * wx
    bot = rows1[:, :, x0] + (rows1[:, :, x1] - rows1[:, :, x0]) * wx
    return top + (bot - top) * wy


def features_from_pixels(params: Params, images_255):
    """(pool, logits) of images in [0, 255], [N, H, W, 3]: resized to 299
    and mapped to [-1, 1] as the frozen graph's `Mul` input expects."""
    x = _resize_bilinear(images_255.float(), 299)
    return inception_features(params, (x - 128.0) / 128.0)


@contextlib.contextmanager
def full_f32():
    """Turn TF32 off for cuDNN convs and cuBLAS products in the block, and
    restore the flags after it: TF32 moves the pool features by ~1e-3
    relative, which skews FID."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


def params_from_npz(arrays, device) -> Params:
    """The `.npz` layout (op-name keys, conv kernels HWIO) as f32 tensors
    on `device`, conv kernels OIHW."""
    out = {}
    for name, value in arrays.items():
        t = torch.as_tensor(np.asarray(value, np.float32))
        if t.dim() == 4:
            t = t.permute(3, 2, 0, 1)
        out[name] = t.contiguous().to(device)
    return out


def _feature_fn(arrays, device) -> Callable:
    params = params_from_npz(arrays, device)

    def fn(images):
        with torch.no_grad(), full_f32():
            x = torch.as_tensor(np.asarray(images, np.float32), device=device)
            pool, logits = features_from_pixels(params, x)
        return pool.cpu().numpy(), logits.cpu().numpy()

    return fn


def make_feature_fn(npz_path: str, device="cuda") -> Callable:
    """(images in [0, 255], [N, H, W, 3]) -> (pool [N, 2048], logits
    [N, 1008]) as numpy arrays, computed on `device` in full f32, with the
    weights of `npz_path` (the layout `convert_frozen_graph` writes)."""
    with np.load(npz_path) as data:
        return _feature_fn({k: data[k] for k in data.files}, device)


def make_graph_feature_fn(pb_path: str, device="cuda") -> Callable:
    """make_feature_fn with the weights read straight from the frozen
    graph `pb_path`."""
    return _feature_fn(read_frozen_graph(pb_path), device)


# GraphDef float types; the graph's int32 Consts (reduction indices,
# reshape shapes) are plumbing, not weights.
_FLOAT_DTYPES = (protobuf.DT_FLOAT, protobuf.DT_DOUBLE, protobuf.DT_HALF)


def read_frozen_graph(pb_path: str) -> Dict[str, np.ndarray]:
    """{node name: value} of every floating Const of rank >= 1 in a frozen
    GraphDef, in graph order: what the JAX package's convert_frozen_graph
    keeps, read without TensorFlow."""
    with open(pb_path, "rb") as f:
        data = f.read()
    out = {}
    for node in protobuf.iter_graph_nodes(data):
        if node.op != "Const" or "value" not in node.attr:
            continue
        tensor = protobuf.attr_tensor(node.attr["value"], _FLOAT_DTYPES)
        if tensor is not None and tensor.ndim >= 1:
            out[node.name] = tensor
    return out


def convert_frozen_graph(pb_path: str, npz_out: str) -> None:
    """Write the frozen graph's weights (read_frozen_graph) as the `.npz`
    that make_feature_fn and $COMPARE_GAN_INCEPTION_NPZ read."""
    np.savez(npz_out, **read_frozen_graph(pb_path))


_A_CH = {"mixed": (192, 32), "mixed_1": (256, 64), "mixed_2": (288, 64)}
_B_MID = {"mixed_4": 128, "mixed_5": 160, "mixed_6": 160, "mixed_7": 192}


def param_shapes() -> Dict[str, tuple]:
    """{op name: shape} of every weight, conv kernels HWIO."""
    shapes: Dict[str, tuple] = {}

    def conv(scope, kh, kw, cin, cout):
        shapes[f"{scope}/conv2d_params"] = (kh, kw, cin, cout)
        for suffix in ("beta", "moving_mean", "moving_variance"):
            shapes[f"{scope}/batchnorm/{suffix}"] = (cout,)

    conv("conv", 3, 3, 3, 32)
    conv("conv_1", 3, 3, 32, 32)
    conv("conv_2", 3, 3, 32, 64)
    conv("conv_3", 1, 1, 64, 80)
    conv("conv_4", 3, 3, 80, 192)
    for scope, (cin, proj) in _A_CH.items():
        conv(f"{scope}/conv", 1, 1, cin, 64)
        conv(f"{scope}/tower/conv", 1, 1, cin, 48)
        conv(f"{scope}/tower/conv_1", 5, 5, 48, 64)
        conv(f"{scope}/tower_1/conv", 1, 1, cin, 64)
        conv(f"{scope}/tower_1/conv_1", 3, 3, 64, 96)
        conv(f"{scope}/tower_1/conv_2", 3, 3, 96, 96)
        conv(f"{scope}/tower_2/conv", 1, 1, cin, proj)
    conv("mixed_3/conv", 3, 3, 288, 384)
    conv("mixed_3/tower/conv", 1, 1, 288, 64)
    conv("mixed_3/tower/conv_1", 3, 3, 64, 96)
    conv("mixed_3/tower/conv_2", 3, 3, 96, 96)
    for scope, mid in _B_MID.items():
        conv(f"{scope}/conv", 1, 1, 768, 192)
        conv(f"{scope}/tower/conv", 1, 1, 768, mid)
        conv(f"{scope}/tower/conv_1", 1, 7, mid, mid)
        conv(f"{scope}/tower/conv_2", 7, 1, mid, 192)
        conv(f"{scope}/tower_1/conv", 1, 1, 768, mid)
        conv(f"{scope}/tower_1/conv_1", 7, 1, mid, mid)
        conv(f"{scope}/tower_1/conv_2", 1, 7, mid, mid)
        conv(f"{scope}/tower_1/conv_3", 7, 1, mid, mid)
        conv(f"{scope}/tower_1/conv_4", 1, 7, mid, 192)
        conv(f"{scope}/tower_2/conv", 1, 1, 768, 192)
    conv("mixed_8/tower/conv", 1, 1, 768, 192)
    conv("mixed_8/tower/conv_1", 3, 3, 192, 320)
    conv("mixed_8/tower_1/conv", 1, 1, 768, 192)
    conv("mixed_8/tower_1/conv_1", 1, 7, 192, 192)
    conv("mixed_8/tower_1/conv_2", 7, 1, 192, 192)
    conv("mixed_8/tower_1/conv_3", 3, 3, 192, 192)
    for scope, cin in (("mixed_9", 1280), ("mixed_10", 2048)):
        conv(f"{scope}/conv", 1, 1, cin, 320)
        conv(f"{scope}/tower/conv", 1, 1, cin, 384)
        conv(f"{scope}/tower/mixed/conv", 1, 3, 384, 384)
        conv(f"{scope}/tower/mixed/conv_1", 3, 1, 384, 384)
        conv(f"{scope}/tower_1/conv", 1, 1, cin, 448)
        conv(f"{scope}/tower_1/conv_1", 3, 3, 448, 384)
        conv(f"{scope}/tower_1/mixed/conv", 1, 3, 384, 384)
        conv(f"{scope}/tower_1/mixed/conv_1", 3, 1, 384, 384)
        conv(f"{scope}/tower_2/conv", 1, 1, cin, 192)
    shapes["softmax/weights"] = (2048, 1008)
    shapes["softmax/biases"] = (1008,)
    return shapes


def init_random(generator: torch.Generator) -> Dict[str, np.ndarray]:
    """Random weights in the `.npz` layout (HWIO convs), drawn in the order
    of the sorted names from `generator` (a CPU generator): for tests and
    the random-feature FID proxy only. BN is the identity (mean 0, var 1,
    beta 0), and kernels are He-scaled, sqrt(2 / fan_in): each ReLU halves
    the signal's second moment, so the activations keep their magnitude
    through the ~95 convs instead of decaying to a collapsed FID."""
    params = {}
    for name, shape in sorted(param_shapes().items()):
        if name.endswith("moving_variance"):
            params[name] = np.ones(shape, np.float32)
        elif name.endswith(("beta", "moving_mean", "biases")):
            params[name] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[:-1]))
            params[name] = (torch.randn(shape, generator=generator)
                            * np.sqrt(2.0 / fan_in)).numpy()
    return params
