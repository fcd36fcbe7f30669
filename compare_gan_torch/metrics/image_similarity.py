"""SSIM and multiscale SSIM on NHWC image batches (counterpart of
compare_gan_tpu/metrics/image_similarity.py; Wang et al. 2003).

The 11-tap Gaussian window is a depthwise conv (`groups = C`), run in f32
on the images' device with TF32 off, so the card sums the same f32
products as the CPU. Means are per channel; the channels are averaged only
after the weighted product over the scales, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Wang et al. 2003 power factors (image_similarity.py:247).
_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    """2-D Gaussian window (image_similarity.py:63-82)."""
    radius = size // 2
    offset = 0.0 if size % 2 else 0.5
    coords = np.arange(size) - radius + offset
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    window = np.outer(g, g)
    return (window / window.sum()).astype(np.float32)


def _depthwise_filter(x, window):
    """VALID depthwise conv of NHWC x with one 2-D window."""
    c = x.shape[-1]
    w = window.expand(c, 1, *window.shape[-2:])
    with torch.backends.cudnn.flags(allow_tf32=False):
        out = F.conv2d(x.permute(0, 3, 1, 2), w, groups=c)
    return out.permute(0, 2, 3, 1)


def _window(h, w, device, filter_size=11, filter_sigma=1.5):
    """The Gaussian window of a scale whose maps are h x w: 11 taps, or
    the map's size when smaller, with sigma scaled alike."""
    size = min(filter_size, h, w)
    sigma = size * filter_sigma / filter_size if filter_size else filter_sigma
    return torch.from_numpy(_fspecial_gauss(size, sigma)).to(device)


def _ssim_from_moments(mu1, mu2, sigma11, sigma22, sigma12, max_val=255.0,
                       k1=0.01, k2=0.03):
    """Per-channel mean SSIM and contrast-structure, [..., C], from the
    filtered maps [..., h, w, C] (image_similarity.py:85-180):
    sigma11 = filter(x1 * x1) etc. before the means are taken out."""
    mu11, mu22, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma11 = sigma11 - mu11
    sigma22 = sigma22 - mu22
    sigma12 = sigma12 - mu12
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    v1 = 2.0 * sigma12 + c2
    v2 = sigma11 + sigma22 + c2
    ssim = (((2.0 * mu12 + c1) * v1) / ((mu11 + mu22 + c1) * v2)).mean(
        dim=(-3, -2))
    cs = (v1 / v2).mean(dim=(-3, -2))
    return ssim, cs


def _ssim_per_scale(img1, img2, max_val=255.0):
    """(ssim [N, C], cs [N, C]) of one scale."""
    window = _window(img1.shape[1], img1.shape[2], img1.device)
    return _ssim_from_moments(
        _depthwise_filter(img1, window), _depthwise_filter(img2, window),
        _depthwise_filter(img1 * img1, window),
        _depthwise_filter(img2 * img2, window),
        _depthwise_filter(img1 * img2, window), max_val=max_val)


def _downsample_2x(x):
    """2x2 mean pool after edge-padding odd sizes to even
    (image_similarity.py:77-83)."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        x = F.pad(x.permute(0, 3, 1, 2), (0, w % 2, 0, h % 2),
                  mode="replicate").permute(0, 2, 3, 1)
        h, w = x.shape[1], x.shape[2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4)) / 4.0


def _as_f32(x, device):
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, device=device)
    return x.float()


def _combine(ssim, mcs, weights):
    """The weighted product over the scales, then the channel mean
    (image_similarity.py:323-333): ssim [..., C] of the last scale, mcs the
    clamped cs of the others."""
    mcs = torch.stack(mcs)
    w = weights[:-1].reshape((-1,) + (1,) * (mcs.dim() - 1))
    per_channel = (torch.prod(mcs ** w, dim=0)
                   * torch.clamp(ssim, min=0.0) ** weights[-1])
    return per_channel.mean(dim=-1)


def multiscale_ssim(img1, img2, max_val=255.0, levels=5, device=None):
    """MS-SSIM over `levels` scales (image_similarity.py:183-333) of NHWC
    batches in [0, max_val], numpy or tensors; returns a [N] tensor. Runs
    on `device`, by default the first input's (the CPU for numpy)."""
    if device is None:
        device = img1.device if isinstance(img1, torch.Tensor) else "cpu"
    img1, img2 = _as_f32(img1, device), _as_f32(img2, device)
    weights = torch.tensor(_MSSSIM_WEIGHTS[:levels], device=img1.device)
    mcs = []
    for level in range(levels):
        ssim, cs = _ssim_per_scale(img1, img2, max_val=max_val)
        if level < levels - 1:
            mcs.append(torch.clamp(cs, min=0.0))
            img1, img2 = _downsample_2x(img1), _downsample_2x(img2)
    return _combine(ssim, mcs, weights)


def pairwise_multiscale_ssim(images, max_val=255.0, levels=5, rows=16):
    """MS-SSIM of every ordered pair of an NHWC batch: [B, B], entry (i, j)
    equal to multiscale_ssim(images[i:i+1], images[j:j+1]). Each image's
    pyramid, means and filtered squares are taken once; only the filtered
    products x_i * x_j are per pair, `rows` values of i at a time."""
    x = _as_f32(images, images.device if isinstance(images, torch.Tensor)
                else "cpu")
    n = len(x)
    weights = torch.tensor(_MSSSIM_WEIGHTS[:levels], device=x.device)
    mcs = []
    for level in range(levels):
        window = _window(x.shape[1], x.shape[2], x.device)
        mu = _depthwise_filter(x, window)
        sq = _depthwise_filter(x * x, window)
        ssim, cs = [], []
        for i in range(0, n, rows):
            xi = x[i:i + rows]
            r = len(xi)
            prod = (xi[:, None] * x[None]).reshape(r * n, *x.shape[1:])
            cross = _depthwise_filter(prod, window)
            s, c = _ssim_from_moments(
                mu[i:i + r, None], mu[None], sq[i:i + r, None], sq[None],
                cross.reshape(r, n, *cross.shape[1:]), max_val=max_val)
            ssim.append(s)
            cs.append(c)
        ssim, cs = torch.cat(ssim), torch.cat(cs)
        if level < levels - 1:
            mcs.append(torch.clamp(cs, min=0.0))
            x = _downsample_2x(x)
    return _combine(ssim, mcs, weights)


def ssim(img1, img2, max_val=255.0, device=None):
    """Single-scale SSIM, [N] (channel-averaged)."""
    if device is None:
        device = img1.device if isinstance(img1, torch.Tensor) else "cpu"
    return _ssim_per_scale(_as_f32(img1, device), _as_f32(img2, device),
                           max_val=max_val)[0].mean(dim=-1)
