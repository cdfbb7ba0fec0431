"""Image-plane ops: sensor conversion (K1), masked Gaussian pyramid (K3),
gradients (K4).

Counterpart of ``rgbid_tpu/ops/image.py:22-283``. All of it is plain
PyTorch: the JAX package left these to XLA outside any Pallas kernel. The
blur is a separable 5-tap binomial ``F.conv2d`` with zero padding; cuDNN's
TF32 mode is off (``_precision.py``), so it runs in full float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# K1 -----------------------------------------------------------------------


def intensity_from_rgb(rgb_u8: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> luma float32 in [0, 1] (BT.601)."""
    rgb = rgb_u8.to(torch.float32) * (1.0 / 255.0)
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]


def inverse_depth_from_u16(
    depth_u16: torch.Tensor,
    depth_scale: float = 5000.0,
    min_depth: float = 0.3,
    max_depth: float = 10.0,
):
    """(xi, mask): xi = 1/meters where valid else 0; mask float32 {0,1}.

    ``depth_u16`` holds raw u16 values in any integer dtype."""
    d = depth_u16.to(torch.float32) * (1.0 / depth_scale)
    mask = (d > min_depth) & (d < max_depth)
    xi = torch.where(mask, 1.0 / torch.clamp(d, min=1e-6), torch.zeros_like(d))
    return xi, mask.to(torch.float32)


# K3 -----------------------------------------------------------------------

_BINOMIAL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


# Constants are copied to a device once and kept: a host-to-card copy of
# a pageable tensor synchronizes the stream, which the per-frame path
# must not do.
@functools.lru_cache(maxsize=None)
def _binomial(device: torch.device) -> torch.Tensor:
    return torch.tensor(_BINOMIAL, dtype=torch.float32).to(device)


@functools.lru_cache(maxsize=None)
def _ones_blur_inv(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_ones_blur_inv_np(h, w)).to(device)


def _conv_sep(img: torch.Tensor, stride: tuple[int, int]) -> torch.Tensor:
    """Separable 5-tap binomial blur (zero padding) with optional stride.
    Accepts (H, W) or a batched (B, H, W) stack."""
    batched = img.dim() == 3
    x = img[:, None] if batched else img[None, None]
    k = _binomial(img.device)
    x = F.conv2d(x, k.reshape(1, 1, 5, 1), stride=(stride[0], 1), padding=(2, 0))
    x = F.conv2d(x, k.reshape(1, 1, 1, 5), stride=(1, stride[1]), padding=(0, 2))
    return x[:, 0] if batched else x[0, 0]


def masked_blur(img: torch.Tensor, mask: torch.Tensor, stride=(1, 1)):
    """Validity-renormalized blur: blur(img*m)/blur(m); returns (out, weight)."""
    num = _conv_sep(img * mask, stride)
    den = _conv_sep(mask, stride)
    out = torch.where(den > 1e-6, num / torch.clamp(den, min=1e-6), torch.zeros_like(num))
    return out, den


def downsample(img: torch.Tensor, mask: torch.Tensor, min_weight: float = 0.25):
    """One pyramid step: masked blur + 2x subsample (stride-2 convs)."""
    out, wgt = masked_blur(img, mask, stride=(2, 2))
    sub_mask = mask[::2, ::2]
    out_mask = ((wgt > min_weight) & (sub_mask > 0.5)).to(torch.float32)
    return out, out_mask


@functools.lru_cache(maxsize=None)
def _ones_blur_inv_np(h: int, w: int) -> np.ndarray:
    """1 / (stride-2 zero-pad binomial blur of an all-ones (h, w) plane):
    the input-independent border renormalization of unmasked pyramids."""
    b = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float64) / 16.0

    def blur1d(x, axis):
        out = np.zeros_like(x)
        for k, c in enumerate(b):
            sh = k - 2
            src = np.roll(x, -sh, axis=axis)
            idx = [slice(None)] * x.ndim
            if sh > 0:
                idx[axis] = slice(x.shape[axis] - sh, None)
            elif sh < 0:
                idx[axis] = slice(0, -sh)
            if sh != 0:
                src[tuple(idx)] = 0.0
            out += c * src
        return out

    den = blur1d(blur1d(np.ones((h, w)), 0), 1)[::2, ::2]
    return (1.0 / den).astype(np.float32)


def downsample_unmasked(img: torch.Tensor) -> torch.Tensor:
    """Pyramid step for a plane defined everywhere (intensity): one conv
    pair + the constant border renormalization."""
    h, w = img.shape
    return _conv_sep(img, (2, 2)) * _ones_blur_inv(h, w, img.device)


def build_pyramid_unmasked(img: torch.Tensor, levels: int):
    imgs = [img]
    for _ in range(levels - 1):
        imgs.append(downsample_unmasked(imgs[-1]))
    return imgs


def build_pyramid(img: torch.Tensor, mask: torch.Tensor, levels: int):
    """Lists [L0..L_{levels-1}] of (img, mask); mask is float32 {0,1}."""
    imgs, masks = [img], [mask]
    for _ in range(levels - 1):
        i2, m2 = downsample(imgs[-1], masks[-1])
        imgs.append(i2)
        masks.append(m2)
    return imgs, masks


# K4 -----------------------------------------------------------------------


def _central(img: torch.Tensor):
    """Zero-extended central differences along x and y."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[..., :, :-1] = img[..., :, 1:]
    gx[..., :, 1:] -= img[..., :, :-1]
    gy[..., :-1, :] = img[..., 1:, :]
    gy[..., 1:, :] -= img[..., :-1, :]
    return 0.5 * gx, 0.5 * gy


def gradients(img: torch.Tensor, mask: torch.Tensor):
    """(gx, gy) masked central differences (zero at invalid pixels and on
    the one-pixel border). Works on (..., H, W)."""
    gx, gy = _central(img)
    ok_x = torch.zeros_like(mask)
    ok_y = torch.zeros_like(mask)
    ok_x[..., :, 1:-1] = mask[..., :, 2:] * mask[..., :, :-2]
    ok_y[..., 1:-1, :] = mask[..., 2:, :] * mask[..., :-2, :]
    return gx * ok_x, gy * ok_y


def gradients_unmasked(img: torch.Tensor):
    """gradients() for a plane defined everywhere (intensity): border
    columns/rows zero, no mask planes."""
    gx, gy = _central(img)
    gx[..., :, 0] = 0.0
    gx[..., :, -1] = 0.0
    gy[..., 0, :] = 0.0
    gy[..., -1, :] = 0.0
    return gx, gy
