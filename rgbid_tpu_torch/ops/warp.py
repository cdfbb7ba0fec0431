"""SE(3) warping + bilinear sampling (K5's gather half, K2's remap).

Counterpart of ``rgbid_tpu/ops/warp.py``, in plain PyTorch. On the
card the ESM and fusion kernels do this work themselves (per thread, in
the same order of float operations); these functions are what the plain
versions of those kernels, and the tests, run.

Edge semantics kept exactly: coordinates are clipped to
``[0, w - 1.001]`` before ``floor`` (so ``u1 = u0 + 1`` always stays in
range), a sample is in bounds only inside that interval, and the mask
channel is the product of all four corners, not their blend.
"""

from __future__ import annotations

import torch

from ..core.camera import Intrinsics, pixel_grid  # noqa: F401  (re-exported, as the JAX module's)


def backproject_grid(xi: torch.Tensor, intr: Intrinsics, row_offset: int = 0):
    """Per-pixel camera points (X, Y, Z) from an inverse-depth plane.

    ``row_offset`` shifts the pixel grid's v coordinate: a rank of the
    row-sharded tracker holds one horizontal band of the keyframe and
    backprojects it with the global row indices."""
    h, w = xi.shape
    u, v = pixel_grid(h, w, device=xi.device)
    if row_offset:
        v = v + float(row_offset)
    z = 1.0 / torch.clamp(xi, min=1e-8)
    x = (u - intr.cx) * (1.0 / intr.fx) * z
    y = (v - intr.cy) * (1.0 / intr.fy) * z
    return x, y, z


def transform_project(Px, Py, Pz, T: torch.Tensor, intr: Intrinsics):
    """Project template points through T: (u', v', rho', front)."""
    R, t = T[:3, :3], T[:3, 3]
    xp = R[0, 0] * Px + R[0, 1] * Py + R[0, 2] * Pz + t[0]
    yp = R[1, 0] * Px + R[1, 1] * Py + R[1, 2] * Pz + t[1]
    zp = R[2, 0] * Px + R[2, 1] * Py + R[2, 2] * Pz + t[2]
    front = (zp > 1e-6).to(torch.float32)
    rho = 1.0 / torch.clamp(zp, min=1e-6)
    up = intr.fx * xp * rho + intr.cx
    vp = intr.fy * yp * rho + intr.cy
    return up, vp, rho, front


def warp_points(xi_ref, mask_ref, T: torch.Tensor, intr: Intrinsics):
    """Warp every reference pixel into the current frame.

    Returns (u', v', rho', (X', Y', Z'), valid) with valid = mask & in-front.
    """
    x, y, z = backproject_grid(xi_ref, intr)
    R, t = T[:3, :3], T[:3, 3]
    xp = R[0, 0] * x + R[0, 1] * y + R[0, 2] * z + t[0]
    yp = R[1, 0] * x + R[1, 1] * y + R[1, 2] * z + t[1]
    zp = R[2, 0] * x + R[2, 1] * y + R[2, 2] * z + t[2]
    front = (zp > 1e-6).to(torch.float32)
    rho = 1.0 / torch.clamp(zp, min=1e-6)
    up = intr.fx * xp * rho + intr.cx
    vp = intr.fy * yp * rho + intr.cy
    return up, vp, rho, (xp, yp, zp), mask_ref * front


def _corner_weights(u, v, h: int, w: int):
    """Clamped integer corners + fractional offsets + the in-bounds flag."""
    umax, vmax = w - 1.001, h - 1.001
    inb = ((u >= 0.0) & (u <= umax) & (v >= 0.0) & (v <= vmax)).to(torch.float32)
    uc = torch.clamp(u, 0.0, umax)
    vc = torch.clamp(v, 0.0, vmax)
    u0 = torch.floor(uc).to(torch.int64)
    v0 = torch.floor(vc).to(torch.int64)
    fu = uc - u0.to(torch.float32)
    fv = vc - v0.to(torch.float32)
    u1 = torch.clamp(u0 + 1, max=w - 1)
    v1 = torch.clamp(v0 + 1, max=h - 1)
    return inb, u0, v0, u1, v1, fu, fv


def sample_stack7(stack: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Sample a (C, H, W) stack at (u, v): bilinear blend for every channel
    and the exact all-4-corners product of channel 2 (the {0,1} mask). A
    bfloat16 stack's corners are widened to float32 before any arithmetic.

    Returns (blend (C, *u.shape), mask_ok, inb), float32."""
    c, h, w = stack.shape
    inb, u0, v0, u1, v1, fu, fv = _corner_weights(u, v, h, w)
    flat = stack.reshape(c, h * w)

    def corner(vi, ui):
        return flat[:, (vi * w + ui).reshape(-1)].reshape((c,) + u.shape).float()

    s00, s01, s10, s11 = corner(v0, u0), corner(v0, u1), corner(v1, u0), corner(v1, u1)
    w00 = (1 - fu) * (1 - fv)
    w01 = fu * (1 - fv)
    w10 = (1 - fu) * fv
    w11 = fu * fv
    blend = s00 * w00 + s01 * w01 + s10 * w10 + s11 * w11
    mask_ok = s00[2] * s01[2] * s10[2] * s11[2]
    return blend, mask_ok, inb


def sample_tracker_planes(stack3: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Sample [value, value2, mask] (3, H, W) at (u, v).

    Returns (blend0, blend1, mask_ok, inb), each shaped like u."""
    blend, mask_ok, inb = sample_stack7(stack3, u, v)
    return blend[0], blend[1], mask_ok, inb


def bilinear_sample(img: torch.Tensor, mask, u: torch.Tensor, v: torch.Tensor):
    """Bilinear sample of an (H, W) plane at continuous (u, v).

    valid = in bounds and, when ``mask`` is given, all four corner pixels
    valid. The corners come from one flat gather on the plane's device
    (no host read). Returns (value, valid_f32), each shaped like u."""
    h, w = img.shape
    inb, u0, v0, u1, v1, fu, fv = _corner_weights(u, v, h, w)
    flat_img = img.reshape(-1)
    idx = torch.stack([v0 * w + u0, v0 * w + u1, v1 * w + u0, v1 * w + u1])
    i00, i01, i10, i11 = flat_img[idx]
    val = (
        i00 * (1 - fu) * (1 - fv)
        + i01 * fu * (1 - fv)
        + i10 * (1 - fu) * fv
        + i11 * fu * fv
    )
    ok = inb
    if mask is not None:
        m00, m01, m10, m11 = mask.reshape(-1)[idx]
        ok = ok * m00 * m01 * m10 * m11
    return val, ok
