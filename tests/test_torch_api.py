"""The port's counterparts of the JAX package's remaining public functions,
on the CPU, against the JAX package on identical inputs.

Every input is made with numpy from a seed. Bit-equal where both sides do
the same float32 operations in the same order (``identity``, ``from_rt``,
``pixel_grid``, ``unpack_frame``'s values, ``optimized_poses``,
``extract_cloud``, which is host numpy in both); atol 1e-6 for the se3 and
camera functions (float32 rounding; a value above 1 also within 1e-6
relative); ``bilinear_sample`` atol 1e-5 with ``ok`` equal, as
``tests/test_device_ops.py`` holds the JAX one to the numpy oracle;
``build_pyramids_multi`` 1e-6 (5-tap sums in another order) with masks
equal. Then the JAX package's own checks of these functions, on the port.
"""

import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rgbid_tpu.backend.loop_closure import BackendThread as JBackendThread
from rgbid_tpu.core import camera as jcamera
from rgbid_tpu.core import se3 as jse3
from rgbid_tpu.mapping.keyframe import extract_cloud as j_extract_cloud
from rgbid_tpu.ops import image as jimage
from rgbid_tpu.ops import warp as jwarp
from rgbid_tpu.tracking.step import unpack_frame as j_unpack_frame
from rgbid_tpu_torch.backend.loop_closure import BackendThread as TBackendThread
from rgbid_tpu_torch.core import camera as tcamera
from rgbid_tpu_torch.core import se3 as tse3
from rgbid_tpu_torch.eval import metrics as tmetrics
from rgbid_tpu_torch.mapping.keyframe import extract_cloud as t_extract_cloud
from rgbid_tpu_torch.ops import image as timage
from rgbid_tpu_torch.ops import warp as twarp
from rgbid_tpu_torch.reference_cpu import odometry as todo
from rgbid_tpu_torch.tracking.step import pack_frame, unpack_frame

torch.set_num_threads(2)

H, W = 45, 61  # odd: the pyramid's and the sampler's edges
INTR = tcamera.Intrinsics(fx=58.0, fy=59.5, cx=30.2, cy=21.7, width=W, height=H)
JINTR = jcamera.Intrinsics(*INTR)
TOL = dict(rtol=1e-6, atol=1e-6)


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _rot(axis, angle) -> np.ndarray:
    """float32 rotation matrix (Rodrigues, in float64)."""
    k = np.asarray(axis, np.float64)
    k = k / np.linalg.norm(k)
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K).astype(np.float32)


# Each of Shepperd's four pivots the largest, an exact tie between two
# (the first wins in both), and rotations near pi.
ROTATIONS = {
    "pivot_w": _rot([0.3, -0.5, 0.8], 0.4),
    "pivot_x": _rot([1.0, 0.1, -0.2], 2.6),
    "pivot_y": _rot([0.1, 1.0, 0.15], 2.5),
    "pivot_z": _rot([-0.2, 0.1, 1.0], 2.7),
    "tie_w_x": np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]], np.float32),
    "near_pi_x": _rot([1.0, 0.02, 0.01], np.pi - 1e-3),
    "near_pi_skew": _rot([0.4, -0.7, 0.6], np.pi - 2e-3),
    "near_pi_neg": _rot([0.1, 0.3, -1.0], -(np.pi - 5e-4)),
    "identity": np.eye(3, dtype=np.float32),
}


def random_twists(n, scale_t=1.0, scale_r=1.0, seed=0):
    """``tests/test_se3.py``'s twists."""
    r = np.random.default_rng(seed)
    v = r.normal(size=(n, 3)) * scale_t
    w = r.normal(size=(n, 3)) * scale_r
    return np.concatenate([v, w], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# core/se3.py


def test_identity_and_from_rt_bit_equal():
    np.testing.assert_array_equal(_np(tse3.identity()), np.asarray(jse3.identity()))
    assert tse3.identity().dtype == torch.float32
    np.testing.assert_array_equal(_np(tse3.identity(torch.float64)), np.eye(4))
    rng = np.random.default_rng(0)
    for R in ROTATIONS.values():
        t = rng.normal(size=3).astype(np.float32)
        expected = np.asarray(jse3.from_rt(jnp.asarray(R), jnp.asarray(t)))
        np.testing.assert_array_equal(_np(tse3.from_rt(_t(R), _t(t))), expected)


@pytest.mark.parametrize("shape", [(11, 3), (2, 5, 3)])
def test_transform_points_matches_jax(shape):
    rng = np.random.default_rng(1)
    T = np.asarray(jse3.exp(jnp.asarray(random_twists(1, seed=7)[0])))
    pts = rng.normal(size=shape).astype(np.float32)
    out = _np(tse3.transform_points(_t(T), _t(pts)))
    assert out.shape == shape
    expected = np.asarray(jse3.transform_points(jnp.asarray(T), jnp.asarray(pts)))
    np.testing.assert_allclose(out, expected, **TOL)


@pytest.mark.parametrize("name", list(ROTATIONS))
def test_quaternions_match_jax(name):
    R = ROTATIONS[name]
    qt = _np(tse3.to_quaternion(_t(R)))
    qj = np.asarray(jse3.to_quaternion(jnp.asarray(R)))
    np.testing.assert_allclose(qt, qj, **TOL)
    assert qt[3] >= 0
    np.testing.assert_allclose(_np(tse3.from_quaternion(_t(qj))),
                               np.asarray(jse3.from_quaternion(jnp.asarray(qj))), **TOL)
    # An unnormalized quaternion and the zero quaternion (s = 0).
    for q in (3.0 * qj, np.zeros(4, np.float32)):
        np.testing.assert_allclose(_np(tse3.from_quaternion(_t(q))),
                                   np.asarray(jse3.from_quaternion(jnp.asarray(q))), **TOL)


def test_quaternion_roundtrip():
    """``tests/test_se3.py::test_quaternion_roundtrip`` on the port."""
    for d in random_twists(20, seed=6):
        T = tse3.exp(_t(d))
        q = tse3.to_quaternion(T[:3, :3])
        np.testing.assert_allclose(_np(tse3.from_quaternion(q)), _np(T[:3, :3]), atol=1e-5)
        assert np.linalg.norm(_np(q)) == pytest.approx(1.0, abs=1e-6)


def test_transform_points():
    """``tests/test_se3.py::test_transform_points`` on the port."""
    T = tse3.exp(_t(random_twists(1, seed=7)[0]))
    pts = np.random.default_rng(8).normal(size=(11, 3)).astype(np.float32)
    expected = pts @ _np(T[:3, :3]).T + _np(T[:3, 3])
    np.testing.assert_allclose(_np(tse3.transform_points(T, _t(pts))), expected, atol=1e-5)


def test_exp_gradient_finite_at_zero():
    """``tests/test_se3.py::test_jit_and_grad_safe``'s gradient, by autograd."""
    d = torch.zeros(6, requires_grad=True)
    torch.sum(tse3.exp(d)).backward()
    assert torch.isfinite(d.grad).all()


def _random_traj(n, seed=0):
    """``tests/test_eval.py``'s trajectory."""
    r = np.random.default_rng(seed)
    poses = [np.eye(4)]
    for _ in range(n - 1):
        d = r.normal(scale=[0.05, 0.05, 0.05, 0.01, 0.01, 0.01])
        T = np.eye(4)
        th = np.linalg.norm(d[3:])
        if th > 0:
            k = d[3:] / th
            K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
            T[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        T[:3, 3] = d[:3]
        poses.append(poses[-1] @ T)
    return poses


def test_tum_row_roundtrip():
    """``tests/test_eval.py::test_tum_row_roundtrip`` through the port's
    ``to_quaternion`` and ``trajectory_from_tum_rows``."""
    gt = _random_traj(5, seed=5)
    rows = []
    for i, T in enumerate(gt):
        q = _np(tse3.to_quaternion(torch.tensor(T[:3, :3], dtype=torch.float32)))
        rows.append([float(i), *T[:3, 3], *q])
    _, poses = tmetrics.trajectory_from_tum_rows(np.array(rows))
    for T, P in zip(gt, poses):
        np.testing.assert_allclose(P, T, atol=1e-6)


# ---------------------------------------------------------------------------
# core/camera.py and ops/warp.py


def test_pixel_grid_bit_equal():
    for tu, ju in zip(tcamera.pixel_grid(H, W), jcamera.pixel_grid(H, W)):
        np.testing.assert_array_equal(_np(tu), np.asarray(ju))
    for tu, ju in zip(twarp.pixel_grid(H, W), jwarp.pixel_grid(H, W)):
        np.testing.assert_array_equal(_np(tu), np.asarray(ju))
    assert twarp.pixel_grid is tcamera.pixel_grid
    assert tcamera.pixel_grid(3, 4, torch.float64)[0].dtype == torch.float64


def test_backproject_and_project_match_jax():
    rng = np.random.default_rng(2)
    u = rng.uniform(-3, W + 3, (H, W)).astype(np.float32)
    v = rng.uniform(-3, H + 3, (H, W)).astype(np.float32)
    xi = rng.uniform(0.1, 3.0, (H, W)).astype(np.float32)
    xi[rng.random((H, W)) < 0.1] = 0.0  # clamped to 1e-8
    xt, yt, zt = tcamera.backproject(_t(u), _t(v), _t(xi), INTR)
    xj, yj, zj = jcamera.backproject(jnp.asarray(u), jnp.asarray(v), jnp.asarray(xi), JINTR)
    for a, b in zip((xt, yt, zt), (xj, yj, zj)):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)
    pts = rng.normal(size=(3, H, W)).astype(np.float32)
    pts[2] = np.abs(pts[2]) + 0.2
    pts[2, :3] = 0.0  # behind the clamp
    pts[2, 3:5] = -1.0
    outs_t = tcamera.project(_t(pts[0]), _t(pts[1]), _t(pts[2]), INTR)
    outs_j = jcamera.project(*(jnp.asarray(p) for p in pts), JINTR)
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(_np(a), np.asarray(b), **TOL)


def _sample_inputs(seed=0):
    """A smooth plane with mask holes, and (u, v) in [-5, W + 5] x [-5, H + 5]
    (as ``tests/test_device_ops.py::test_bilinear_sample_matches``)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W]
    img = (0.5 + 0.3 * np.sin(xx / 4.0) * np.cos(yy / 6.0)).astype(np.float32)
    mask = rng.random((H, W)) > 0.15
    mask[10:18, 20:33] = False
    u = rng.uniform(-5, W + 5, size=(40, 70)).astype(np.float32)
    v = rng.uniform(-5, H + 5, size=(40, 70)).astype(np.float32)
    u[0, :5] = [0.0, W - 1.001, W - 1.0, -1e-6, 3.0]  # the bounds' edges
    v[0, :5] = [0.0, H - 1.001, 2.0, 2.0, H - 1.0]
    return img, mask, u, v


@pytest.mark.parametrize("with_mask", [True, False])
def test_bilinear_sample_matches_jax_and_oracle(with_mask):
    img, mask, u, v = _sample_inputs()
    m = mask.astype(np.float32) if with_mask else None
    vt, okt = twarp.bilinear_sample(_t(img), None if m is None else _t(m), _t(u), _t(v))
    vj, okj = jwarp.bilinear_sample(jnp.asarray(img), None if m is None else jnp.asarray(m),
                                    jnp.asarray(u), jnp.asarray(v))
    assert vt.shape == u.shape and okt.dtype == torch.float32
    np.testing.assert_array_equal(_np(okt), np.asarray(okj))
    np.testing.assert_allclose(_np(vt), np.asarray(vj), atol=1e-5)
    ref_val, ref_ok = todo.bilinear_sample(img, mask if with_mask else np.ones_like(mask), u, v)
    np.testing.assert_array_equal(_np(okt) > 0.5, ref_ok)
    np.testing.assert_allclose(_np(vt)[ref_ok], ref_val[ref_ok], atol=1e-5)


# ---------------------------------------------------------------------------
# ops/image.py


def test_build_pyramids_multi_matches_jax_and_per_plane():
    rng = np.random.default_rng(3)
    img, mask, _, _ = _sample_inputs(1)
    xi = rng.uniform(0.2, 2.0, (H, W)).astype(np.float32)
    xmask = (rng.random((H, W)) > 0.2).astype(np.float32)
    imgs, masks = [img, xi], [mask.astype(np.float32), xmask]
    pt, mt = timage.build_pyramids_multi([_t(a) for a in imgs], [_t(a) for a in masks], 4)
    pj, mj = jimage.build_pyramids_multi([jnp.asarray(a) for a in imgs],
                                         [jnp.asarray(a) for a in masks], 4)
    for p in range(2):
        one_i, one_m = timage.build_pyramid(_t(imgs[p]), _t(masks[p]), 4)
        for lv in range(4):
            np.testing.assert_allclose(_np(pt[p][lv]), np.asarray(pj[p][lv]), atol=1e-6)
            np.testing.assert_array_equal(_np(mt[p][lv]), np.asarray(mj[p][lv]))
            np.testing.assert_allclose(_np(pt[p][lv]), _np(one_i[lv]), atol=1e-6)
            np.testing.assert_array_equal(_np(mt[p][lv]), _np(one_m[lv]))
    outs, out_masks = timage.downsample_multi([_t(a) for a in imgs], [_t(a) for a in masks], 0.5)
    jo, jm = jimage.downsample_multi([jnp.asarray(a) for a in imgs],
                                     [jnp.asarray(a) for a in masks], 0.5)
    for a, b, c, d in zip(outs, jo, out_masks, jm):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)
        np.testing.assert_array_equal(_np(c), np.asarray(d))


# ---------------------------------------------------------------------------
# tracking/step.py


def test_unpack_frame_values_equal_jax():
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    depth = rng.integers(0, 65536, (H, W), dtype=np.uint16)
    depth[0, :3] = [0, 65535, 256]
    packed = pack_frame(rgb, depth)
    gt, dt = unpack_frame(torch.from_numpy(packed))
    gj, dj = j_unpack_frame(jnp.asarray(packed))
    assert gt.dtype == torch.uint8 and dt.dtype == torch.int32
    np.testing.assert_array_equal(_np(gt), np.asarray(gj))
    np.testing.assert_array_equal(_np(dt), np.asarray(dj).astype(np.int32))
    np.testing.assert_array_equal(_np(dt), depth.astype(np.int32))


# ---------------------------------------------------------------------------
# backend/loop_closure.py


def test_optimized_poses_copy_under_lock():
    """Both packages' method on the same state: an equal copy, taken under
    the lock, that neither aliases nor consumes the pending poses."""
    rng = np.random.default_rng(5)
    poses = {k: rng.normal(size=(4, 4)) for k in (0, 3, 7)}
    outs = []
    for cls in (JBackendThread, TBackendThread):
        state = types.SimpleNamespace(_lock=threading.Lock(), _optimized=dict(poses))
        out = cls.optimized_poses(state)
        assert out == state._optimized and out is not state._optimized
        out.clear()
        assert len(state._optimized) == 3
        with state._lock:  # held: the method must wait for it
            t = threading.Thread(target=lambda s=state: outs.append(cls.optimized_poses(s)))
            t.start()
            t.join(0.05)
            assert t.is_alive()
        t.join()
    for k in poses:
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


# ---------------------------------------------------------------------------
# mapping/keyframe.py


def _cloud_inputs(seed=6, h=H, w=W):
    rng = np.random.default_rng(seed)
    xi = rng.uniform(0.1, 2.0, (h, w)).astype(np.float32)
    xi[rng.random((h, w)) < 0.1] = 0.0
    mask = rng.random((h, w)) > 0.2
    var = rng.uniform(-1e-4, 4e-3, (h, w)).astype(np.float32)  # some sigma >= 0.05
    inten = rng.uniform(-0.1, 1.1, (h, w)).astype(np.float32)  # clipped to [0, 1]
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return inten, xi, mask, var, rgb


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("with_rgb", [True, False])
def test_extract_cloud_matches_jax(stride, with_rgb):
    inten, xi, mask, var, rgb = _cloud_inputs()
    rgb_arg = rgb if with_rgb else None
    ct = t_extract_cloud(inten, xi, mask, var, INTR, 0.05, stride, rgb_arg)
    cj = j_extract_cloud(inten, xi, mask, var, JINTR, 0.05, stride, rgb_arg)
    assert ct.shape[1] == 6 and len(ct) > 100
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("with_rgb", [True, False])
def test_extract_cloud_grid_step_matches_jax(with_rgb):
    """Planes pre-strided by 2 (the finalize's read) against the JAX
    function, and against ``stride`` 2 on the full planes."""
    inten, xi, mask, var, rgb = _cloud_inputs(7)
    s = 2
    kw = dict(max_sigma=0.05, stride=1, grid_step=s,
              rgb=rgb[::s, ::s] if with_rgb else None)
    ct = t_extract_cloud(inten[::s, ::s], xi[::s, ::s], mask[::s, ::s], var[::s, ::s], INTR, **kw)
    cj = j_extract_cloud(inten[::s, ::s], xi[::s, ::s], mask[::s, ::s], var[::s, ::s], JINTR, **kw)
    np.testing.assert_array_equal(ct, cj)
    full = t_extract_cloud(inten, xi, mask, var, INTR, stride=s, rgb=rgb if with_rgb else None)
    np.testing.assert_array_equal(ct, full)


def _extract_cloud_before(xi0, mask0, var0, rgb, intr, max_sigma=0.05, grid_step=1):
    """The port's ``extract_cloud`` before it took the JAX signature: the
    (H, W, 3) or gray (H, W) u8 image, pre-strided planes."""
    h, w = xi0.shape
    u, v = np.meshgrid(np.arange(w, dtype=np.float32) * grid_step,
                       np.arange(h, dtype=np.float32) * grid_step)
    keep = (mask0 > 0) & (np.sqrt(np.maximum(var0, 0.0)) < max_sigma) & (xi0 > 1e-6)
    z = 1.0 / np.maximum(xi0, 1e-6)
    x = (u - intr.cx) / intr.fx * z
    y = (v - intr.cy) / intr.fy * z
    c = rgb.astype(np.float32) * (1.0 / 255.0)
    if c.ndim == 2:
        c = np.repeat(c[..., None], 3, axis=-1)
    return np.stack([x[keep], y[keep], z[keep], c[..., 0][keep], c[..., 1][keep],
                     c[..., 2][keep]], axis=1).astype(np.float32)


@pytest.mark.parametrize("gray", [False, True])
def test_extract_cloud_finalize_form_keeps_its_bits(gray):
    """``KeyframeManager.finalize``'s call in the new form (a gray founding
    image as ``intensity0``, an RGB one as ``rgb``) against the old form:
    every keyframe cloud bit-equal."""
    _, xi, mask, var, rgb = _cloud_inputs(8)
    s = 2
    img = (rgb[..., 1] if gray else rgb)[::s, ::s]
    new = t_extract_cloud(img.astype(np.float32) * (1.0 / 255.0) if gray else None,
                          xi[::s, ::s], mask[::s, ::s], var[::s, ::s], INTR,
                          max_sigma=0.05, rgb=None if gray else img, grid_step=s)
    old = _extract_cloud_before(xi[::s, ::s], mask[::s, ::s], var[::s, ::s], img, INTR,
                                max_sigma=0.05, grid_step=s)
    np.testing.assert_array_equal(new, old)
