"""The port's offline visualization (``rgbid_tpu_torch/utils/viz.py`` and
``raster.py``) against the JAX package's and OpenCV.

The panels equal the JAX functions bit for bit (the colour tables are
``cv2.applyColorMap``'s, recovered by ``tools/recover_viz_tables.py``);
the plots are the port's own drawing, checked for what they show: the
trajectory's pixels within 1 px of its projected x-z positions, the
keyframe squares, the map's points in their own colours."""

import importlib.util
import os
import time
from pathlib import Path

import cv2
import numpy as np
import pytest

from rgbid_tpu.utils import viz as jviz
from rgbid_tpu_torch.cli import main as cli_main
from rgbid_tpu_torch.utils import raster, viz

REPO = Path(__file__).resolve().parent.parent


def _tool():
    spec = importlib.util.spec_from_file_location(
        "recover_viz_tables", REPO / "tools" / "recover_viz_tables.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, code", [("turbo", cv2.COLORMAP_TURBO), ("jet", cv2.COLORMAP_JET)])
def test_tables_equal_apply_color_map(name, code):
    ramp = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(viz.colormap(name)[ramp], cv2.applyColorMap(ramp, code))


def test_data_files_equal_a_fresh_recovery():
    fresh = _tool().recover(cv2)
    np.testing.assert_array_equal(viz.colormap("turbo"), fresh["turbo"])
    np.testing.assert_array_equal(viz.colormap("jet"), fresh["jet"])
    alpha, advance, origin = raster.glyphs()
    np.testing.assert_array_equal(alpha, fresh["alpha"])
    np.testing.assert_array_equal(advance, fresh["advance"])
    assert origin == tuple(int(v) for v in fresh["origin"])


def _planes(seed, h=60, w=80):
    rng = np.random.default_rng(seed)
    intensity = rng.uniform(-0.2, 1.2, (h, w)).astype(np.float32)
    xi = rng.uniform(0.0, 2.5, (h, w)).astype(np.float32)
    mask = (rng.uniform(size=(h, w)) > 0.3).astype(np.float32)
    return intensity, xi, mask


@pytest.mark.parametrize("masked", [True, False], ids=["mask", "no mask"])
def test_panels_bit_equal_jax(masked):
    intensity, xi, mask = _planes(0)
    m = mask if masked else None
    for a, b in [
        (viz.colorize_inverse_depth(xi, m), jviz.colorize_inverse_depth(xi, m)),
        (viz.colorize_inverse_depth(xi, m, xi_max=1.0), jviz.colorize_inverse_depth(xi, m, 1.0)),
        (viz.residual_image(intensity, intensity * 0.9, m),
         jviz.residual_image(intensity, intensity * 0.9, m)),
        (viz.residual_image(intensity, 1.0 - intensity, m, scale=2.0),
         jviz.residual_image(intensity, 1.0 - intensity, m, scale=2.0)),
    ]:
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(viz.frame_panel(intensity, xi, mask),
                                  jviz.frame_panel(intensity, xi, mask))


def test_panel_png_reads_back_with_cv2(tmp_path):
    intensity, xi, mask = _planes(1)
    panel = viz.frame_panel(intensity, xi, mask, str(tmp_path / "panel.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "panel.png")), panel)
    jviz.frame_panel(intensity, xi, mask, str(tmp_path / "jpanel.png"))
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "jpanel.png")), panel)


# tests/test_viz.py's two cases on the port.


def test_frame_panel_and_colormaps(tmp_path):
    h, w = 60, 80
    rng = np.random.default_rng(0)
    intensity = rng.uniform(0, 1, (h, w)).astype(np.float32)
    xi = rng.uniform(0.1, 1.5, (h, w)).astype(np.float32)
    mask = np.ones((h, w), np.float32)
    mask[:10] = 0
    panel = viz.frame_panel(intensity, xi, mask, str(tmp_path / "panel.png"))
    assert panel.shape == (h, 2 * w, 3)
    assert (tmp_path / "panel.png").exists()
    r = viz.residual_image(intensity, intensity * 0.9, mask)
    assert r.shape == (h, w, 3)
    assert np.all(r[:10] == 0)  # invalid zone blacked out


def _poses():
    poses = []
    for i in range(20):
        T = np.eye(4)
        T[:3, 3] = [np.sin(i / 5), 0.0, i * 0.1]
        poses.append(T)
    return poses


def test_trajectory_and_map_plots(tmp_path):
    poses = _poses()
    viz.plot_trajectory([("est", poses)], str(tmp_path / "traj.png"), keyframe_poses=poses[::5])
    assert (tmp_path / "traj.png").stat().st_size > 5000
    cloud = np.random.default_rng(1).uniform(0, 1, (5000, 6)).astype(np.float32)
    viz.plot_map_topdown(cloud, str(tmp_path / "map.png"))
    assert (tmp_path / "map.png").stat().st_size > 5000
    for f in ("traj.png", "map.png"):
        assert cv2.imread(str(tmp_path / f)).shape == (viz.FIG_PX, viz.FIG_PX, 3)


def test_trajectory_pixels_follow_the_projection():
    """Every vertex of a known trajectory has its colour within 1 px of its
    projected x-z position, the segment midpoints too; each keyframe has a
    filled square of the keyframe colour around it; the tick step is a
    round number and the scale is one for both axes."""
    poses = _poses()
    gt = [np.diag([1.0, 1.0, 1.0, 1.0]) for _ in range(20)]
    for i, T in enumerate(gt):
        T[:3, 3] = [0.5 * np.cos(i / 4), 0.0, 0.08 * i]
    img, ax = viz.trajectory_figure([("est", poses), ("gt", gt)], keyframe_poses=poses[::5])
    for k, traj in enumerate((poses, gt)):
        color = np.array(raster.CYCLE[k], np.uint8)
        xyz = np.array([T[:3, 3] for T in traj])
        pts = np.concatenate([xyz, 0.5 * (xyz[1:] + xyz[:-1])])
        cols, rows = ax.px(pts[:, 0], pts[:, 2])
        kf_cols, kf_rows = ax.px(*np.array([T[:3, 3] for T in poses[::5]])[:, [0, 2]].T)
        for c, r in zip(cols, rows):
            if k == 0 and np.min(np.hypot(kf_cols - c, kf_rows - r)) < 5:
                continue  # under a keyframe square
            ri, ci = int(round(r)), int(round(c))
            win = img[ri - 1:ri + 2, ci - 1:ci + 2].reshape(-1, 3)
            assert (win == color).all(axis=1).any(), (k, c, r)
    for c, r in zip(kf_cols, kf_rows):
        ri, ci = int(round(r)), int(round(c))
        assert (img[ri - 3:ri + 4, ci - 3:ci + 4] == np.array(raster.TAB_RED, np.uint8)).all()
    m = ax.step / 10.0 ** np.floor(np.log10(ax.step))
    assert round(m, 6) in (1.0, 2.0, 2.5, 5.0)
    c0, r0 = ax.px(0.0, 0.0)
    c1, r1 = ax.px(1.0, 1.0)
    assert np.isclose(c1 - c0, r0 - r1)


def test_map_scatter_colours_and_speed():
    """200 000 points (above the cap, so the JAX package's subsample runs)
    draw well under a second; a point drawn last shows its own colour."""
    rng = np.random.default_rng(2)
    cloud = rng.uniform(-1, 1, (250000, 6)).astype(np.float32)
    cloud[:, 3:6] = rng.uniform(0, 1, (250000, 3))
    t0 = time.perf_counter()
    img, ax = viz.map_figure(cloud)
    assert time.perf_counter() - t0 < 1.0
    pts = viz.subsample(cloud, 200000)
    assert len(pts) == 200000
    cols, rows = ax.px(pts[-1:, 0], pts[-1:, 2])
    np.testing.assert_array_equal(img[int(np.rint(rows[0])), int(np.rint(cols[0]))],
                                  viz.cloud_bgr(pts[-1:])[0])


@pytest.mark.parametrize("text", ["frame 12  kf 2  tracking", "frame 7  kf 1  LOST",
                                  "active keyframe 31", "trajectory + map (top-down)"])
def test_label_glyphs_match_put_text(text):
    """The glyph table drawn glyph after glyph on a random background gives
    cv2.putText's pixels for the viewer's labels."""
    rng = np.random.default_rng(len(text))
    bg = rng.integers(0, 256, (30, 260, 3), dtype=np.uint8)
    ref = bg.copy()
    cv2.putText(ref, text, (6, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1,
                cv2.LINE_AA)
    ours = bg.copy()
    raster.text(ours, text, 6, 18, (255, 255, 255))
    np.testing.assert_array_equal(ours, ref)


def test_cli_viz_writes_decodable_plots(tmp_path, capsys):
    out_dir = tmp_path / "run"
    rc = cli_main(["--synthetic", "40", "--max-frames", "6", "--out-dir", str(out_dir), "--viz",
                   "--quiet", "--device", "cpu"])
    assert rc == 0
    for f in ("trajectory.png", "map_topdown.png"):
        img = cv2.imread(str(out_dir / f))
        assert img is not None and img.shape == (viz.FIG_PX, viz.FIG_PX, 3), f
        assert (img != 255).any(), f
    assert os.path.exists(out_dir / "trajectory.txt")
