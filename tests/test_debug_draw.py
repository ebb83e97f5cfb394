"""Debug rasterizers (utils/debug_draw.py; main.scm:575-608)."""

import numpy as np

from scheme_raytrace.utils import debug_draw


# the reference's *bez* test curve (main.scm:575-581), frame-scale coords
CP = np.array([[10, 10, 0], [30, 100, 0], [160, 180, 0], [180, 100, 0]],
              float)


def test_draw_bezier_plots_curve():
    img = np.zeros((200, 200, 3), np.uint8)
    debug_draw.draw_bezier(img, CP, color=(255, 0, 0))
    ys, xs = np.nonzero(img[..., 0])
    assert len(xs) > 30                       # many distinct curve pixels
    # endpoints (center-offset by 100): p(0)=(10,10) -> (110,110)
    assert img[110, 110, 0] == 255
    # the curve stays red-channel-only
    assert img[..., 1].max() == 0 and img[..., 2].max() == 0


def test_draw_tan_vec_plots_ray():
    img = np.zeros((200, 200, 3), np.uint8)
    debug_draw.draw_tan_vec(img, CP, t=0.0, color=(0, 255, 0), length=30.0)
    ys, xs = np.nonzero(img[..., 1])
    assert len(xs) >= 5                       # steep tangent leaves frame
    # tangent at t=0 points along 3*(p1-p0) = (60, 270, 0): the plotted
    # ray from p(0)=(10,10) must move up-right
    assert ys.max() > ys.min() and xs.max() >= xs.min()
    assert img[10, 10, 1] == 255              # ray origin (no center offset)


def test_out_of_bounds_points_dropped():
    img = np.zeros((32, 32, 3), np.uint8)
    debug_draw.draw_bezier(img, CP)           # curve mostly outside 32x32
    assert img.shape == (32, 32, 3)           # no wrap/corruption, no raise
