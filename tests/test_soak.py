"""Reference-scale soak suites.

The reference runs a 120-frame animation (test_smoke_animation.cpp:211) and
a 960x720 high-res render (test_smoke_forward_highres.cpp). Here:

- the animation runs the FULL 120 frames by default (small frame size keeps
  the CPU suite fast; the reference's scale lives in the frame count and
  the per-frame field recreation, test_smoke_animation.cpp:305-331);
- the high-res suite runs 320x240 through the WINDOWED path by default and
  the full 960x720 when DVREN_SOAK=1 (CI nightly; the always-on subset
  oracle covers correctness).
"""

import os

import numpy as np
import pytest

from dvren_tpu import (
    Context, DenseGridConfig, DenseGridField, Renderer, RenderOptions,
)
from tests.test_scenes import (
    make_plan, sphere_shell_volume, subset_oracle_check,
)

SOAK = os.environ.get("DVREN_SOAK", "") not in ("", "0")


def test_animation_120_frames():
    """Full reference frame count: per-frame invariants every frame,
    subset-oracle drift gates on a sampled schedule
    (test_smoke_animation.cpp:475-485 analogue)."""
    plan = make_plan(24, 18, dt=0.0625, max_steps=32)
    renderer = Renderer(Context.create(), plan)
    n = 10
    prev_img = None
    rng_pix = np.random.default_rng(7)
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    color = np.stack([xs, 1 - xs, np.full_like(xs, 0.5)],
                     axis=-1).astype(np.float32)
    frames = 120
    oracle_frames = {0, 29, 59, 89, 119}
    for frame in range(frames):
        t = frame / float(frames)
        cx_t = 0.3 + 0.4 * t
        r2 = (xs - cx_t) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
        sigma = ((8.0 + 2.0 * np.sin(6.28 * t))
                 * np.exp(-r2 / 0.05)).astype(np.float32)
        field = DenseGridField.create(DenseGridConfig(
            resolution=(n, n, n), sigma=sigma.reshape(-1),
            color=color.reshape(-1)))
        fr = renderer.forward(field)
        img = fr.image.reshape(18, 24, 3)
        assert np.isfinite(img).all(), frame
        assert fr.opacity.max() <= 1.0 + 1e-6, frame
        assert fr.transmittance.min() >= -1e-6, frame
        assert fr.opacity.min() >= -1e-6, frame
        if frame in oracle_frames:
            pixels = list(zip(rng_pix.integers(0, 24, 5),
                              rng_pix.integers(0, 18, 5)))
            subset_oracle_check(plan, fr, sigma, color, pixels,
                                img_tol=4e-3)
        if prev_img is not None:
            assert np.abs(img - prev_img).max() > 1e-6, frame
        prev_img = img


@pytest.mark.parametrize("w,h,grid", [
    pytest.param(320, 240, 48, id="320x240"),
    pytest.param(960, 720, 64, id="960x720-soak",
                 marks=pytest.mark.skipif(
                     not SOAK, reason="set DVREN_SOAK=1 for the full-scale "
                     "run")),
])
def test_highres_windowed_subset_oracle(w, h, grid):
    """High-res render through the WINDOWED path vs the independent scalar
    oracle (test_smoke_forward_highres.cpp analogue)."""
    sigma, color = sphere_shell_volume(grid, radius=0.3, width=0.05)
    plan = make_plan(w, h, dt=2.0 / 64, max_steps=64)
    field = DenseGridField.create(DenseGridConfig(
        resolution=sigma.shape[::-1], sigma=sigma.reshape(-1),
        color=color.reshape(-1)))
    r = Renderer(Context.create(), plan, RenderOptions(use_window=True))
    fr = r.forward(field)
    assert "windowed_path" in " ".join(fr.stats.notes)
    img = fr.image.reshape(h, w, 3)
    assert np.isfinite(img).all()
    assert img.std() > 0.01
    assert fr.hitmask.sum() == w * h
    rng = np.random.default_rng(3)
    pixels = list(zip(rng.integers(0, w, 16), rng.integers(0, h, 16)))
    subset_oracle_check(plan, fr, sigma, color, pixels)
