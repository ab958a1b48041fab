"""Small scenes shared by the march-kernel tests.

Every scene stays at <= 32^2 rays, <= 16^3 voxels and <= 32 steps so the
kernel runs quickly in the Pallas interpreter on the CPU."""

from __future__ import annotations

import functools

import numpy as np

from dvren_tpu import (CameraConfig, CameraModel, DenseGridConfig,
                       DenseGridField, Plan, PlanConfig, Roi, SamplingConfig,
                       SamplingMode)
from dvren_tpu.ops import march


def field(shape=(8, 8, 8), bbox=((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
          scale=8.0, seed=3, blob=False):
    """Dense grid of (nx, ny, nz) = ``shape``: uniform-random or a blob."""
    nx, ny, nz = shape
    rng = np.random.default_rng(seed)
    if blob:
        zs, ys, xs = np.meshgrid(np.linspace(0, 1, nz), np.linspace(0, 1, ny),
                                 np.linspace(0, 1, nx), indexing="ij")
        sigma = scale * np.exp(-((xs - 0.5) ** 2 + (ys - 0.5) ** 2
                                 + (zs - 0.45) ** 2) / 0.06)
        color = np.stack([xs, ys, 1 - zs], -1)
    else:
        sigma = rng.uniform(0.0, scale, (nz, ny, nx))
        color = rng.uniform(0.0, 1.0, (nz, ny, nx, 3))
    return DenseGridField.create(DenseGridConfig(
        resolution=(nx, ny, nz), sigma=sigma.astype(np.float32).reshape(-1),
        color=color.astype(np.float32).reshape(-1),
        bbox_min=bbox[0], bbox_max=bbox[1]))


def plan(width=16, height=12, mode=SamplingMode.STRATIFIED, t_near=0.2,
         t_far=2.2, dt=2.0 / 32, max_steps=32, c2w=None,
         model=CameraModel.PINHOLE, roi=None, ortho_scale=0.0, focal=1.2):
    return Plan.create(PlanConfig(
        width=width, height=height, t_near=t_near, t_far=t_far, seed=11,
        camera=CameraConfig(
            model=model,
            k=(width * focal, 0, width / 2, 0, width * focal, height / 2,
               0, 0, 1),
            c2w=c2w or (1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0),
            ortho_scale=ortho_scale),
        roi=roi or Roi(),
        sampling=SamplingConfig(dt=dt, max_steps=max_steps, mode=mode)))


def lookat(eye, ctr=(0.5, 0.5, 0.5), up=(0, 1, 0)):
    """Camera-to-world (3x4, row-major) looking from ``eye`` at ``ctr``."""
    eye, ctr, up = (np.array(v, float) for v in (eye, ctr, up))
    f = ctr - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, up)
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    return tuple(np.concatenate([np.stack([r, u, f], 1), eye[:, None]],
                                1).reshape(-1))


ORBIT = (lookat((1.6, 0.8, 0.3)), lookat((-0.6, 0.2, 1.3)),
         lookat((0.5, 1.7, 0.45)), lookat((0.5, 0.5, -1.0)))

# Routing with the kernel forced on and run in the interpreter: what a test
# injects through ``march.select_route`` to drive the GPU route on the CPU.
kernel_route = functools.partial(march.select_route, backend="gpu",
                                 interpret=True)


def assert_planes_close(got, want, tol=1e-5, depth_tol=1e-4):
    """Image/T/opacity within ``tol``; depth within ``depth_tol`` except at
    knife-edge pixels whose opacity sits at OPACITY_EPS (depth snaps to
    t_far there, so two correct summation orders may disagree)."""
    from dvren_tpu.ops.integrate import OPACITY_EPS

    for name in ("image", "transmittance", "opacity"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)),
                                   np.asarray(getattr(want, name)),
                                   atol=tol, err_msg=name)
    op = np.asarray(want.opacity)
    edge = np.abs(op - OPACITY_EPS) < 4 * OPACITY_EPS
    np.testing.assert_allclose(np.asarray(got.depth)[~edge],
                               np.asarray(want.depth)[~edge],
                               atol=depth_tol, err_msg="depth")
    np.testing.assert_array_equal(np.asarray(got.hitmask),
                                  np.asarray(want.hitmask))
