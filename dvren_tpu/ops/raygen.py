"""Camera ray generation: pinhole and orthographic, ROI-aware, differentiable.

Vectorized replacement for the reference ray kernels
(``hotpath/src/cpu/ray_cpu.cpp:122-229``, ``hotpath/src/cuda/ray_cuda.cu:29-94``):
one vectorized jnp program over the ROI pixel lattice instead of a per-pixel
loop / per-thread kernel. Camera intrinsics and extrinsics enter as traced
arrays so that ``jax.grad`` produces real camera gradients - the reference's
``hp_diff`` camera output is a zero stub (``diff_cpu.cpp:41-47,74``).

Orthographic rays follow the reference's *CUDA* path (ray_cuda.cu:75-84),
which offsets the origin in the camera plane by ``ortho_scale``; the CPU
path's ortho (all rays identical, ray_cpu.cpp:195-199) is a documented
reference quirk we deliberately do not replicate (SURVEY.md section 7,
"known quirks").
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp

from dvren_tpu.core.plan import CameraModel, Plan
from dvren_tpu.utils.pytree import pytree_dataclass

_FLT_MIN = 1.1754943508222875e-38  # std::numeric_limits<float>::min()


@pytree_dataclass
@dataclass(frozen=True)
class Rays:
    """Ray bundle; mirrors ``hp_rays_t`` (hp.h:124-130). All shapes static.

    origins/directions: (N, 3) float32; t_near/t_far: (N,) float32;
    pixel_ids: (N,) int32 with pixel_id = py * width + px.
    """

    origins: jnp.ndarray
    directions: jnp.ndarray
    t_near: jnp.ndarray
    t_far: jnp.ndarray
    pixel_ids: jnp.ndarray

    @property
    def count(self) -> int:
        return self.origins.shape[0]


def camera_arrays(plan: Plan) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Materialize the plan's static camera parameters as traced arrays."""
    k = jnp.asarray(plan.camera.k, dtype=jnp.float32).reshape(3, 3)
    c2w = jnp.asarray(plan.camera.c2w, dtype=jnp.float32).reshape(3, 4)
    ortho_scale = jnp.asarray(plan.camera.ortho_scale, dtype=jnp.float32)
    return k, c2w, ortho_scale


def generate_rays(
    plan: Plan,
    k: jnp.ndarray | None = None,
    c2w: jnp.ndarray | None = None,
    ortho_scale: jnp.ndarray | None = None,
    start: jnp.ndarray | int = 0,
    count: int | None = None,
    ids: jnp.ndarray | None = None,
) -> Rays:
    """Generate rays for ROI pixels, row-major over (roi.height, roi.width).

    ``k`` (3,3), ``c2w`` (3,4) and ``ortho_scale`` default to the plan's
    static camera but may be traced arrays (e.g. under ``jax.grad`` for pose /
    focal refinement). The plan supplies all static facts (shapes, model).

    ``start``/``count`` select a contiguous ray block (for the tiled
    streaming path): ``count`` is static, ``start`` may be traced. Block
    entries past the ROI are emitted as degenerate padding rays
    (t_far == t_near so they produce no samples; pixel_id == width*height so
    the compose scatter drops them).

    ``ids`` (int32 array of global ray indices) overrides start/count for
    permuted generation (the window-clipped path renders rays in
    window-length order).
    """
    if k is None or c2w is None or ortho_scale is None:
        dk, dc2w, ds = camera_arrays(plan)
        k = dk if k is None else k
        c2w = dc2w if c2w is None else c2w
        ortho_scale = ds if ortho_scale is None else ortho_scale
    k = jnp.asarray(k, jnp.float32).reshape(3, 3)
    c2w = jnp.asarray(c2w, jnp.float32).reshape(3, 4)

    roi = plan.roi
    if ids is not None:
        global_idx = ids.astype(jnp.int32)
        n = ids.shape[0]
    else:
        n = plan.ray_count if count is None else count
        global_idx = (jnp.arange(n, dtype=jnp.int32)
                      + jnp.asarray(start, jnp.int32))
    in_roi = global_idx < plan.ray_count
    local = jnp.minimum(global_idx, plan.ray_count - 1)
    local_x = local % roi.width
    local_y = local // roi.width
    px = (roi.x + local_x).astype(jnp.float32)
    py = (roi.y + local_y).astype(jnp.float32)

    fx, fy = k[0, 0], k[1, 1]
    cx, cy = k[0, 2], k[1, 2]
    rot = c2w[:, :3]
    trans = c2w[:, 3]

    # The 3x3 rotation is applied with explicit component math: a (N,3)x(3,3)
    # matmul would route through the dot default precision (TF32 on the
    # GPU), and camera math must stay full float32.
    if plan.camera.model == CameraModel.PINHOLE:
        # Pixel-center convention (+0.5), ray_cpu.cpp:189-193.
        u = px + 0.5
        v = py + 0.5
        a = (u - cx) / fx
        b = (v - cy) / fy
        dir_world = jnp.stack(
            [rot[0, 0] * a + rot[0, 1] * b + rot[0, 2],
             rot[1, 0] * a + rot[1, 1] * b + rot[1, 2],
             rot[2, 0] * a + rot[2, 1] * b + rot[2, 2]], axis=-1)
        origins = jnp.broadcast_to(trans, (n, 3))
    else:
        # Orthographic: parallel rays along the camera +z axis; origin offset
        # in the camera plane by ortho_scale (ray_cuda.cu:75-84; no +0.5).
        dir_world = jnp.broadcast_to(rot[:, 2], (n, 3))
        u = (px - cx) / fx * ortho_scale
        v = (py - cy) / fy * ortho_scale
        origins = trans + jnp.stack(
            [rot[0, 0] * u + rot[0, 1] * v,
             rot[1, 0] * u + rot[1, 1] * v,
             rot[2, 0] * u + rot[2, 1] * v], axis=-1)

    len_sq = jnp.sum(dir_world * dir_world, axis=-1, keepdims=True)
    inv_len = jax_rsqrt(jnp.maximum(len_sq, _FLT_MIN))
    directions = dir_world * inv_len

    t_near = jnp.full((n,), plan.t_near, dtype=jnp.float32)
    # padding rays: t_far == t_near -> zero samples (samp_cpu.cpp:222-224)
    t_far = jnp.where(in_roi, jnp.float32(plan.t_far),
                      jnp.float32(plan.t_near))
    pixel_ids = (roi.y + local_y) * plan.width + (roi.x + local_x)
    # Padding rays scatter out of range and are dropped by the compose;
    # ids stay distinct so the unique_indices contract holds.
    pad_ids = plan.width * plan.height + (global_idx - plan.ray_count)
    pixel_ids = jnp.where(in_roi, pixel_ids, pad_ids)

    return Rays(
        origins=origins.astype(jnp.float32),
        directions=directions.astype(jnp.float32),
        t_near=t_near,
        t_far=t_far,
        pixel_ids=pixel_ids.astype(jnp.int32),
    )


def jax_rsqrt(x):
    return 1.0 / jnp.sqrt(x)


def validate_override(plan: Plan, rays: Rays) -> Rays:
    """Validate a caller-supplied ray bundle (the hp_ray override path,
    ray_cpu.cpp:148-150): shapes must be (N<=max_rays, ...) and consistent."""
    n = rays.origins.shape[0]
    if rays.origins.shape != (n, 3) or rays.directions.shape != (n, 3):
        raise ValueError("override rays origins/directions must be (N, 3)")
    if rays.t_near.shape != (n,) or rays.t_far.shape != (n,):
        raise ValueError("override rays t_near/t_far must be (N,)")
    if rays.pixel_ids.shape != (n,):
        raise ValueError("override rays pixel_ids must be (N,)")
    if n > plan.max_rays:
        raise ValueError(f"override ray count {n} exceeds max_rays "
                         f"{plan.max_rays}")
    return rays
