"""Image composition: scatter per-ray results into image planes.

Vectorized replacement for ``img_generate_cpu``
(``hotpath/src/cpu/img_cpu.cpp:110-188``). The reference walks rays in order
with first-write / accumulate semantics per pixel:

    first ray:  image = radiance, T = T_ray, opacity = o_ray, depth = d_ray
    later rays: image += radiance, T *= T_ray, opacity = 1 - T,
                depth = min(depth, d_ray)

Because those updates are order-independent reductions, the whole pass
collapses to segment reductions keyed by pixel_id (sum / product / min),
which XLA lowers to scatters (atomics on the GPU):

    image   = segment_sum(radiance)
    T       = segment_prod(T_ray)                (hit pixels)
    opacity = 1 - T                              (hit pixels; single-ray
              pixels give exactly the per-ray opacity, matching first-write)
    depth   = segment_min(depth_ray)             (hit pixels)
    hitmask = any ray landed

Background (img_cpu.cpp:154-159): image 0, T 1, opacity 0, depth t_far.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

from dvren_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
@dataclass(frozen=True)
class ImagePlanes:
    """Mirrors ``hp_img_t`` (hp.h:148-154)."""

    image: jnp.ndarray        # (H, W, 3)
    transmittance: jnp.ndarray  # (H, W)
    opacity: jnp.ndarray      # (H, W)
    depth: jnp.ndarray        # (H, W)
    hitmask: jnp.ndarray      # (H, W) int32


def compose(
    pixel_ids: jnp.ndarray,
    radiance: jnp.ndarray,
    transmittance: jnp.ndarray,
    opacity: jnp.ndarray,
    depth: jnp.ndarray,
    width: int,
    height: int,
    t_far: float,
    unique_pixels: bool = True,
) -> ImagePlanes:
    """``unique_pixels=True`` (each ray owns its pixel - always the case for
    generated rays, whose ids enumerate the ROI) unlocks gradients through
    the product/min scatters; override bundles with colliding ids must pass
    False and lose those gradients (the reference has none at all)."""
    num_pixels = width * height
    pid = pixel_ids.astype(jnp.int32)

    image = jax.ops.segment_sum(radiance, pid, num_segments=num_pixels)
    counts = jax.ops.segment_sum(
        jnp.ones_like(transmittance), pid, num_segments=num_pixels)
    hit = counts > 0

    trans = jax.ops.segment_prod(transmittance, pid, num_segments=num_pixels,
                                 unique_indices=unique_pixels)
    trans = jnp.where(hit, trans, 1.0)

    # Single-ray pixels must reproduce the per-ray opacity exactly
    # (first-write semantics); multi-ray pixels use 1 - accumulated T
    # (img_cpu.cpp:169-183). Both equal 1 - prod(T) up to the per-ray
    # opacity's own rounding, so scatter the per-ray value for singles.
    opac_sum = jax.ops.segment_sum(opacity, pid, num_segments=num_pixels)
    opac = jnp.where(counts > 1, 1.0 - trans, jnp.where(hit, opac_sum, 0.0))

    dep = jax.ops.segment_min(depth, pid, num_segments=num_pixels,
                              unique_indices=unique_pixels)
    dep = jnp.where(hit, dep, t_far)

    return ImagePlanes(
        image=image.reshape(height, width, 3),
        transmittance=trans.reshape(height, width),
        opacity=opac.reshape(height, width),
        depth=dep.reshape(height, width),
        hitmask=hit.astype(jnp.int32).reshape(height, width),
    )
