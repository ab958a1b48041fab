"""Sample lattice generation: fixed-dt ray marching on a dense (N, K) grid.

Vectorized replacement for ``samp_generate_cpu``
(``hotpath/src/cpu/samp_cpu.cpp:151-313``). The reference emits a ragged,
packed sample stream with per-ray prefix offsets; XLA requires static shapes,
so every ray owns ``max_steps`` slots and a boolean validity mask marks live
samples. The mask is a *prefix* property per ray (step k is live iff
``base_t = t_near + k*dt < t_far``), which downstream integration exploits.

Semantics preserved exactly (same symbols as the reference):

- ``base_t = t_near + step * dt``; live iff ``base_t < t_far`` and
  ``t_far > t_near`` (samp_cpu.cpp:222-229);
- jitter: 0.5 for FIXED, splitmix64(seed, ray, step) for STRATIFIED,
  clamped to [0, 1] (:231-235);
- ``sample_t = base_t + jitter * dt``, nudged to ``nextafter(t_far, t_near)``
  if it lands at/past t_far (:236-239);
- ``dt_actual = min(base_t + dt, t_far) - base_t`` (:240-241);
- positions = origin + direction * sample_t (:250-252).

Capacity overflow (total live samples > plan.max_samples) is a data-dependent
condition; it is checked host-side by the Renderer after the forward
(reference returns INVALID_ARGUMENT inline, samp_cpu.cpp:245-247).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp

from dvren_tpu.core.plan import Plan, SamplingMode
from dvren_tpu.ops.raygen import Rays
from dvren_tpu.ops.rng import stratified_jitter
from dvren_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
@dataclass(frozen=True)
class SampleLattice:
    """Dense sample lattice; the static-shape analogue of ``hp_samp_t``.

    t:          (N, K) float32  sample parameter along each ray
    dt:         (N, K) float32  actual segment length (0 where masked out)
    mask:       (N, K) bool     live-sample mask (prefix-true per ray)
    px, py, pz: (N, K) float32  world positions, structure-of-arrays

    Positions are stored as three coordinate planes, NOT an (N, K, 3)
    array: a minor dimension of 3 makes every consumer stride over it.
    Use :attr:`positions` only at API/parity boundaries.
    """

    t: jnp.ndarray
    dt: jnp.ndarray
    mask: jnp.ndarray
    px: jnp.ndarray
    py: jnp.ndarray
    pz: jnp.ndarray

    @property
    def positions(self) -> jnp.ndarray:
        """(N, K, 3) view for parity APIs; avoid in compiled hot paths."""
        return jnp.stack([self.px, self.py, self.pz], axis=-1)

    @property
    def position_planes(self) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        return (self.px, self.py, self.pz)

    @property
    def num_rays(self) -> int:
        return self.t.shape[0]

    @property
    def max_steps(self) -> int:
        return self.t.shape[1]

    def sample_count(self) -> jnp.ndarray:
        """Total live samples (traced scalar); hp_samp's ragged total M."""
        return jnp.sum(self.mask.astype(jnp.int32))

    def ray_offsets(self) -> jnp.ndarray:
        """(N+1,) prefix offsets over live samples - ``hp_samp_t.ray_offset``
        parity view (hp.h:135). Offsets index the packed stream obtained by
        dropping masked slots in row-major order."""
        per_ray = jnp.sum(self.mask.astype(jnp.int32), axis=1)
        return jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(per_ray, dtype=jnp.int32)])


def generate_samples(plan: Plan, rays: Rays,
                     ray_index_offset: jnp.ndarray | int = 0,
                     jitter: jnp.ndarray | None = None,
                     step_offset: jnp.ndarray | None = None,
                     num_steps: int | None = None) -> SampleLattice:
    """March each ray with fixed dt; returns the dense lattice.

    ``ray_index_offset`` shifts the ray indices fed to the stratified jitter
    hash so a tiled render draws the same jitter as the whole-frame render
    (the reference keys jitter on the global ray index, samp_cpu.cpp:233).

    ``jitter``: optional precomputed (N, K) jitter table (see
    ops.rng.jitter_table) - the production path, keeping the uint64 hash out
    of the compiled program. When omitted under STRATIFIED, the in-graph
    uint32 splitmix emulation is used.

    ``step_offset`` (N,) shifts each ray's first lattice step (the
    window-clipped path): slot j covers global step k = step_offset + j,
    with ``num_steps`` slots per ray (default plan.max_steps). The global
    lattice (base_t grid, jitter keying, max_steps bound) is preserved, so
    outputs for the covered window are identical to the full lattice.
    """
    dt_step = jnp.float32(plan.sampling.dt)
    k_steps = plan.sampling.max_steps if num_steps is None else num_steps
    n = rays.count

    steps = jnp.arange(k_steps, dtype=jnp.int32)
    t_near = rays.t_near[:, None]
    t_far = rays.t_far[:, None]

    if step_offset is not None:
        steps2d = steps[None, :] + step_offset.astype(jnp.int32)[:, None]
    else:
        steps2d = jnp.broadcast_to(steps[None, :], (n, k_steps))
    base_t = t_near + steps2d.astype(jnp.float32) * dt_step
    ray_valid = t_far > t_near
    mask = ((base_t < t_far) & ray_valid
            & (steps2d < plan.sampling.max_steps))

    if jitter is not None:
        jitter = jitter.astype(jnp.float32)
    elif plan.sampling.mode == SamplingMode.STRATIFIED:
        ray_idx = (jnp.arange(n, dtype=jnp.int32)
                   + jnp.asarray(ray_index_offset, jnp.int32))[:, None]
        jitter = stratified_jitter(plan.seed, ray_idx, steps2d)
    else:
        jitter = jnp.full((1, 1), 0.5, dtype=jnp.float32)
    jitter = jnp.clip(jitter, 0.0, 1.0)

    sample_t = base_t + jitter * dt_step
    # Nudge samples that land at/past t_far back inside the segment.
    sample_t = jnp.where(
        sample_t >= t_far, jnp.nextafter(t_far, t_near), sample_t)

    dt_actual = jnp.minimum(base_t + dt_step, t_far) - base_t
    dt_actual = jnp.where(mask, dt_actual, 0.0)

    sample_t = sample_t.astype(jnp.float32)
    o = rays.origins
    d = rays.directions
    px = o[:, 0:1] + d[:, 0:1] * sample_t
    py = o[:, 1:2] + d[:, 1:2] * sample_t
    pz = o[:, 2:3] + d[:, 2:3] * sample_t

    return SampleLattice(
        t=sample_t,
        dt=dt_actual.astype(jnp.float32),
        mask=mask,
        px=px, py=py, pz=pz,
    )
