"""Pure functional render pipeline: the jittable core of the framework.

The staged pipeline mirrors the reference call sequence
``hp_ray -> hp_samp -> hp_int -> hp_img`` (SURVEY.md section 3.1); the fused
entry is one composed function - under ``jax.jit`` XLA fuses ray generation,
sampling, field gathers and the integration cumprod into a single executable,
the plain-JAX equivalent of ``hp_samp_int_fused`` + CUDA Graph replay
(``hotpath/src/cuda/graph_cuda.cu``). Both paths compute identical values by
construction (the reference proves the same with a bitwise staged-vs-fused
test, hp_runner.cpp:1737-1760; here the fused path literally composes the
staged functions and the parity test guards against regressions).

Everything here is differentiable; training code calls :func:`render` inside
a loss and lets ``jax.grad`` flow into field parameters and camera inputs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp

from dvren_tpu.core.plan import Plan
from dvren_tpu.ops.compose import ImagePlanes, compose
from dvren_tpu.ops.integrate import Integration, integrate
from dvren_tpu.ops.raygen import Rays, generate_rays
from dvren_tpu.ops.sampling import SampleLattice, generate_samples
from dvren_tpu.utils.pytree import pytree_dataclass


@pytree_dataclass
@dataclass(frozen=True)
class RenderOutputs:
    """Everything a forward pass produces (device arrays).

    ``color`` is a tuple of three (N, K) planes (SoA; see
    ops/sampling.SampleLattice for the layout rationale)."""

    rays: Rays
    lattice: SampleLattice
    sigma: jnp.ndarray                      # (N, K)
    color: tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]
    intl: Integration
    planes: ImagePlanes


def eval_fields(field, lattice: SampleLattice):
    """Field evaluation at all live lattice positions (SoA planes).

    The reference evaluates fields inside the sampling loop
    (samp_cpu.cpp:255-289); here it is one batched evaluation that XLA fuses
    with its consumers. Fields exposing the packed-stencil fast path (dense
    trilinear grids) evaluate sigma + color with one gather per sample.
    Masked slots are forced to zero so downstream math never sees garbage
    from positions beyond t_far.
    """
    px, py, pz = lattice.position_planes
    if getattr(field, "supports_packed_eval", False):
        sigma, cr, cg, cb = field.packed_eval_planes(px, py, pz)
    else:
        sigma = field.sigma_at_planes(px, py, pz)
        cr, cg, cb = field.color_at_planes(px, py, pz)
    maskf = lattice.mask.astype(sigma.dtype)
    return sigma * maskf, (cr * maskf, cg * maskf, cb * maskf)


def plan_jitter_table(plan: Plan):
    """Host-precomputed stratified jitter for a plan (None for FIXED mode).

    Exact uint64 splitmix64 (ops.rng.jitter_table); pass the result (or a
    device_put of it) into :func:`render`/:func:`render_streamed` so the
    compiled program stays free of the uint32 hash emulation.

    Cached on (seed, rays, steps): the table is camera-INDEPENDENT, so a
    moving-camera sweep rebuilding per-frame schedules reuses it (it was
    3.6 of the 4.9 s hash-schedule rebuild at 512^2). The cached array
    is read-only; copy before mutating.
    """
    from dvren_tpu.core.plan import SamplingMode

    if plan.sampling.mode != SamplingMode.STRATIFIED:
        return None
    return _jitter_table_cached(plan.seed, plan.ray_count,
                                plan.sampling.max_steps)


@functools.lru_cache(maxsize=2)
def _jitter_table_cached(seed: int, n_rays: int, n_steps: int):
    from dvren_tpu.ops import rng

    table = rng.jitter_table(seed, n_rays, n_steps)
    table.setflags(write=False)
    return table


def render(
    plan: Plan,
    field,
    k: jnp.ndarray | None = None,
    c2w: jnp.ndarray | None = None,
    ortho_scale: jnp.ndarray | None = None,
    rays: Rays | None = None,
    jitter: jnp.ndarray | None = None,
) -> RenderOutputs:
    """Full forward: raygen -> sampling -> field eval -> integrate -> compose.

    ``rays`` overrides generation (the hp_ray override path,
    ray_cpu.cpp:148-150). Camera arrays default to the plan's static camera.
    ``jitter``: optional precomputed table from :func:`plan_jitter_table`.
    """
    unique_pixels = rays is None  # generated rays enumerate the ROI
    if rays is None:
        rays = generate_rays(plan, k=k, c2w=c2w, ortho_scale=ortho_scale)
    lattice = generate_samples(plan, rays, jitter=jitter)
    sigma, color = eval_fields(field, lattice)
    intl = integrate(sigma, color, lattice.dt, lattice.mask,
                     plan.t_near, plan.t_far)
    planes = compose(
        rays.pixel_ids, intl.radiance, intl.transmittance, intl.opacity,
        intl.depth, plan.width, plan.height, plan.t_far,
        unique_pixels=unique_pixels)
    return RenderOutputs(
        rays=rays, lattice=lattice, sigma=sigma, color=color,
        intl=intl, planes=planes)


def render_image(plan: Plan, field, **kwargs) -> jnp.ndarray:
    """(H, W, 3) radiance image - the common training target."""
    return render(plan, field, **kwargs).planes.image


def default_ray_tile(plan: Plan, budget_samples: int = 1 << 22) -> int:
    """Ray-tile size bounding the live sample workspace to ~budget samples.

    The JAX analogue of the reference's workspace sizing
    (renderer.cpp:448-464): instead of a caller-provided scratch arena, the
    streaming path bounds XLA's live temporaries by processing ray blocks of
    fixed shape. 2^22 samples keeps the per-tile buffers (positions, color,
    weights) in the hundreds of MB of HBM at K=128.
    """
    k = plan.sampling.max_steps
    tile = max(1, budget_samples // max(k, 1))
    return int(min(tile, plan.ray_count))


# Residual bytes a streamed VJP without remat keeps per lattice sample when
# it also returns camera gradients (on an H100 at 512^2 x 128 steps the
# Renderer's backward peaked at 9.94 GB for 33.5 M samples; 3.18 GB without
# camera gradients).
STREAM_RESIDUAL_BYTES = 300


def remat_residual_budget() -> int:
    """Bytes of saved residuals a backward may keep instead of
    rematerializing: a quarter of what the default device lets JAX
    allocate, or 4 GiB where the backend does not report a limit."""
    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return int(limit) // 4 if limit else 4 << 30


def stream_needs_remat(plan: Plan, budget: int | None = None) -> bool:
    """Whether a streamed backward must rematerialize each tile: the whole
    frame's residuals would exceed ``budget`` (default
    :func:`remat_residual_budget`)."""
    samples = plan.ray_count * plan.sampling.max_steps
    if budget is None:
        budget = remat_residual_budget()
    return samples * STREAM_RESIDUAL_BYTES > budget


def render_streamed(
    plan: Plan,
    field,
    k: jnp.ndarray | None = None,
    c2w: jnp.ndarray | None = None,
    ortho_scale: jnp.ndarray | None = None,
    ray_tile: int | None = None,
    jitter: jnp.ndarray | None = None,
    remat: bool | None = None,
) -> ImagePlanes:
    """Forward render streaming over fixed-size ray tiles (production path).

    Semantically identical to :func:`render` (same math per ray; the
    stratified jitter is keyed on global ray indices so tiling does not
    change sampling), but peak memory is bounded by one tile's lattice
    instead of the whole frame - the fixed-workspace model of the reference
    engine, realized as ``lax.map`` over ray blocks inside one executable.
    Differentiable; with ``remat`` each tile's lattice is rematerialized in
    the backward pass instead of stored, so fwd+bwd peak memory is also one
    tile (the reference stores 4 aux floats/sample instead -
    int_cpu.cpp:201-207). Without remat the backward reuses the saved
    residuals and skips a second lattice evaluation. Default (None): remat
    only when the frame's residuals would exceed the budget
    (:func:`stream_needs_remat`).
    """
    if remat is None:
        remat = stream_needs_remat(plan)
    tile = ray_tile or default_ray_tile(plan)
    n = plan.ray_count
    n_tiles = -(-n // tile)
    if jitter is not None and jitter.shape[0] < n_tiles * tile:
        jitter = jnp.pad(
            jitter, ((0, n_tiles * tile - jitter.shape[0]), (0, 0)))

    def block(start):
        rays = generate_rays(plan, k=k, c2w=c2w, ortho_scale=ortho_scale,
                             start=start, count=tile)
        block_jitter = None
        if jitter is not None:
            block_jitter = jax.lax.dynamic_slice(
                jitter, (start, 0), (tile, jitter.shape[1]))
        lattice = generate_samples(plan, rays, ray_index_offset=start,
                                   jitter=block_jitter)
        sigma, color = eval_fields(field, lattice)
        intl = integrate(sigma, color, lattice.dt, lattice.mask,
                         plan.t_near, plan.t_far, with_aux=False)
        return (rays.pixel_ids, intl.radiance, intl.transmittance,
                intl.opacity, intl.depth)

    if remat:
        block = jax.checkpoint(block)
    starts = jnp.arange(n_tiles, dtype=jnp.int32) * tile
    pids, rad, trans, opac, depth = jax.lax.map(
        block, starts, batch_size=None)

    flat = lambda x: x.reshape((n_tiles * tile,) + x.shape[2:])
    return compose(flat(pids), flat(rad), flat(trans), flat(opac),
                   flat(depth), plan.width, plan.height, plan.t_far,
                   unique_pixels=True)
