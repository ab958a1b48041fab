"""Per-ray fused march: sampling, trilinear lookup and integration in one
GPU kernel, plus the one function that decides which route a render takes.

The reference renderer's CUDA design (``ray_cuda.cu``, ``hp_samp_int_fused``)
gives each ray its own thread: it steps t, fetches the field, folds the
sample into the running transmittance and stops once the ray is opaque.
:func:`march_rays` is that design as a Pallas kernel on the Triton route.
One program owns a power-of-two block of rays (the ray count is padded to
the block and the tail masked); per step every ray

- forms ``base_t = t_near + k * dt``, its stratified jitter (read from the
  plan's host jitter table, so it is bit-identical to ``ops/rng.py``) and
  the sample position, exactly as ``ops/sampling.py`` does;
- reads the 8 trilinear corners straight from the (Z, Y, X, 4) voxel
  table in device memory (the headline 64^3 grid is 4 MB and stays in L2);
- folds the sample into the running optical depth with the semantics of
  ``ops/integrate.py``: ``T = exp(-sum od)``, weight ``T_before - T``,
  ``STOP_THRESHOLD`` termination and the ``OPACITY_EPS`` depth rule.

The block's loop ends once no ray in it can contribute again (T <= 1e-4
or past t_far), so opaque media stop early where the plain path evaluates
every one of the ``max_steps`` lattice slots.

Nothing is stored per sample, so the backward cannot reuse the forward:
:func:`render_march` is a ``jax.custom_vjp`` whose backward is the VJP of
the plain streamed path (``render/pipeline.py::render_streamed``). That
keeps exact voxel gradients and camera gradients in ``k``, ``c2w`` and
``ortho_scale``. The VJP takes ``render_streamed``'s size-based remat
choice: it saves the lattice's residuals where they fit the budget (the
faster backward) and rematerializes tile by tile on larger frames.

``interpret`` is always an explicit argument (default False): the kernel
runs in the Pallas interpreter only when a caller, in practice a test on
the CPU, asks for it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from dvren_tpu.core.plan import InterpMode, OobPolicy, Plan, SamplingMode
from dvren_tpu.ops.compose import ImagePlanes, compose
from dvren_tpu.ops.integrate import OPACITY_EPS, STOP_THRESHOLD
from dvren_tpu.ops.raygen import camera_arrays, generate_rays

BLOCK_RAYS = 128      # rays per program: one ray per thread at 4 warps
NUM_WARPS = 4


@dataclass(frozen=True)
class Route:
    """Where a render runs: the march kernel or the plain jnp path.

    ``note`` is the label the Renderer records in its stats."""

    kernel: bool
    interpret: bool = False
    note: str = "plain_path"


def eligible(field) -> bool:
    """The kernel handles dense trilinear OOB_ZERO voxel grids with every
    dimension >= 2 (the cell base index is clipped to n - 2)."""
    sigma = getattr(field, "sigma", None)
    return (hasattr(field, "color") and hasattr(field, "bbox_min")
            and getattr(sigma, "ndim", 0) == 3
            and min(sigma.shape) >= 2
            and getattr(field, "interp", None) == InterpMode.LINEAR
            and getattr(field, "oob", None) == OobPolicy.ZERO)


def select_route(field, *, backend: str | None = None,
                 interpret: bool = False) -> Route:
    """The single routing decision for a forward render of generated rays.

    On the GPU, dense trilinear OOB_ZERO grids take the march kernel;
    everything else (other field kinds, NEAREST/CLAMP grids, other
    backends) takes the plain ``render`` / ``render_streamed`` path.
    ``backend`` defaults to JAX's default backend; ``interpret`` is passed
    through unchanged. Renders the caller asked to run otherwise - ray
    override bundles and ``RenderOptions.use_window`` - are plain-path
    modes and do not ask. Fits do not ask either: they train on the plain
    path (see ``opt.fit.fit_dense_grid``)."""
    backend = backend or jax.default_backend()
    if backend == "gpu" and eligible(field):
        return Route(kernel=True, interpret=interpret, note="march_kernel")
    return Route(kernel=False)


def voxel_table(field) -> jnp.ndarray:
    """(Z*Y*X*4,) float32 voxel table, channels (sigma, r, g, b) adjacent so
    one corner is one 16-byte read. Values pass through the field's
    ``packed_dtype`` exactly as the plain path's packed stencil does."""
    from dvren_tpu.ops.grid import table_dtype

    dt = table_dtype(getattr(field, "packed_dtype", "float32"))
    tab = jnp.concatenate([field.sigma[..., None], field.color], axis=-1)
    return tab.astype(dt).astype(jnp.float32).reshape(-1)


def _axis_consts(lo: float, hi: float):
    extent = float(hi) - float(lo)
    return float(lo), (0.0 if extent == 0.0 else 1.0 / extent), extent == 0.0


def _march_kernel(rays_ref, tab_ref, jit_ref, out_ref, *, n_pad, n_rays,
                  dims, axes, dt, k_max, stratified, t_far_plan, block):
    nz, ny, nx = dims
    ray = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)

    def row(i):
        return pltr.load(rays_ref.at[i * n_pad + ray])

    ox, oy, oz, dx, dy, dz, tn, tf = (row(i) for i in range(8))
    tf_in = jnp.nextafter(tf, tn)
    ray_ok = tf > tn
    jit_row = jnp.minimum(ray, n_rays - 1) * k_max
    dt32 = jnp.float32(dt)
    chan = jnp.arange(4, dtype=jnp.int32)

    def local(p, ax):
        lo, inv, degenerate = ax
        loc = jnp.zeros_like(p) if degenerate else (p - lo) * inv
        return loc, (loc < 0.0) | (loc > 1.0)

    def lookup(px, py, pz):
        lx, ox_ = local(px, axes[0])
        ly, oy_ = local(py, axes[1])
        lz, oz_ = local(pz, axes[2])
        fx, fy, fz = lx * (nx - 1), ly * (ny - 1), lz * (nz - 1)
        ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx - 2)
        iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny - 2)
        iz = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, nz - 2)
        tx = fx - ix.astype(jnp.float32)
        ty = fy - iy.astype(jnp.float32)
        tz = fz - iz.astype(jnp.float32)
        inside = jnp.where(ox_ | oy_ | oz_, 0.0, 1.0)
        wx, wy, wz = (1.0 - tx, tx), (1.0 - ty, ty), (1.0 - tz, tz)
        v = (iz * ny + iy) * nx + ix
        acc = jnp.zeros((block, 4), jnp.float32)
        for cz in (0, 1):
            for cy in (0, 1):
                for cx in (0, 1):
                    vc = v + (cz * ny * nx + cy * nx + cx)
                    vals = pltr.load(
                        tab_ref.at[vc[:, None] * 4 + chan[None, :]])
                    w = wz[cz] * wy[cy] * wx[cx] * inside
                    acc = acc + w[:, None] * vals
        return tuple(jnp.sum(jnp.where(chan[None, :] == c, acc, 0.0), axis=1)
                     for c in range(4))

    def cond(carry):
        return carry[-1]

    def body(carry):
        k, s_od, tb, cr, cg, cb, dep, cur, tfin, _ = carry
        base_t = tn + k.astype(jnp.float32) * dt32
        live = ray_ok & (base_t < tf)
        if stratified:
            j = jnp.clip(pltr.load(jit_ref.at[jit_row + k]), 0.0, 1.0)
        else:
            j = jnp.float32(0.5)
        st = base_t + j * dt32
        st = jnp.where(st >= tf, tf_in, st)
        dta = jnp.where(live, jnp.minimum(base_t + dt32, tf) - base_t, 0.0)
        sigma, r, g, b = lookup(ox + dx * st, oy + dy * st, oz + dz * st)
        od = jnp.where(live, jnp.maximum(sigma * dta, 0.0), 0.0)
        s_new = s_od + od
        p = jnp.exp(-s_new)
        proc = live & (tb > STOP_THRESHOLD)
        w = jnp.where(proc, tb - p, 0.0)
        mid = cur + 0.5 * dta
        k1 = k + 1
        nxt = (ray_ok & (p > STOP_THRESHOLD)
               & (tn + k1.astype(jnp.float32) * dt32 < tf))
        go = (k1 < k_max) & (jnp.max(nxt.astype(jnp.int32)) > 0)
        return (k1, s_new, p, cr + w * r, cg + w * g, cb + w * b,
                dep + w * mid, cur + dta,
                jnp.minimum(tfin, jnp.where(proc, p, 1.0)), go)

    zeros = jnp.zeros((block,), jnp.float32)
    ones = jnp.ones((block,), jnp.float32)
    start = (jnp.int32(0), zeros, ones, zeros, zeros, zeros, zeros, tn,
             ones, jnp.max(ray_ok.astype(jnp.int32)) > 0)
    _, _, _, cr, cg, cb, dep, _, tfin, _ = jax.lax.while_loop(
        cond, body, start)
    opacity = 1.0 - tfin
    depth = jnp.where(opacity > OPACITY_EPS,
                      dep / jnp.maximum(opacity, OPACITY_EPS),
                      jnp.float32(t_far_plan))
    for i, val in enumerate((cr, cg, cb, tfin, opacity, depth)):
        pltr.store(out_ref.at[i * n_pad + ray], val)


def march_rays(plan: Plan, field, rays, jitter=None, *,
               interpret: bool = False, block: int = BLOCK_RAYS):
    """Run the march kernel over a ray bundle.

    ``rays``: :class:`dvren_tpu.ops.raygen.Rays` of N rays. ``jitter``:
    (N, max_steps) table for STRATIFIED plans (None computes it in-graph
    with ``ops.rng``). Returns ``(radiance (N, 3), transmittance,
    opacity, depth)``, each per ray, as ``ops.integrate`` defines them.
    """
    n = rays.count
    k_max = int(plan.sampling.max_steps)
    n_pad = -(-n // block) * block
    pad = n_pad - n
    planes = jnp.concatenate(
        [rays.origins.T, rays.directions.T,
         rays.t_near[None, :], rays.t_far[None, :]], axis=0)
    planes = jnp.pad(planes.astype(jnp.float32), ((0, 0), (0, pad)))
    stratified = plan.sampling.mode == SamplingMode.STRATIFIED
    if stratified:
        if jitter is None:
            from dvren_tpu.ops.rng import stratified_jitter
            jitter = stratified_jitter(
                plan.seed, jnp.arange(n, dtype=jnp.int32)[:, None],
                jnp.arange(k_max, dtype=jnp.int32)[None, :])
        jit_flat = jnp.asarray(jitter, jnp.float32)[:n, :k_max].reshape(-1)
    else:
        jit_flat = jnp.zeros((1,), jnp.float32)
    nz, ny, nx = (int(v) for v in field.sigma.shape)
    axes = tuple(_axis_consts(field.bbox_min[i], field.bbox_max[i])
                 for i in range(3))
    kernel = functools.partial(
        _march_kernel, n_pad=n_pad, n_rays=n, dims=(nz, ny, nx), axes=axes,
        dt=float(plan.sampling.dt), k_max=k_max, stratified=stratified,
        t_far_plan=float(plan.t_far), block=block)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((6 * n_pad,), jnp.float32),
        grid=(n_pad // block,),
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=NUM_WARPS,
                                            num_stages=1),
        interpret=interpret,
        name="dvren_march",
    )(planes.reshape(-1), voxel_table(field), jit_flat)
    out = out.reshape(6, n_pad)[:, :n]
    return out[0:3].T, out[3], out[4], out[5]


def render_march(plan: Plan, field, k=None, c2w=None, ortho_scale=None,
                 jitter=None, *, interpret: bool = False) -> ImagePlanes:
    """Forward render of the plan's generated rays through the march kernel.

    Same signature and outputs as ``render_streamed``; differentiable in the
    field's sigma/color and in ``k``, ``c2w`` and ``ortho_scale`` through a
    custom VJP that recomputes along the plain streamed path."""
    from dvren_tpu.render.pipeline import render_streamed
    from dvren_tpu.render.windowed import roi_hitmask

    dk, dc2w, ds = camera_arrays(plan)
    k = dk if k is None else jnp.asarray(k, jnp.float32).reshape(3, 3)
    c2w = dc2w if c2w is None else jnp.asarray(c2w, jnp.float32).reshape(3, 4)
    ortho_scale = ds if ortho_scale is None else jnp.asarray(
        ortho_scale, jnp.float32)

    @jax.custom_vjp
    def planes_fn(sigma, color, k, c2w, ortho_scale, jitter):
        rays = generate_rays(plan, k=k, c2w=c2w, ortho_scale=ortho_scale)
        rad, trans, opac, depth = march_rays(
            plan, field.with_params(sigma, color), rays, jitter,
            interpret=interpret)
        p = compose(rays.pixel_ids, rad, trans, opac, depth, plan.width,
                    plan.height, plan.t_far)
        return p.image, p.transmittance, p.opacity, p.depth

    def fwd(sigma, color, k, c2w, ortho_scale, jitter):
        return (planes_fn(sigma, color, k, c2w, ortho_scale, jitter),
                (sigma, color, k, c2w, ortho_scale, jitter))

    def bwd(res, ct):
        sigma, color, k, c2w, ortho_scale, jitter = res

        def plain(sigma, color, k, c2w, ortho_scale):
            p = render_streamed(plan, field.with_params(sigma, color), k=k,
                                c2w=c2w, ortho_scale=ortho_scale,
                                jitter=jitter)
            return p.image, p.transmittance, p.opacity, p.depth

        _, vjp = jax.vjp(plain, sigma, color, k, c2w, ortho_scale)
        return (*vjp(ct), None)

    planes_fn.defvjp(fwd, bwd)
    image, trans, opac, depth = planes_fn(field.sigma, field.color, k, c2w,
                                          ortho_scale, jitter)
    return ImagePlanes(image=image, transmittance=trans, opacity=opac,
                       depth=depth, hitmask=roi_hitmask(plan))
