"""Multi-chip rendering and training: SPMD over a device mesh.

New capability beyond the reference (which is single-process, single-GPU;
SURVEY.md section 2.4). Two complementary decompositions:

1. **Ray data parallelism** (:func:`render_sharded`): the flat ray axis is
   sharded across the mesh; the field is replicated. Ray generation,
   sampling, field gathers and integration are embarrassingly parallel per
   shard; only the final pixel scatter crosses shards, where GSPMD inserts
   the collective. This is how one frame scales across chips.

2. **View data parallelism** (:func:`make_dp_train_step`): each device
   renders its own batch of views against replicated field parameters and
   gradients are combined with an explicit ``pmean`` inside ``shard_map``.
   This is how grid fitting scales across chips.

3. **Field sharding** (:func:`render_zsharded`): the volume is split into
   z-slabs, one per device, for grids beyond one device's memory.

All three are plain ``shard_map``/GSPMD programs; XLA hands their
collectives to NCCL on the GPU.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax >= 0.8 top-level API; the experimental home is deprecated
    from jax import shard_map
    _NO_REP_CHECK = {"check_vma": False}
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
    _NO_REP_CHECK = {"check_rep": False}

from dvren_tpu.core.plan import CameraConfig, Plan
from dvren_tpu.render.pipeline import render


def render_sharded(plan: Plan, field, mesh: Mesh, axis: str | None = None):
    """Render one frame with the ray axis sharded across ``mesh``.

    Returns the (replicated) ImagePlanes. The sharding constraint on the ray
    lattice propagates through sampling/field-eval/integration; the compose
    scatter is the single cross-shard reduction.
    """
    axis = axis or mesh.axis_names[0]
    ray_sharding = NamedSharding(mesh, P(axis))

    @functools.partial(jax.jit, out_shardings=NamedSharding(mesh, P()))
    def run(field):
        from dvren_tpu.ops.raygen import generate_rays
        from dvren_tpu.ops.sampling import generate_samples
        from dvren_tpu.ops.integrate import integrate
        from dvren_tpu.ops.compose import compose
        from dvren_tpu.render.pipeline import eval_fields
        from dvren_tpu.ops.raygen import Rays

        rays = generate_rays(plan)
        rays = Rays(
            origins=jax.lax.with_sharding_constraint(rays.origins, ray_sharding),
            directions=jax.lax.with_sharding_constraint(
                rays.directions, ray_sharding),
            t_near=jax.lax.with_sharding_constraint(rays.t_near, ray_sharding),
            t_far=jax.lax.with_sharding_constraint(rays.t_far, ray_sharding),
            pixel_ids=jax.lax.with_sharding_constraint(
                rays.pixel_ids, ray_sharding),
        )
        lattice = generate_samples(plan, rays)
        sigma, color = eval_fields(field, lattice)
        intl = integrate(sigma, color, lattice.dt, lattice.mask,
                         plan.t_near, plan.t_far)
        return compose(rays.pixel_ids, intl.radiance, intl.transmittance,
                       intl.opacity, intl.depth, plan.width, plan.height,
                       plan.t_far)

    with mesh:
        return run(field)


def make_dp_train_step(plan: Plan, field_template, optimizer,
                       mesh: Mesh, axis: str | None = None, project=None):
    """Build a view-data-parallel jitted train step over ``mesh``.

    The step signature is ``(params, opt_state, c2ws, targets) ->
    (params, opt_state, loss)`` where
      - ``params`` is the trainable tuple (replicated),
      - ``c2ws`` is (V, 3, 4) camera poses, V divisible by mesh size,
      - ``targets`` is (V, H, W, 3) ground truth, sharded with the poses.

    Inside the per-device body each device renders its local views and the
    gradient is combined with ``jax.lax.pmean`` - the explicit collective
    replacing the reference's nonexistent comm backend.
    ``project`` optionally post-processes params INSIDE the jitted step.
    """
    axis = axis or mesh.axis_names[0]

    def local_loss(params, c2ws_local, targets_local):
        field = field_template.with_params(*params)

        def one(c2w):
            return render(plan, field, c2w=c2w).planes.image

        pred = jax.vmap(one)(c2ws_local)
        return jnp.mean((pred - targets_local) ** 2)

    def step_body(params, opt_state, c2ws_local, targets_local):
        loss, grads = jax.value_and_grad(local_loss)(
            params, c2ws_local, targets_local)
        grads = jax.lax.pmean(grads, axis)
        loss = jax.lax.pmean(loss, axis)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        if project is not None:
            params = project(params)
        return params, opt_state, loss

    sharded = shard_map(
        step_body, mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        **_NO_REP_CHECK,
    )
    return jax.jit(sharded)


def build_z_slabs(field, n_devices: int):
    """Host-side z-slab decomposition of a dense grid with +1-plane halo.

    The grid's Z cell range is split into ``n_devices`` contiguous runs;
    device d stores planes [c0_d, c0_d + per] (one halo plane so trilinear
    cells at the cut interpolate locally), zero-padded to a uniform shape.
    Returns (sigma_slabs (D, per+1, ny, nx), color_slabs (D, per+1, ny, nx,
    3), c0 (D,) first cell, hi_c (D,) one-past-last real cell), as host
    arrays: :func:`render_zsharded` places each slab on its own device.
    """
    import numpy as np

    sig = np.asarray(field.sigma)
    col = np.asarray(field.color)
    nz, ny, nx = sig.shape
    cells = nz - 1
    per = -(-cells // n_devices)
    sig_slabs = np.zeros((n_devices, per + 1, ny, nx), sig.dtype)
    col_slabs = np.zeros((n_devices, per + 1, ny, nx, 3), col.dtype)
    c0 = np.minimum(np.arange(n_devices) * per, cells)
    hi_c = np.minimum(c0 + per, cells)
    for d in range(n_devices):
        lo, hi = int(c0[d]), int(hi_c[d])
        n_pl = hi - lo + 1
        sig_slabs[d, :n_pl] = sig[lo:hi + 1]
        col_slabs[d, :n_pl] = col[lo:hi + 1]
    return (sig_slabs, col_slabs, c0.astype(np.int32),
            hi_c.astype(np.int32))


def render_zsharded(plan: Plan, field, mesh: Mesh, axis: str | None = None,
                    jitter=None):
    """Render with the FIELD spatially sharded in z across ``mesh`` - the
    mode for grids beyond one chip's HBM (each device holds 1/D of the
    volume plus one halo plane).

    The emission-absorption integral decomposes exactly over z-slabs: a ray
    crosses the slabs monotonically in z, so with tau_d = the ray's optical
    depth inside slab d, the global transmittance prefix for device d's
    samples is exp(-carry_d) with carry_d = sum of tau over slabs visited
    earlier (direction-dependent order). Two collectives per frame:
    ``all_gather`` of the per-slab optical depths (phase 1) and a ``psum``
    of the weighted partial sums (phase 2) - the volume-rendering analogue
    of sequence-parallel attention. Early termination
    (T <= 1e-4) is applied exactly via the global prefix.

    Each device marches ONLY its slab's step window per ray: the host intersects
    every ray with every slab's z-range and emits per-(device, ray) step
    windows, conservatively widened by one step so the in-graph slab
    mask retains exactness; the static window budget is the mesh-wide
    maximum, so per-device compute scales ~1/D + halo. OOB_ZERO
    trilinear dense grids only.
    """
    import numpy as np

    from dvren_tpu.core.plan import InterpMode, OobPolicy
    from dvren_tpu.core.status import check
    from dvren_tpu.ops.compose import compose
    from dvren_tpu.ops.integrate import OPACITY_EPS, STOP_THRESHOLD
    from dvren_tpu.ops.raygen import generate_rays
    from dvren_tpu.ops.sampling import generate_samples

    check(getattr(field, "oob", None) == OobPolicy.ZERO,
          "z-sharded rendering requires an OOB_ZERO dense grid")
    check(getattr(field, "interp", None) == InterpMode.LINEAR,
          "z-sharded rendering requires trilinear interpolation")
    axis = axis or mesh.axis_names[0]
    n_dev = int(np.prod([mesh.shape[a] for a in (axis,)]))
    sig_slabs, col_slabs, c0, hi_c = build_z_slabs(field, n_dev)
    per = sig_slabs.shape[1] - 1

    nz, ny, nx = field.sigma.shape
    bz0 = float(field.bbox_min[2])
    bz1 = float(field.bbox_max[2])
    cell_h = (bz1 - bz0) / float(nz - 1)
    bxy_min = (float(field.bbox_min[0]), float(field.bbox_min[1]))
    bxy_max = (float(field.bbox_max[0]), float(field.bbox_max[1]))

    from dvren_tpu.ops import grid as grid_ops
    from dvren_tpu.render import windowed as windowed_mod

    # Per-(device, ray) step windows from the ray/slab z intersection,
    # widened one step each side (a step is skipped only when its whole
    # [base_t, base_t + dt) sample range provably misses the slab).
    o_h, d_h = windowed_mod._host_rays(plan)
    n = plan.ray_count
    dt_f = float(plan.sampling.dt)
    k_cap = int(plan.sampling.max_steps)
    ke_np = np.zeros((n_dev, n), np.int64)
    cnt_np = np.zeros((n_dev, n), np.int64)
    c0_np = np.asarray(c0)
    hi_np = np.asarray(hi_c)
    for d in range(n_dev):
        lo_z = bz0 + float(c0_np[d]) * cell_h
        hi_z = bz0 + float(hi_np[d]) * cell_h
        dz = d_h[:, 2]
        oz = o_h[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (lo_z - oz) / dz
            t1 = (hi_z - oz) / dz
        t_lo = np.minimum(t0, t1)
        t_hi = np.maximum(t0, t1)
        para = np.abs(dz) < 1e-12
        inside = (oz >= lo_z) & (oz <= hi_z)
        t_lo = np.where(para, np.where(inside, plan.t_near, plan.t_far), t_lo)
        t_hi = np.where(para, np.where(inside, plan.t_far, plan.t_near), t_hi)
        t_lo = np.maximum(t_lo, plan.t_near)
        t_hi = np.minimum(t_hi, plan.t_far)
        k_lo = np.clip(np.floor((t_lo - plan.t_near) / dt_f) - 1, 0, k_cap)
        k_hi = np.clip(np.ceil((t_hi - plan.t_near) / dt_f) + 1, 0, k_cap)
        ke_np[d] = k_lo.astype(np.int64)
        cnt_np[d] = np.maximum(k_hi - k_lo, 0).astype(np.int64)
    budget = int(min(max(-(-int(cnt_np.max()) // 8) * 8, 8), k_cap))

    def body(sig_slab, col_slab, c0_d, hi_d, ke_d, jit_tab):
        d_idx = jax.lax.axis_index(axis)
        sig_slab = sig_slab[0]
        col_slab = col_slab[0]
        c0_s = c0_d[0, 0].astype(jnp.float32)
        hi_s = hi_d[0, 0].astype(jnp.float32)
        ke = ke_d[0]
        lo_z = jnp.float32(bz0) + c0_s * jnp.float32(cell_h)
        hi_pad = lo_z + jnp.float32(per) * jnp.float32(cell_h)
        hi_real = jnp.float32(bz0) + hi_s * jnp.float32(cell_h)
        is_last = d_idx == n_dev - 1

        rays = generate_rays(plan)
        block_jitter = None
        if jit_tab.shape[1] > 1:
            cols = jnp.clip(ke[:, None] + jnp.arange(budget)[None, :],
                            0, jit_tab.shape[1] - 1)
            block_jitter = jnp.take_along_axis(jit_tab, cols, axis=1)
        lattice = generate_samples(plan, rays, jitter=block_jitter,
                                   step_offset=ke, num_steps=budget)
        px = lattice.positions[..., 0]
        py = lattice.positions[..., 1]
        pz = lattice.positions[..., 2]

        # eval_grid bboxes are static (field meta); transform z into the
        # slab's local frame instead - the slab EXTENT per*cell_h is static,
        # only its origin lo_z is per-device.
        inv_slab = 1.0 / (float(per) * cell_h)
        pz_loc = (pz - lo_z) * jnp.float32(inv_slab)
        slab_bb_min = (bxy_min[0], bxy_min[1], 0.0)
        slab_bb_max = (bxy_max[0], bxy_max[1], 1.0)
        sigma = grid_ops.eval_grid_planes(
            sig_slab, px, py, pz_loc, slab_bb_min, slab_bb_max,
            field.interp, field.oob)
        color = grid_ops.eval_grid_planes(
            col_slab, px, py, pz_loc, slab_bb_min, slab_bb_max,
            field.interp, field.oob)

        # half-open slab membership: the shared cut plane belongs to the
        # upper slab; the global top plane to the last device.
        in_slab = ((pz >= lo_z)
                   & jnp.where(is_last, pz <= hi_real, pz < hi_real))
        maskf = (lattice.mask & in_slab).astype(jnp.float32)
        od = jnp.maximum(sigma * lattice.dt, 0.0) * maskf

        # phase 1: slab optical depths -> direction-ordered global prefix
        tau_d = jnp.sum(od, axis=1)                     # (N,)
        taus = jax.lax.all_gather(tau_d, axis)          # (D, N)
        order = jnp.arange(n_dev, dtype=jnp.int32)
        dzpos = rays.directions[:, 2] >= 0.0            # (N,)
        before = jnp.where(dzpos[None, :], (order[:, None] < d_idx),
                           (order[:, None] > d_idx))
        carry = jnp.sum(taus * before.astype(taus.dtype), axis=0)  # (N,)

        # phase 2: integrate with the global prefix (ops.integrate math)
        cum = carry[:, None] + jnp.cumsum(od, axis=1)
        p = jnp.exp(-cum)
        tb = jnp.exp(-(cum - od))
        proc = (lattice.mask & in_slab) & (tb > STOP_THRESHOLD)
        procf = proc.astype(jnp.float32)
        w = (tb - p) * procf

        # depth cursor: window origin + in-window dt prefix (steps before
        # the window are never t_far-truncated, so the origin is exact)
        dt_m = lattice.dt * lattice.mask.astype(jnp.float32)
        t_origin = (jnp.float32(plan.t_near)
                    + ke.astype(jnp.float32) * jnp.float32(dt_f))
        t_cursor = t_origin[:, None] + jnp.cumsum(dt_m, axis=1) - dt_m
        mid = t_cursor + 0.5 * lattice.dt
        cr, cg, cb = color

        parts = jnp.stack([
            jnp.sum(w * cr, axis=1), jnp.sum(w * cg, axis=1),
            jnp.sum(w * cb, axis=1), jnp.sum(w * mid, axis=1),
            jnp.sum(od * procf, axis=1)], axis=0)       # (5, N)
        parts = jax.lax.psum(parts, axis)

        t_final = jnp.exp(-parts[4])
        opacity = 1.0 - t_final
        depth = jnp.where(opacity > OPACITY_EPS,
                          parts[3] / jnp.maximum(opacity, OPACITY_EPS),
                          jnp.float32(plan.t_far))
        radiance = jnp.stack([parts[0], parts[1], parts[2]], axis=-1)
        return compose(rays.pixel_ids, radiance, t_final, opacity, depth,
                       plan.width, plan.height, plan.t_far)

    sharded = shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=P(),
        **_NO_REP_CHECK,
    )
    if jitter is None:
        from dvren_tpu.render.pipeline import plan_jitter_table
        jit_np = plan_jitter_table(plan)
        jitter = jnp.asarray(jit_np) if jit_np is not None else None
    if jitter is None:  # FIXED mode: 0.5 broadcasts through generate_samples
        jitter = jnp.full((1, 1), 0.5, jnp.float32)
    # Each slab goes straight from the host to its own device: the full
    # volume never lands on one device.
    split = NamedSharding(mesh, P(axis))
    args = [jax.device_put(a, split) for a in (
        sig_slabs, col_slabs, c0.reshape(-1, 1), hi_c.reshape(-1, 1),
        ke_np.astype(np.int32))]
    with mesh:
        return jax.jit(sharded)(*args, jitter)


def fit_dense_grid_dp(plan: Plan, field, cameras: Sequence[CameraConfig],
                      targets, mesh: Mesh, learning_rate: float = 5e-2,
                      steps: int = 100):
    """Multi-device variant of :func:`dvren_tpu.opt.fit.fit_dense_grid`."""
    import numpy as np

    optimizer = optax.adam(learning_rate)
    params = (field.sigma, field.color)
    opt_state = optimizer.init(params)
    step = make_dp_train_step(
        plan, field, optimizer, mesh,
        project=lambda p: (jnp.maximum(p[0], 0.0),
                           jnp.clip(p[1], 0.0, 1.0)))

    c2ws = jnp.stack([jnp.asarray(c.c2w, jnp.float32).reshape(3, 4)
                      for c in cameras])
    targets = jnp.asarray(targets, jnp.float32)
    n = mesh.devices.size
    if c2ws.shape[0] % n != 0:
        raise ValueError(
            f"view count {c2ws.shape[0]} not divisible by mesh size {n}")

    losses = []
    with mesh:
        for _ in range(steps):
            params, opt_state, loss = step(params, opt_state, c2ws, targets)
            losses.append(float(loss))
    return field.with_params(*params), np.asarray(losses)
