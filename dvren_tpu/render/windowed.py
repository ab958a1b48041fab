"""Window-clipped rendering: skip provably-zero samples outside the field bbox.

For an OOB_ZERO field, every
lattice step outside the field's bbox contributes exactly zero (sigma == 0
=> alpha == 0 => weight == 0; the depth cursor advances by the full dt
either way), so those steps can be skipped without changing any output.

The acceleration structure is built HOST-side per (plan, camera) - the
JAX analogue of CUDA-Graph capture specialization:

1. regenerate the rays in numpy and slab-test them against the bbox;
2. per ray: first/last live lattice step inside the bbox (global step
   indices, so the base_t grid, jitter keying and dt truncation are the
   same as the full lattice);
3. sort rays by window length and group them into blocks; each block gets
   the smallest static step budget (multiple of 32) covering its rays;
4. the device renders each budget group with its own specialized block
   size; per-ray outputs are composed by pixel id exactly as usual.

Exactness: for OOB_ZERO fields the result is bit-comparable to the full
render (tests gate at float32 ulp level). Not applicable to OOB_CLAMP.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from dvren_tpu.core.plan import CameraModel, OobPolicy, Plan
from dvren_tpu.core.status import check
from dvren_tpu.ops.compose import ImagePlanes, compose
from dvren_tpu.ops.integrate import integrate
from dvren_tpu.ops.raygen import generate_rays
from dvren_tpu.ops.sampling import generate_samples
from dvren_tpu.render.pipeline import eval_fields, remat_residual_budget

_STEP_QUANTUM = 32


def _host_rays(plan: Plan):
    """Numpy mirror of ops.raygen.generate_rays (float32)."""
    roi = plan.roi
    n = plan.ray_count
    idx = np.arange(n, dtype=np.int64)
    px = (roi.x + idx % roi.width).astype(np.float32)
    py = (roi.y + idx // roi.width).astype(np.float32)
    k = np.asarray(plan.camera.k, np.float32).reshape(3, 3)
    c2w = np.asarray(plan.camera.c2w, np.float32).reshape(3, 4)
    rot, trans = c2w[:, :3], c2w[:, 3]
    if plan.camera.model == CameraModel.PINHOLE:
        a = ((px + 0.5) - k[0, 2]) / k[0, 0]
        b = ((py + 0.5) - k[1, 2]) / k[1, 1]
        d = (np.stack([a, b, np.ones_like(a)], -1) @ rot.T).astype(np.float32)
        o = np.broadcast_to(trans, (n, 3)).astype(np.float32)
    else:
        scale = np.float32(plan.camera.ortho_scale)
        u = (px - k[0, 2]) / k[0, 0] * scale
        v = (py - k[1, 2]) / k[1, 1] * scale
        d = np.broadcast_to(rot[:, 2], (n, 3)).astype(np.float32)
        o = (trans + np.stack([u, v], -1) @ rot[:, :2].T).astype(np.float32)
    # mirror device rounding exactly: inv = 1/sqrt(max(len_sq, FLT_MIN)),
    # then multiply (ops/raygen.py:135-137); dividing by sqrt rounds
    # differently by 1 ulp.
    len_sq = np.maximum((d * d).sum(-1, keepdims=True).astype(np.float32),
                        np.float32(1.1754943508222875e-38))
    inv = np.float32(1.0) / np.sqrt(len_sq)
    return o, (d * inv).astype(np.float32)


def _windows(plan: Plan, bbox_min, bbox_max):
    """Per-ray (k_enter, k_count) of live lattice steps inside the bbox.

    Conservative by one step on each side so float rounding between the
    host f64 slab test and the device f32 march can never clip a
    contributing sample."""
    o, d = _host_rays(plan)
    o = o.astype(np.float64)
    d = d.astype(np.float64)
    lo = np.asarray(bbox_min, np.float64)
    hi = np.asarray(bbox_max, np.float64)

    # d == 0 axes are handled explicitly (a ray on a bbox face with d == 0
    # is inside that slab for all t: local == 0 or 1 is in [0, 1]); relying
    # on NaN propagation from 0/0 silently dropped face-coplanar rays.
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = np.where(d == 0, -np.inf, (lo - o) / d)
        t1 = np.where(d == 0, np.inf, (hi - o) / d)
    near = np.minimum(t0, t1).max(axis=1)
    far = np.maximum(t0, t1).min(axis=1)
    # Rays parallel to an axis outside the slab never enter. "Outside" must
    # mirror the DEVICE's float32 local-coordinate test (ops/grid.py
    # _axis_local), not an f64 comparison: an origin 1 ulp past the face in
    # f64 can still round to local == 1.0 in f32 (inside; the device
    # renders it), so the f64 test would wrongly drop the ray.
    o32 = o.astype(np.float32)
    ext = (hi - lo).astype(np.float64)
    inv32 = np.where(ext != 0.0, 1.0 / np.where(ext == 0.0, 1.0, ext),
                     0.0).astype(np.float32)
    local32 = ((o32 - lo.astype(np.float32)) * inv32).astype(np.float32)
    slab_out32 = (local32 < 0.0) | (local32 > 1.0)
    parallel_out = ((d == 0) & slab_out32).any(axis=1)
    hit = (far >= near) & (far >= 0) & ~parallel_out

    dt = plan.sampling.dt
    t_near, t_far = plan.t_near, plan.t_far
    k_max = plan.sampling.max_steps
    enter_t = np.maximum(near, t_near)
    exit_t = np.minimum(far, t_far)
    hit &= exit_t > enter_t
    # sanitize before the int casts below: missed rays may carry +/-inf
    enter_t = np.where(hit, enter_t, t_near)
    exit_t = np.where(hit, exit_t, t_near)

    k_enter = np.floor((enter_t - t_near) / dt).astype(np.int64) - 1
    k_exit = np.ceil((exit_t - t_near) / dt).astype(np.int64) + 1
    k_enter = np.clip(k_enter, 0, k_max)
    k_exit = np.clip(k_exit, 0, k_max)
    # also bounded by t_far truncation of the global lattice
    k_live_far = int(math.ceil((t_far - t_near) / dt - 1e-12))
    k_exit = np.minimum(k_exit, min(k_max, k_live_far))

    k_enter = np.where(hit, k_enter, 0).astype(np.int32)
    k_count = np.where(hit, np.maximum(k_exit - k_enter, 0),
                       0).astype(np.int32)
    return k_enter, k_count


@dataclass(frozen=True)
class WindowedSchedule:
    """Host-built, device-resident acceleration structure for one
    (plan, camera): per group (step budget, ray ids, first step, jitter
    rows). Build once, render many - the capture-specialization model.

    Registered as a pytree (budgets/counters static, arrays leaves) so
    schedules can cross jit boundaries as arguments instead of being
    embedded as HLO constants."""

    groups: tuple  # ((budget, ids dev (M,), k_enter dev (M,), jit dev), ...)
    total_rays: int
    skipped_rays: int
    full_lattice_samples: int
    windowed_samples: int


def _wsched_flatten(s: "WindowedSchedule"):
    leaves = []
    budgets = []
    jit_present = []
    for budget, ids, ke, jit_rows in s.groups:
        budgets.append(int(budget))
        jit_present.append(jit_rows is not None)
        leaves.extend([ids, ke])
        if jit_rows is not None:
            leaves.append(jit_rows)
    aux = (tuple(budgets), tuple(jit_present), s.total_rays,
           s.skipped_rays, s.full_lattice_samples, s.windowed_samples)
    return leaves, aux


def _wsched_unflatten(aux, leaves):
    budgets, jit_present, total, skipped, full, windowed = aux
    it = iter(leaves)
    groups = []
    for budget, has_jit in zip(budgets, jit_present):
        ids = next(it)
        ke = next(it)
        jit_rows = next(it) if has_jit else None
        groups.append((budget, ids, ke, jit_rows))
    return WindowedSchedule(groups=tuple(groups), total_rays=total,
                            skipped_rays=skipped,
                            full_lattice_samples=full,
                            windowed_samples=windowed)


jax.tree_util.register_pytree_node(
    WindowedSchedule, _wsched_flatten, _wsched_unflatten)


def build_schedule(plan: Plan, bbox_min, bbox_max, block: int = 32768,
                   jitter: np.ndarray | None = None) -> WindowedSchedule:
    """``jitter``: the full (N, K) host table (plan_jitter_table) when the
    plan samples stratified; its window rows are gathered here and shipped
    to the device once, with the rest of the schedule, in one batched put
    (utils/pytree.py::device_put_tree)."""
    k_enter, k_count = _windows(plan, bbox_min, bbox_max)
    n = plan.ray_count
    live = np.nonzero(k_count > 0)[0]
    order = live[np.argsort(-k_count[live], kind="stable")]
    if jitter is not None:
        jitter = np.asarray(jitter, np.float32)

    groups = []
    windowed = 0
    pad_base = n  # distinct out-of-range ids keep the compose scatter unique
    for start in range(0, order.size, block):
        ids = order[start:start + block]
        budget = int(k_count[ids].max())
        budget = min(-(-budget // _STEP_QUANTUM) * _STEP_QUANTUM,
                     plan.sampling.max_steps)
        group_size = min(block, -(-ids.size // 256) * 256)
        if ids.size < group_size:  # pad (degenerate rays, dropped in compose)
            pad = np.arange(pad_base, pad_base + group_size - ids.size)
            pad_base += group_size - ids.size
            ids = np.concatenate([ids, pad])
        ke = np.where(ids < n, k_enter[np.minimum(ids, n - 1)], 0)
        jit_rows = None
        if jitter is not None:
            rows = np.minimum(ids, n - 1)
            cols = np.minimum(ke[:, None] + np.arange(budget)[None, :],
                              jitter.shape[1] - 1)
            jit_rows = jitter[rows[:, None], cols]
        groups.append((budget,
                       ids.astype(np.int32),
                       ke.astype(np.int32),
                       jit_rows))
        windowed += ids.size * budget

    from dvren_tpu.utils.pytree import device_put_tree
    return device_put_tree(WindowedSchedule(
        groups=tuple(groups),
        total_rays=n,
        skipped_rays=n - int(live.size),
        full_lattice_samples=n * plan.sampling.max_steps,
        windowed_samples=windowed,
    ))


def render_windowed(
    plan: Plan,
    field,
    schedule: WindowedSchedule | None = None,
    jitter: np.ndarray | None = None,
) -> ImagePlanes:
    """Window-clipped forward render (OOB_ZERO fields, generated rays).

    ``jitter`` (the full host table) is only consulted when building a
    schedule on the fly; pass a prebuilt schedule for replay (its jitter
    rows are already device-resident). Differentiable w.r.t. the field.
    """
    check(getattr(field, "oob", OobPolicy.ZERO) == OobPolicy.ZERO,
          "window clipping requires an OOB_ZERO field (outside samples "
          "must be exactly zero)")
    if schedule is None:
        schedule = build_schedule(plan, field.bbox_min, field.bbox_max,
                                  jitter=jitter)

    pid_parts, rad_parts, tr_parts, op_parts, dep_parts = [], [], [], [], []
    for budget, ids_dev, ke_dev, jit_rows in schedule.groups:
        if jit_rows is None and jitter is not None:
            # schedule was built without the table; gather its rows now so
            # the compiled program stays free of the hash emulation.
            jit_np = np.asarray(jitter, np.float32)
            ids_np = np.asarray(ids_dev)
            rows = np.minimum(ids_np, plan.ray_count - 1)
            cols = np.minimum(
                np.asarray(ke_dev)[:, None] + np.arange(budget)[None, :],
                jit_np.shape[1] - 1)
            jit_rows = jax.device_put(jit_np[rows[:, None], cols])
        out = _render_group(plan, budget, field, ids_dev, ke_dev, jit_rows)
        pid_parts.append(out[0])
        rad_parts.append(out[1])
        tr_parts.append(out[2])
        op_parts.append(out[3])
        dep_parts.append(out[4])

    if not schedule.groups:  # bbox misses every ray: background frame
        return _compose_groups(plan, *_empty_parts())
    return _compose_groups(
        plan, jnp.concatenate(pid_parts), jnp.concatenate(rad_parts),
        jnp.concatenate(tr_parts), jnp.concatenate(op_parts),
        jnp.concatenate(dep_parts))


def _group_outputs(plan, budget, field, ids, k_enter, block_jitter,
                   k=None, c2w=None, ortho_scale=None):
    rays = generate_rays(plan, ids=ids, k=k, c2w=c2w,
                         ortho_scale=ortho_scale)
    # Without precomputed jitter rows, the in-graph stratified emulation
    # must be keyed on the GLOBAL ray ids (the group order is a length-
    # sorted permutation), not the local group index - offset arange(n)
    # so arange + offset == ids (samp_cpu.cpp:233 keys on global index).
    ray_offset = 0
    if block_jitter is None:
        ray_offset = ids - jnp.arange(ids.shape[0], dtype=jnp.int32)
    lattice = generate_samples(plan, rays, ray_index_offset=ray_offset,
                               jitter=block_jitter,
                               step_offset=k_enter, num_steps=budget)
    sigma, color = eval_fields(field, lattice)
    t_origin = plan.t_near + k_enter.astype(jnp.float32) * plan.sampling.dt
    intl = integrate(sigma, color, lattice.dt, lattice.mask,
                     plan.t_near, plan.t_far, with_aux=False,
                     t_cursor_origin=t_origin)
    return (rays.pixel_ids, intl.radiance, intl.transmittance,
            intl.opacity, intl.depth)


_render_group = functools.partial(jax.jit, static_argnums=(0, 1))(
    _group_outputs)


def render_windowed_traced(plan: Plan, field, schedule: WindowedSchedule,
                           remat: bool | None = None,
                           k=None, c2w=None,
                           ortho_scale=None) -> ImagePlanes:
    """Pure (traceable) windowed render: the whole frame is ONE executable.

    Use inside a caller ``jax.jit``/``jax.grad`` for steady-state replay -
    one device dispatch per frame instead of one per budget group (the
    host-loop :func:`render_windowed` pays a dispatch per group).
    The schedule's group arrays become traced inputs, so one compiled
    program serves any field of the same shape. ``remat`` rematerializes
    each group's lattice in the backward pass (fwd+bwd peak memory is one
    group, matching render_streamed's policy); with remat=False XLA saves
    the lattice residuals instead, skipping the backward's gather
    recompute. Default (None) picks
    remat=False when the analytic residual estimate (~200 B/sample) fits
    ``pipeline.remat_residual_budget()``.

    ``k``/``c2w``/``ortho_scale`` may be traced camera arrays for pose /
    intrinsics gradients AT the schedule's camera (the window was built for
    the plan camera; evaluating at a materially different camera would use
    a stale window - rebuild the schedule instead).
    """
    check(getattr(field, "oob", OobPolicy.ZERO) == OobPolicy.ZERO,
          "window clipping requires an OOB_ZERO field (outside samples "
          "must be exactly zero)")
    if remat is None:
        remat = schedule.windowed_samples * 200 > remat_residual_budget()
    group_fn = jax.checkpoint(_group_outputs, static_argnums=(0, 1)) \
        if remat else _group_outputs
    if not schedule.groups:  # bbox misses every ray: background frame
        return _compose_planes(plan, *_empty_parts())
    parts = [group_fn(plan, budget, field, ids, ke, jit_rows,
                      k, c2w, ortho_scale)
             for budget, ids, ke, jit_rows in schedule.groups]
    return _compose_planes(
        plan, *(jnp.concatenate([p[i] for p in parts]) for i in range(5)))


def _empty_parts():
    """Zero-ray plane parts: composing them yields the background frame."""
    z = jnp.zeros((0,), jnp.float32)
    return (jnp.zeros((0,), jnp.int32), jnp.zeros((0, 3), jnp.float32),
            z, z, z)


def roi_hitmask(plan) -> jnp.ndarray:
    """(H, W) int32 hitmask from the ROI extent: every ROI pixel received a
    generated ray (img_cpu.cpp:169-176), so schedule-based renderers that
    skip provably-zero rays rebuild the hitmask geometrically."""
    roi = plan.roi
    ys = jax.lax.broadcasted_iota(jnp.int32, (plan.height, plan.width), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (plan.height, plan.width), 1)
    in_roi = ((ys >= roi.y) & (ys < roi.y + roi.height)
              & (xs >= roi.x) & (xs < roi.x + roi.width))
    return in_roi.astype(jnp.int32)


def _compose_planes(plan, pids, rad, tr, op, dep):
    planes = compose(pids, rad, tr, op, dep, plan.width, plan.height,
                     plan.t_far, unique_pixels=True)
    # Rays that miss the bbox entirely are never rendered; their pixels keep
    # the zero-contribution background, which matches the full render.
    return ImagePlanes(
        image=planes.image,
        transmittance=planes.transmittance,
        opacity=planes.opacity,
        depth=planes.depth,
        hitmask=roi_hitmask(plan),
    )


_compose_groups = functools.partial(jax.jit, static_argnums=0)(
    _compose_planes)


# ---------------------------------------------------------------------------
# Multi-view stack: V same-shape views merged into ONE windowed schedule.
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class WindowedStackSchedule:
    """All views' rays merged into one windowed schedule.

    Multi-view training steps that render V views through per-view
    schedules instantiate V copies of every pipeline op (the fit
    flagship: 8 views of 9216 rays each = 8 single-group renders + 8
    compose scatters per step). Rays are independent, so the merged
    schedule treats global ray id ``v*N + i`` as one ray set: length-
    sorted 32k blocks span VIEWS, one pipeline instance per block, one
    compose onto a (V*H, W) canvas (for full-frame ROIs the global ray
    id IS the stacked pixel id: ``v*H*W + y*W + x``).

    Rays span multiple cameras, so each group carries its HOST-built ray
    planes (o, d (M, 3) f32 + per-ray t_far; ~2 MB at the fit flagship)
    instead of regenerating rays in-graph from one plan camera. Pad
    entries carry ``t_far == t_near`` (no samples) and a pixel id past
    the canvas (dropped by the compose scatter). Outputs are bit-exact
    vs the per-view windowed renders: budgets only extend windows with
    provably-zero OOB_ZERO samples, and the jitter rows are gathered
    with the same per-view keying (row = global id % N).
    """

    groups: tuple  # ((budget, ids, ke, jit|None, o, d, tf), ...) dev arrays
    n_views: int
    view_hw: tuple            # (H, W) of one view
    total_rays: int
    skipped_rays: int
    full_lattice_samples: int
    windowed_samples: int


def _wstack_flatten(s: "WindowedStackSchedule"):
    leaves = []
    budgets = []
    jit_present = []
    for budget, ids, ke, jit_rows, o, d, tf in s.groups:
        budgets.append(int(budget))
        jit_present.append(jit_rows is not None)
        leaves.extend([ids, ke])
        if jit_rows is not None:
            leaves.append(jit_rows)
        leaves.extend([o, d, tf])
    aux = (tuple(budgets), tuple(jit_present), s.n_views, s.view_hw,
           s.total_rays, s.skipped_rays, s.full_lattice_samples,
           s.windowed_samples)
    return leaves, aux


def _wstack_unflatten(aux, leaves):
    (budgets, jit_present, n_views, view_hw, total, skipped, full,
     windowed) = aux
    it = iter(leaves)
    groups = []
    for budget, has_jit in zip(budgets, jit_present):
        ids = next(it)
        ke = next(it)
        jit_rows = next(it) if has_jit else None
        o = next(it)
        d = next(it)
        tf = next(it)
        groups.append((budget, ids, ke, jit_rows, o, d, tf))
    return WindowedStackSchedule(
        groups=tuple(groups), n_views=n_views, view_hw=view_hw,
        total_rays=total, skipped_rays=skipped,
        full_lattice_samples=full, windowed_samples=windowed)


jax.tree_util.register_pytree_node(
    WindowedStackSchedule, _wstack_flatten, _wstack_unflatten)


def build_stack_schedule(plans, bbox_min, bbox_max, block: int = 32768,
                         jitter: np.ndarray | None = None
                         ) -> WindowedStackSchedule:
    """Build the merged multi-view windowed schedule (see
    :class:`WindowedStackSchedule`). ``plans``: same-shape full-frame
    plans differing only in camera; ``jitter``: ONE (N, K) host table
    shared by every view (the per-view builder's behavior)."""
    p0 = plans[0]
    n = p0.ray_count
    for p in plans:
        check(p.width == p0.width and p.height == p0.height
              and p.roi == p0.roi and p.ray_count == n
              and p.roi.width == p.width and p.roi.height == p.height,
              "stack schedule requires same-shape full-frame plans")
    v_cnt = len(plans)
    o_all = np.zeros((v_cnt * n, 3), np.float32)
    d_all = np.zeros((v_cnt * n, 3), np.float32)
    ke_all = np.zeros(v_cnt * n, np.int32)
    kc_all = np.zeros(v_cnt * n, np.int32)
    for v, p in enumerate(plans):
        o_v, d_v = _host_rays(p)
        ke_v, kc_v = _windows(p, bbox_min, bbox_max)
        o_all[v * n:(v + 1) * n] = o_v
        d_all[v * n:(v + 1) * n] = d_v
        ke_all[v * n:(v + 1) * n] = ke_v
        kc_all[v * n:(v + 1) * n] = kc_v
    vn = v_cnt * n
    if jitter is not None:
        jitter = np.asarray(jitter, np.float32)

    live = np.nonzero(kc_all > 0)[0]
    order = live[np.argsort(-kc_all[live], kind="stable")]
    groups = []
    windowed = 0
    pad_base = vn
    for start in range(0, order.size, block):
        ids = order[start:start + block]
        budget = int(kc_all[ids].max())
        budget = min(-(-budget // _STEP_QUANTUM) * _STEP_QUANTUM,
                     p0.sampling.max_steps)
        group_size = min(block, -(-ids.size // 256) * 256)
        n_pad = group_size - ids.size
        if n_pad:
            pad = np.arange(pad_base, pad_base + n_pad)
            pad_base += n_pad
            ids = np.concatenate([ids, pad])
        real = ids < vn
        safe = np.minimum(ids, vn - 1)
        ke = np.where(real, ke_all[safe], 0).astype(np.int32)
        o_g = np.where(real[:, None], o_all[safe], 0.0).astype(np.float32)
        d_g = np.where(real[:, None], d_all[safe], 0.0).astype(np.float32)
        tf = np.where(real, np.float32(p0.t_far),
                      np.float32(p0.t_near)).astype(np.float32)
        jit_rows = None
        if jitter is not None:
            rows = np.minimum(safe % n, jitter.shape[0] - 1)
            cols = np.minimum(ke[:, None] + np.arange(budget)[None, :],
                              jitter.shape[1] - 1)
            jit_rows = jitter[rows[:, None], cols]
        groups.append((budget, ids.astype(np.int32), ke, jit_rows,
                       o_g, d_g, tf))
        windowed += ids.size * budget

    # one batched upload (see utils/pytree.py::device_put_tree)
    from dvren_tpu.utils.pytree import device_put_tree
    return device_put_tree(WindowedStackSchedule(
        groups=tuple(groups),
        n_views=v_cnt,
        view_hw=(p0.height, p0.width),
        total_rays=vn,
        skipped_rays=vn - int(live.size),
        full_lattice_samples=vn * p0.sampling.max_steps,
        windowed_samples=windowed))


def _stack_group_outputs(plan, budget, field, ids, k_enter, block_jitter,
                         o, d, tf):
    from dvren_tpu.ops.raygen import Rays

    m = ids.shape[0]
    rays = Rays(origins=o, directions=d,
                t_near=jnp.full((m,), plan.t_near, jnp.float32),
                t_far=tf, pixel_ids=ids)
    ray_offset = 0
    if block_jitter is None:
        # in-graph stratified emulation keys on the PER-VIEW ray id
        # (every view draws the same jitter pattern, matching the
        # per-view builder's shared table)
        n = plan.ray_count
        ray_offset = (ids % n) - jnp.arange(m, dtype=jnp.int32)
    lattice = generate_samples(plan, rays, ray_index_offset=ray_offset,
                               jitter=block_jitter,
                               step_offset=k_enter, num_steps=budget)
    sigma, color = eval_fields(field, lattice)
    t_origin = plan.t_near + k_enter.astype(jnp.float32) * plan.sampling.dt
    intl = integrate(sigma, color, lattice.dt, lattice.mask,
                     plan.t_near, plan.t_far, with_aux=False,
                     t_cursor_origin=t_origin)
    return (rays.pixel_ids, intl.radiance, intl.transmittance,
            intl.opacity, intl.depth)


def render_windowed_stack(plan: Plan, field,
                          schedule: WindowedStackSchedule,
                          remat: bool | None = None) -> jnp.ndarray:
    """Traced multi-view render through the merged schedule: returns the
    (V, H, W, 3) radiance stack. Bit-exact vs stacking per-view
    :func:`render_windowed_traced` images (tests/test_windowed.py).
    ``plan``: any one of the views' plans (static facts only - the rays
    are baked in the schedule)."""
    check(getattr(field, "oob", OobPolicy.ZERO) == OobPolicy.ZERO,
          "window clipping requires an OOB_ZERO field (outside samples "
          "must be exactly zero)")
    if remat is None:
        remat = schedule.windowed_samples * 200 > remat_residual_budget()
    group_fn = jax.checkpoint(_stack_group_outputs, static_argnums=(0, 1)) \
        if remat else _stack_group_outputs
    v_cnt = schedule.n_views
    h, w = schedule.view_hw
    if not schedule.groups:
        return jnp.zeros((v_cnt, h, w, 3), jnp.float32)
    parts = [group_fn(plan, budget, field, ids, ke, jit_rows, o, d, tf)
             for budget, ids, ke, jit_rows, o, d, tf in schedule.groups]
    pids, rad, tr, op, dep = (
        jnp.concatenate([p[i] for p in parts]) for i in range(5))
    planes = compose(pids, rad, tr, op, dep, w, v_cnt * h,
                     plan.t_far, unique_pixels=True)
    return planes.image.reshape(v_cnt, h, w, 3)
