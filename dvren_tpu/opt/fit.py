"""Differentiable grid fitting: Adam on voxel grids from multi-view renders.

The training-loop capability the reference only exercises one step of in its
tests (SURVEY.md section 3.2: "training loop = Forward -> loss grad ->
Backward -> user-side optimizer update -> recreate field"). Here the whole
step is one jit-compiled function: render -> MSE -> jax.grad into the field
pytree -> optax update. This is the BASELINE.json "64^3 grid fit to PSNR 35"
workload.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field as dc_field
from typing import Callable, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import optax

from dvren_tpu.core.plan import CameraConfig, Plan
from dvren_tpu.render.pipeline import render


@dataclass
class FitConfig:
    learning_rate: float = 5e-2
    steps: int = 500
    target_psnr: float | None = 35.0
    log_every: int = 50
    sigma_min: float = 0.0       # project sigma to >= 0 after each step
    sync_every: int = 1          # steps per device round trip: > 1 runs
    #                              lax.scan blocks of K optimizer steps
    #                              inside ONE dispatch, with one loss
    #                              fetch per block (the per-step loss
    #                              history is still complete). Target-PSNR
    #                              stop is checked per block.


@dataclass
class FitResult:
    field: object
    psnr_history: list[float] = dc_field(default_factory=list)
    loss_history: list[float] = dc_field(default_factory=list)
    steps_run: int = 0
    wall_clock_s: float = 0.0    # INCLUDES the schedule build
    schedule_build_s: float = 0.0  # host schedule build + upload
    first_step_s: float = 0.0    # includes jit compile / cache load
    steady_step_ms: float = 0.0  # mean of the remaining steps
    reached_target: bool = False
    mode: str = ""               # path actually used (see fit_dense_grid)


def mse(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean((pred - target) ** 2)


def psnr(loss: jnp.ndarray) -> jnp.ndarray:
    return -10.0 * jnp.log10(jnp.maximum(loss, 1e-12))


def render_views(plan: Plan, field, cameras: Sequence[CameraConfig]):
    """Render (V, H, W, 3) images for a list of camera poses (vmapped over
    the stacked c2w matrices; one compile for all views)."""
    c2ws = jnp.stack([jnp.asarray(c.c2w, jnp.float32).reshape(3, 4)
                      for c in cameras])

    def one(c2w):
        return render(plan, field, c2w=c2w).planes.image

    return jax.vmap(one)(c2ws)


def view_plans(plan: Plan, cameras: Sequence[CameraConfig]):
    """Per-view plans: the plan's camera with each view's pose."""
    from dataclasses import replace as _replace
    return [plan.with_camera(_replace(plan.camera, c2w=tuple(c.c2w)))
            for c in cameras]


def _project(params, sigma_min: float):
    """Keep density physical (sigma >= sigma_min); color in [0, 1].
    Runs inside the jitted step, so it costs no extra dispatch."""
    return (jnp.maximum(params[0], sigma_min), jnp.clip(params[1], 0.0, 1.0))


def _scheduled_views(plan: Plan, cameras: Sequence[CameraConfig], field,
                     mode: str):
    """Per-view plans, the device inputs a multi-view step replays, and a
    traced stack renderer (``render_stack(f, scheds) -> (V, H, W, 3)``).

    "plain": ``render`` vmapped over the stacked view poses.
    "windowed": ONE merged bbox-window schedule across views (bit-exact vs
    per-view renders), built on the host once."""
    from dvren_tpu.render.pipeline import plan_jitter_table

    plans = view_plans(plan, cameras)
    jitter = plan_jitter_table(plan)
    if mode == "plain":
        scheds = jnp.stack([jnp.asarray(c.c2w, jnp.float32).reshape(3, 4)
                            for c in cameras])

        def render_stack(f, c2ws):
            return jax.vmap(
                lambda c2w: render(plan, f, c2w=c2w).planes.image)(c2ws)
    elif mode == "windowed":
        from dvren_tpu.render.windowed import (build_stack_schedule,
                                               render_windowed_stack)
        scheds = build_stack_schedule(plans, field.bbox_min,
                                      field.bbox_max, jitter=jitter)

        def render_stack(f, scheds):
            return render_windowed_stack(plan, f, scheds)
    else:
        raise ValueError(f"unknown scheduled mode: {mode}")
    return plans, scheds, render_stack


def make_train_step_scheduled(plan: Plan, cameras: Sequence[CameraConfig],
                              field, optimizer, mode: str = "plain",
                              sigma_min: float = 0.0, views=None):
    """Fast-path training step: per-view inputs built once and replayed
    every step, one compiled executable for the whole multi-view step.

    ``mode``: "plain" (any grid) or "windowed" (bbox window replay,
    OOB_ZERO grids). The inputs depend on
    the poses and the field's bbox + resolution only, so they stay valid
    across parameter updates.
    """
    plans, scheds, render_stack = views or _scheduled_views(
        plan, cameras, field, mode)

    def loss_fn(params, field, targets, scheds):
        f = field.with_params(*params) if isinstance(params, tuple) \
            else field.with_params(params)
        return mse(render_stack(f, scheds), targets)

    # schedules cross the jit boundary as pytree ARGUMENTS (as closure
    # constants they would be embedded in the HLO as literals)
    @jax.jit
    def raw_step(params, field, opt_state, targets, scheds):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, field, targets, scheds)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = _project(optax.apply_updates(params, updates), sigma_min)
        return params, opt_state, loss

    def step(params, field, opt_state, targets):
        return raw_step(params, field, opt_state, targets, scheds)

    return step


def make_train_block_scheduled(plan: Plan, cameras: Sequence[CameraConfig],
                               field, optimizer, k: int,
                               mode: str = "plain",
                               sigma_min: float = 0.0, views=None):
    """K optimizer steps per dispatch: ``lax.scan`` over the scheduled
    step (one executable, one device round trip, K per-step losses).

    ``views``: a prebuilt ``_scheduled_views`` result, so several block
    lengths (e.g. the remainder block when ``steps % sync_every != 0``)
    share one host schedule build."""
    plans, scheds, render_stack = views or _scheduled_views(
        plan, cameras, field, mode)

    def loss_fn(params, field, targets, scheds):
        f = field.with_params(*params) if isinstance(params, tuple) \
            else field.with_params(params)
        return mse(render_stack(f, scheds), targets)

    @jax.jit
    def raw_block(params, field, opt_state, targets, scheds):
        def body(carry, _):
            p, o = carry
            loss, grads = jax.value_and_grad(loss_fn)(
                p, field, targets, scheds)
            updates, o = optimizer.update(grads, o, p)
            p = _project(optax.apply_updates(p, updates), sigma_min)
            return (p, o), loss
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), None, length=k)
        return params, opt_state, losses

    def block(params, field, opt_state, targets):
        return raw_block(params, field, opt_state, targets, scheds)

    return block


def fit_hash_mlp(plan: Plan, field, cameras: Sequence[CameraConfig],
                 targets: np.ndarray, config: FitConfig | None = None,
                 checkpoint_cb: Callable | None = None) -> FitResult:
    """Fit a HashMLPField (hash table + both MLP heads) to target views
    with Adam, through ``jax.grad`` of the plain ``render`` (the
    reference's hash-MLP is forward-only, hash_mlp_cpu.cpp)."""
    config = config or FitConfig()
    optimizer = optax.adam(config.learning_rate)
    params = field.params
    opt_state = optimizer.init(params)
    t_build0 = time.perf_counter()
    c2ws = jnp.stack([jnp.asarray(c.c2w, jnp.float32).reshape(3, 4)
                      for c in cameras])
    targets = jnp.asarray(targets, jnp.float32)

    def loss_fn(params, c2ws, targets):
        f = field.with_params(params)
        pred = jax.vmap(
            lambda c2w: render(plan, f, c2w=c2w).planes.image)(c2ws)
        return mse(pred, targets)

    @functools.partial(jax.jit, static_argnums=(4,))
    def raw_block(params, opt_state, targets, c2ws, k):
        def body(carry, _):
            p, o = carry
            loss, grads = jax.value_and_grad(loss_fn)(p, c2ws, targets)
            updates, o = optimizer.update(grads, o, p)
            return (optax.apply_updates(p, updates), o), loss
        (params, opt_state), losses = jax.lax.scan(
            body, (params, opt_state), None, length=k)
        return params, opt_state, losses

    result = FitResult(field=field, mode="plain")
    result.schedule_build_s = time.perf_counter() - t_build0
    k = max(int(config.sync_every), 1)
    t0 = time.perf_counter()
    n_full, rem = divmod(config.steps, k)
    blocks = [k] * n_full + ([rem] if rem else [])
    ckpts_fired = 0
    for i, blk in enumerate(blocks):
        params, opt_state, loss = raw_block(
            params, opt_state, targets, c2ws, blk)
        if i == 0:
            jax.block_until_ready(loss)
            result.first_step_s = time.perf_counter() - t0
        losses = np.asarray(loss, np.float64).reshape(-1)
        ps = [float(psnr(jnp.float32(lf))) for lf in losses]
        result.loss_history.extend(float(lf) for lf in losses)
        result.psnr_history.extend(ps)
        result.steps_run += blk
        if checkpoint_cb is not None:
            due = result.steps_run // max(config.log_every, 1)
            if due > ckpts_fired:
                ckpts_fired = due
                checkpoint_cb(field.with_params(params),
                              result.steps_run, ps[-1])
        if config.target_psnr is not None and ps[-1] >= config.target_psnr:
            result.reached_target = True
            break
    steps_s = time.perf_counter() - t0
    result.wall_clock_s = result.schedule_build_s + steps_s
    if result.steps_run > blocks[0]:
        result.steady_step_ms = ((steps_s - result.first_step_s)
                                 / (result.steps_run - blocks[0]) * 1e3)
    result.field = field.with_params(params)
    return result


def fit_dense_grid(plan: Plan, field, cameras: Sequence[CameraConfig],
                   targets: np.ndarray, config: FitConfig | None = None,
                   checkpoint_cb: Callable | None = None,
                   mode: str | None = None) -> FitResult:
    """Fit a DenseGridField's sigma+color to target views with Adam.

    targets: (V, H, W, 3) float32 ground-truth images.
    ``mode``: "plain" (default) or "windowed".

    Training never takes the march kernel (ops/march.py): its backward
    recomputes the plain lattice, so a kernel train step costs a plain
    step plus the kernel forward. On an H100 at this workload's shape
    (8 views at 96^2 over 64^3) the kernel route's step took 6.36 ms and
    the plain step 5.13 ms.
    """
    config = config or FitConfig()
    optimizer = optax.adam(config.learning_rate)
    params = (field.sigma, field.color)
    opt_state = optimizer.init(params)
    mode = mode or "plain"
    t_build0 = time.perf_counter()
    views = _scheduled_views(plan, cameras, field, mode)
    k = max(int(config.sync_every), 1)
    if k > 1:
        step = make_train_block_scheduled(plan, cameras, field, optimizer,
                                          k, mode=mode,
                                          sigma_min=config.sigma_min,
                                          views=views)
    else:
        step = make_train_step_scheduled(plan, cameras, field, optimizer,
                                         mode=mode,
                                         sigma_min=config.sigma_min,
                                         views=views)
    targets = jnp.asarray(targets, jnp.float32)

    result = FitResult(field=field, mode=mode)
    result.schedule_build_s = time.perf_counter() - t_build0
    t0 = time.perf_counter()
    # Run EXACTLY config.steps optimizer steps: full k-step blocks plus
    # one remainder block (its own compiled executable - scan length is
    # static) when k does not divide steps.
    n_full, rem = divmod(config.steps, k)
    step_rem = None
    if rem and k > 1:
        step_rem = make_train_block_scheduled(
            plan, cameras, field, optimizer, rem, mode=mode,
            sigma_min=config.sigma_min, views=views)
    ckpts_fired = 0
    for i in range(n_full + (1 if rem else 0)):
        last = i == n_full  # the remainder block, if any
        blk = rem if (last and step_rem is not None) else k
        fn = step_rem if (last and step_rem is not None) else step
        # The (sigma >= 0, color in [0,1]) projection runs inside the
        # jitted step.
        params, opt_state, loss = fn(params, field, opt_state, targets)
        if i == 0:
            jax.block_until_ready(loss)
            result.first_step_s = time.perf_counter() - t0
        losses = (np.asarray(loss, np.float64).reshape(-1) if k > 1
                  else np.asarray([float(loss)]))
        ps = [float(psnr(jnp.float32(lf))) for lf in losses]
        result.loss_history.extend(float(lf) for lf in losses)
        result.psnr_history.extend(ps)
        result.steps_run += blk
        if checkpoint_cb is not None:
            # cadence in STEPS (blocks may be > 1 step each)
            due = result.steps_run // max(config.log_every, 1)
            if due > ckpts_fired:
                ckpts_fired = due
                checkpoint_cb(field.with_params(*params),
                              result.steps_run, ps[-1])
        if config.target_psnr is not None and ps[-1] >= config.target_psnr:
            result.reached_target = True
            break
    steps_s = time.perf_counter() - t0
    # wall_clock INCLUDES the schedule build (capture specialization is
    # part of the cost of a fit, exactly as CUDA-Graph capture would be)
    result.wall_clock_s = result.schedule_build_s + steps_s
    if result.steps_run > k:
        result.steady_step_ms = (
            (steps_s - result.first_step_s)
            / (result.steps_run - k) * 1e3)
    result.field = field.with_params(*params)
    return result
