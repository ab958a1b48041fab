"""Multi-chip sharding on the virtual 8-device CPU mesh: ray-DP rendering
parity and view-DP training with explicit collectives."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from dvren_tpu import (
    CameraConfig, DenseGridConfig, DenseGridField, Plan, PlanConfig,
    SamplingConfig,
)
from dvren_tpu.parallel.mesh import make_mesh
from dvren_tpu.parallel.shard import (
    fit_dense_grid_dp, make_dp_train_step, render_sharded)
from dvren_tpu.render.pipeline import render

N_DEV = 8


def make_scene(width=16, height=16):
    rng = np.random.default_rng(1)
    n = 6
    plan = Plan.create(PlanConfig(
        width=width, height=height, t_near=0.3, t_far=2.3,
        camera=CameraConfig(
            k=(width * 1.4, 0, width / 2, 0, width * 1.4, height / 2,
               0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=SamplingConfig(dt=0.1, max_steps=20)))
    field = DenseGridField.create(DenseGridConfig(
        resolution=(n, n, n),
        sigma=rng.uniform(0.5, 5.0, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3)))
    return plan, field


def require_devices():
    if len(jax.devices()) < N_DEV:
        pytest.skip(f"needs {N_DEV} devices")


def test_mesh_creation():
    require_devices()
    mesh = make_mesh(N_DEV)
    assert mesh.devices.size == N_DEV
    assert mesh.axis_names == ("dp",)


def test_ray_sharded_render_matches_single_device():
    require_devices()
    plan, field = make_scene()
    mesh = make_mesh(N_DEV)
    sharded = render_sharded(plan, field, mesh)
    single = render(plan, field).planes
    np.testing.assert_allclose(np.asarray(sharded.image),
                               np.asarray(single.image), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sharded.depth),
                               np.asarray(single.depth), atol=1e-5)
    np.testing.assert_array_equal(np.asarray(sharded.hitmask),
                                  np.asarray(single.hitmask))


def test_dp_train_step_matches_single_device_grads():
    """pmean-combined multi-device gradient == single-device gradient."""
    require_devices()
    plan, field = make_scene(width=8, height=8)
    mesh = make_mesh(N_DEV)

    c2ws = jnp.stack([
        jnp.asarray((1, 0, 0, 0.5 + 0.02 * i, 0, 1, 0, 0.5, 0, 0, 1, -1.0),
                    jnp.float32).reshape(3, 4) for i in range(N_DEV)])
    targets = jnp.zeros((N_DEV, plan.height, plan.width, 3), jnp.float32)

    optimizer = optax.sgd(1.0)  # update == -grad, exposes the gradient
    params = (field.sigma, field.color)
    opt_state = optimizer.init(params)
    step = make_dp_train_step(plan, field, optimizer, mesh)
    with mesh:
        new_params, _, loss_dp = step(params, opt_state, c2ws, targets)
    grad_dp = (params[0] - new_params[0], params[1] - new_params[1])

    def loss_fn(p):
        f = field.with_params(*p)

        def one(c2w):
            return render(plan, f, c2w=c2w).planes.image

        pred = jax.vmap(one)(c2ws)
        return jnp.mean((pred - targets) ** 2)

    loss_single, grad_single = jax.value_and_grad(loss_fn)(params)
    assert float(loss_dp) == pytest.approx(float(loss_single), rel=1e-5)
    # grad recovered as param-delta: absolute floor is the f32 ulp of the
    # O(1) parameters (~1e-7), not the gradient magnitude
    np.testing.assert_allclose(np.asarray(grad_dp[0]),
                               np.asarray(grad_single[0]),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(grad_dp[1]),
                               np.asarray(grad_single[1]),
                               rtol=1e-4, atol=1e-6)


def test_fit_dense_grid_dp_reduces_loss():
    require_devices()
    plan, field = make_scene(width=8, height=8)
    mesh = make_mesh(N_DEV)
    cams = [CameraConfig(
        c2w=(1, 0, 0, 0.5 + 0.02 * i, 0, 1, 0, 0.5, 0, 0, 1, -1.0))
        for i in range(N_DEV)]
    targets = np.asarray(
        [np.asarray(render(plan, field,
                           c2w=jnp.asarray(c.c2w).reshape(3, 4)).planes.image)
         for c in cams])
    init = field.with_params(
        jnp.full_like(field.sigma, 1.0), jnp.full_like(field.color, 0.5))
    fitted, losses = fit_dense_grid_dp(
        plan, init, cams, targets, mesh, learning_rate=5e-2, steps=40)
    assert losses[-1] < losses[0] * 0.5


def test_view_count_must_divide_mesh():
    require_devices()
    plan, field = make_scene(width=8, height=8)
    mesh = make_mesh(N_DEV)
    cams = [CameraConfig(c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0))] * 3
    with pytest.raises(ValueError):
        fit_dense_grid_dp(plan, field, cams,
                          np.zeros((3, plan.height, plan.width, 3)), mesh)
