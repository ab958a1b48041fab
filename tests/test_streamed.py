"""Tiled streaming render == whole-frame render (the fixed-workspace
production path; parity analogue of the reference's staged/fused/graph
three-way test, tests/core/test_core.cpp:27-167)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dvren_tpu import (
    CameraConfig, DenseGridConfig, DenseGridField, Plan, PlanConfig,
    SamplingConfig, SamplingMode,
)
from dvren_tpu.render.pipeline import (default_ray_tile, render,
                                       render_streamed, stream_needs_remat)


def scene(mode=SamplingMode.FIXED, width=20, height=14):
    rng = np.random.default_rng(0)
    n = 8
    plan = Plan.create(PlanConfig(
        width=width, height=height, t_near=0.3, t_far=2.3, seed=11,
        camera=CameraConfig(
            k=(width * 1.3, 0, width / 2, 0, width * 1.3, height / 2,
               0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=SamplingConfig(dt=0.08, max_steps=26, mode=mode)))
    field = DenseGridField.create(DenseGridConfig(
        resolution=(n, n, n),
        sigma=rng.uniform(0.5, 6.0, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3)))
    return plan, field


def assert_planes_match(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a.image), np.asarray(b.image),
                               atol=tol)
    np.testing.assert_allclose(np.asarray(a.transmittance),
                               np.asarray(b.transmittance), atol=tol)
    np.testing.assert_allclose(np.asarray(a.opacity),
                               np.asarray(b.opacity), atol=tol)
    np.testing.assert_allclose(np.asarray(a.depth), np.asarray(b.depth),
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(a.hitmask),
                                  np.asarray(b.hitmask))


def test_streamed_matches_whole_frame_divisible():
    plan, field = scene()
    whole = render(plan, field).planes
    tiled = render_streamed(plan, field, ray_tile=70)  # 280 rays / 70
    assert_planes_match(tiled, whole)


def test_streamed_matches_with_padding_tile():
    plan, field = scene()
    tiled = render_streamed(plan, field, ray_tile=96)  # 280 = 2*96 + 88
    whole = render(plan, field).planes
    assert_planes_match(tiled, whole)


def test_streamed_stratified_jitter_parity():
    """Tiling must not change the stratified sample positions (jitter keyed
    on global ray index, samp_cpu.cpp:233)."""
    plan, field = scene(mode=SamplingMode.STRATIFIED)
    whole = render(plan, field).planes
    tiled = render_streamed(plan, field, ray_tile=50)
    assert_planes_match(tiled, whole)


def test_streamed_gradients_match():
    plan, field = scene()
    target = jnp.zeros((plan.height, plan.width, 3))

    def loss_whole(params):
        f = field.with_params(*params)
        return jnp.mean((render(plan, f).planes.image - target) ** 2)

    def loss_tiled(params):
        f = field.with_params(*params)
        img = render_streamed(plan, f, ray_tile=64).image
        return jnp.mean((img - target) ** 2)

    params = (field.sigma, field.color)
    g_whole = jax.grad(loss_whole)(params)
    g_tiled = jax.grad(loss_tiled)(params)
    np.testing.assert_allclose(np.asarray(g_tiled[0]),
                               np.asarray(g_whole[0]), rtol=1e-4, atol=1e-8)
    np.testing.assert_allclose(np.asarray(g_tiled[1]),
                               np.asarray(g_whole[1]), rtol=1e-4, atol=1e-8)


def test_default_ray_tile_bounds():
    plan, _ = scene()
    tile = default_ray_tile(plan)
    assert 1 <= tile <= plan.ray_count
    big = Plan.create(PlanConfig(
        width=512, height=512, t_near=0.0, t_far=2.0,
        sampling=SamplingConfig(dt=0.02, max_steps=128)))
    assert default_ray_tile(big) * 128 <= (1 << 22)


@pytest.mark.parametrize("remat", [True, False])
def test_streamed_gradients_same_with_and_without_remat(remat):
    """Remat only changes what the backward stores, never the gradient; the
    default (size-based) choice keeps residuals at this size."""
    plan, field = scene(mode=SamplingMode.STRATIFIED)
    assert not stream_needs_remat(plan)

    def grads(remat_arg):
        def loss(params):
            f = field.with_params(*params)
            return jnp.sum(render_streamed(plan, f, ray_tile=64,
                                           remat=remat_arg).image ** 2)
        return jax.grad(loss)((field.sigma, field.color))

    # recomputation may fuse differently: 1e-4 of the largest entry
    # (gradient_adjoint_rtol in tests/thresholds.yaml)
    for got, want in zip(grads(remat), grads(None)):
        want = np.asarray(want)
        np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("width,steps,budget,want", [
    (20, 26, None, False),          # test scene, default budget
    (512, 128, None, True),         # 33.5 M samples: over the CPU's 4 GiB
    (512, 128, 15 << 30, False),    # ... within a quarter of an 80 GB card
    (800, 256, 15 << 30, True),     # 164 M samples: the SDF-shell frame
    (1024, 64, 15 << 30, True),     # 67 M samples
])
def test_stream_needs_remat_by_frame_size(width, steps, budget, want):
    plan = Plan.create(PlanConfig(
        width=width, height=width, t_near=0.0, t_far=2.0,
        sampling=SamplingConfig(dt=2.0 / steps, max_steps=steps)))
    assert stream_needs_remat(plan, budget) is want


def test_remat_budget_falls_back_to_4gib_without_a_device_limit():
    from dvren_tpu.render.pipeline import remat_residual_budget

    assert jax.devices()[0].memory_stats() is None   # the CPU reports none
    assert remat_residual_budget() == 4 << 30
