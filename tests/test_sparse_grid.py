"""Sparse brick-grid field: exactness vs dense (threshold 0), sparsity
accounting, and rendering + brick-table gradients through the plain
pipeline (sparse fields never take the march kernel)."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from dvren_tpu import (
    CameraConfig, Context, DenseGridConfig, DenseGridField, Plan, PlanConfig,
    Renderer, SamplingConfig,
)
from dvren_tpu.fields.sparse_grid import SparseGridField
from dvren_tpu.ops import march
from dvren_tpu.render.pipeline import render


def blob_field(n=20, compact=True):
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    r2 = (xs - 0.3) ** 2 + (ys - 0.3) ** 2 + (zs - 0.3) ** 2
    sigma = 15.0 * np.exp(-r2 / (0.004 if compact else 0.1))
    sigma[sigma < 1e-3] = 0.0  # truly empty space
    color = np.stack([xs, ys, zs], axis=-1)
    return DenseGridField.create(DenseGridConfig(
        resolution=(n, n, n), sigma=sigma.astype(np.float32).reshape(-1),
        color=color.astype(np.float32).reshape(-1)))


def test_eval_exact_vs_dense_threshold_zero():
    dense = blob_field()
    sparse = SparseGridField.from_dense(dense, threshold=0.0)
    rng = np.random.default_rng(0)
    px, py, pz = (jnp.asarray(rng.uniform(-0.1, 1.1, 300), jnp.float32)
                  for _ in range(3))
    ds, dr, dg, db = dense.packed_eval_planes(px, py, pz)
    ss, sr, sg, sb = sparse.packed_eval_planes(px, py, pz)
    # sigma matches everywhere; color matches wherever density is nonzero
    # (dropped zero-density bricks also drop their never-visible color)
    np.testing.assert_allclose(np.asarray(ss), np.asarray(ds),
                               rtol=1e-6, atol=1e-7)
    lit = np.asarray(ds) > 0
    assert lit.any()
    for a, b in ((sr, dr), (sg, dg), (sb, db)):
        np.testing.assert_allclose(np.asarray(a)[lit], np.asarray(b)[lit],
                                   rtol=1e-6, atol=1e-7)


def test_sparsity_drops_empty_bricks():
    sparse = SparseGridField.from_dense(blob_field(compact=True),
                                        threshold=0.0)
    assert sparse.occupied_bricks < sparse.total_bricks
    assert sparse.occupied_bricks >= 1
    # memory strictly below the dense packed table
    n = sparse.grid_shape[0]
    dense_packed_bytes = (n - 1) ** 3 * 32 * 4
    assert sparse.memory_bytes() < dense_packed_bytes


def test_render_pipeline_with_sparse_field():
    dense = blob_field()
    sparse = SparseGridField.from_dense(dense, threshold=0.0)
    plan = Plan.create(PlanConfig(
        width=12, height=10, t_near=0.2, t_far=2.2,
        camera=CameraConfig(
            k=(14.0, 0, 6.0, 0, 14.0, 5.0, 0, 0, 1),
            c2w=(1, 0, 0, 0.3, 0, 1, 0, 0.3, 0, 0, 1, -1.0)),
        sampling=SamplingConfig(dt=0.05, max_steps=40)))
    out_d = render(plan, dense).planes
    out_s = render(plan, sparse).planes
    np.testing.assert_allclose(np.asarray(out_s.image),
                               np.asarray(out_d.image), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out_s.depth),
                               np.asarray(out_d.depth), atol=1e-5)


def test_renderer_forward_with_sparse_field():
    dense = blob_field()
    sparse = SparseGridField.from_dense(dense, threshold=0.0)
    plan = Plan.create(PlanConfig(
        width=8, height=8, t_near=0.2, t_far=2.2,
        sampling=SamplingConfig(dt=0.1, max_steps=20)))
    fr = Renderer(Context.create(), plan).forward(sparse)
    assert np.isfinite(fr.image).all()


def _sparse_plan(width=48, height=32):
    return Plan.create(PlanConfig(
        width=width, height=height, t_near=0.2, t_far=2.6,
        camera=CameraConfig(
            k=(width * 1.25, 0, width / 2, 0, width * 1.25, height / 2,
               0, 0, 1),
            c2w=(1, 0, 0, 0.3, 0, 1, 0, 0.3, 0, 0, 1, -1.0)),
        sampling=SamplingConfig(dt=0.04, max_steps=60)))


def _assert_planes_close(a, b, tol=1e-5):
    np.testing.assert_allclose(np.asarray(a.image), np.asarray(b.image),
                               atol=tol)
    np.testing.assert_allclose(np.asarray(a.transmittance),
                               np.asarray(b.transmittance), atol=tol)
    np.testing.assert_allclose(np.asarray(a.depth), np.asarray(b.depth),
                               atol=1e-4)


@pytest.mark.parametrize("n,compact", [(20, False), (20, True),
                                       (21, False)])
def test_renderer_sparse_matches_dense(n, compact):
    """Threshold-0 bricks render exactly like the dense grid through the
    Renderer (plain route; odd grid sizes leave partial edge bricks)."""
    dense = blob_field(n=n, compact=compact)
    sparse = SparseGridField.from_dense(dense, threshold=0.0)
    assert not march.select_route(sparse, backend="gpu").kernel
    plan = _sparse_plan()
    fr = Renderer(Context.create(), plan).forward(sparse)
    full = render(plan, dense).planes
    np.testing.assert_allclose(
        fr.image.reshape(plan.height, plan.width, 3),
        np.asarray(full.image), atol=1e-5)
    np.testing.assert_allclose(
        fr.transmittance.reshape(plan.height, plan.width),
        np.asarray(full.transmittance), atol=1e-5)
    np.testing.assert_allclose(fr.depth.reshape(plan.height, plan.width),
                               np.asarray(full.depth), atol=1e-4)


def test_sparse_brick_gradient_directional():
    """jax.grad through the plain pipeline w.r.t. the brick table agrees
    with a central difference along a random direction."""
    dense = blob_field(compact=False)
    sparse = SparseGridField.from_dense(dense, threshold=0.0)
    plan = _sparse_plan(width=16, height=12)

    def loss(bricks):
        return jnp.sum(render(plan, sparse.with_params(bricks)).planes.image)

    g = jax.grad(loss)(sparse.bricks)
    assert np.isfinite(np.asarray(g)).all() and np.abs(g).max() > 0
    v = jnp.asarray(np.random.default_rng(3).normal(
        size=sparse.bricks.shape).astype(np.float32)) * 1e-2
    eps = 1e-1
    fd = (loss(sparse.bricks + eps * v) - loss(sparse.bricks - eps * v)) / (
        2 * eps)
    np.testing.assert_allclose(float(jnp.vdot(g, v)), float(fd), rtol=2e-2)


def test_bf16_bricks():
    dense = blob_field()
    sparse16 = SparseGridField.from_dense(dense, threshold=0.0,
                                          dtype="bfloat16")
    rng = np.random.default_rng(1)
    px, py, pz = (jnp.asarray(rng.uniform(0, 1, 100), jnp.float32)
                  for _ in range(3))
    s16 = np.asarray(sparse16.packed_eval_planes(px, py, pz)[0])
    s32 = np.asarray(dense.packed_eval_planes(px, py, pz)[0])
    assert np.abs(s16 - s32).max() < 0.1  # bf16 field precision
    assert sparse16.memory_bytes() < SparseGridField.from_dense(
        dense, threshold=0.0).memory_bytes()
