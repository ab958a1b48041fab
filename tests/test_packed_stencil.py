"""Packed-stencil trilinear fast path == reference trilinear, fwd and bwd."""

import numpy as np
import jax
import jax.numpy as jnp

from dvren_tpu.core.plan import InterpMode, OobPolicy
from dvren_tpu.ops.grid import (
    build_packed_stencil, eval_grid_planes, eval_packed_trilinear)


def scene(seed=0, shape=(6, 7, 8)):
    rng = np.random.default_rng(seed)
    sigma = jnp.asarray(rng.uniform(0, 5, shape), jnp.float32)
    color = jnp.asarray(rng.uniform(0, 1, shape + (3,)), jnp.float32)
    pts = rng.uniform(-0.2, 1.2, (3, 500)).astype(np.float32)
    return sigma, color, (jnp.asarray(pts[0]), jnp.asarray(pts[1]),
                          jnp.asarray(pts[2]))


def test_forward_matches_plain_trilinear():
    sigma, color, (px, py, pz) = scene()
    for oob in (OobPolicy.ZERO, OobPolicy.CLAMP):
        packed = build_packed_stencil(sigma, color)
        s, r, g, b = eval_packed_trilinear(
            packed, sigma.shape, px, py, pz, (0, 0, 0), (1, 1, 1), oob)
        s_ref = eval_grid_planes(sigma, px, py, pz, (0, 0, 0), (1, 1, 1),
                                 InterpMode.LINEAR, oob)
        c_ref = eval_grid_planes(color, px, py, pz, (0, 0, 0), (1, 1, 1),
                                 InterpMode.LINEAR, oob)
        np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                                   rtol=1e-6, atol=1e-7)
        for got, want in zip((r, g, b), c_ref):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)


def test_upper_edge_exact():
    """fx == n-1 must select the boundary voxel exactly (base n-2, t=1)."""
    sigma, color, _ = scene(shape=(4, 4, 4))
    packed = build_packed_stencil(sigma, color)
    pts = jnp.asarray([1.0]), jnp.asarray([1.0]), jnp.asarray([1.0])
    s, *_ = eval_packed_trilinear(packed, sigma.shape, *pts,
                                  (0, 0, 0), (1, 1, 1))
    assert float(s[0]) == float(sigma[3, 3, 3])


def test_gradients_match_plain_path():
    sigma, color, (px, py, pz) = scene(seed=3)
    g_out = jnp.asarray(
        np.random.default_rng(4).uniform(-1, 1, (4, px.shape[0])),
        jnp.float32)

    def loss_packed(sig, col):
        packed = build_packed_stencil(sig, col)
        outs = eval_packed_trilinear(packed, sig.shape, px, py, pz,
                                     (0, 0, 0), (1, 1, 1))
        return sum(jnp.vdot(o, g_out[i]) for i, o in enumerate(outs))

    def loss_plain(sig, col):
        s = eval_grid_planes(sig, px, py, pz, (0, 0, 0), (1, 1, 1))
        c = eval_grid_planes(col, px, py, pz, (0, 0, 0), (1, 1, 1))
        return (jnp.vdot(s, g_out[0]) + jnp.vdot(c[0], g_out[1])
                + jnp.vdot(c[1], g_out[2]) + jnp.vdot(c[2], g_out[3]))

    gp = jax.grad(loss_packed, argnums=(0, 1))(sigma, color)
    gr = jax.grad(loss_plain, argnums=(0, 1))(sigma, color)
    np.testing.assert_allclose(np.asarray(gp[0]), np.asarray(gr[0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(gp[1]), np.asarray(gr[1]),
                               rtol=1e-5, atol=1e-6)


def test_render_pipeline_uses_packed_path():
    """End-to-end forward through render() (which selects the packed path
    for trilinear dense grids) still matches the independent oracle - see
    tests/test_forward_oracle.py which exercises this; here check the
    selection logic."""
    from dvren_tpu import DenseGridConfig, DenseGridField

    f_lin = DenseGridField.create(DenseGridConfig(
        resolution=(4, 4, 4), sigma=np.ones(64), color=np.ones(192)))
    assert f_lin.supports_packed_eval
    f_near = DenseGridField.create(DenseGridConfig(
        resolution=(4, 4, 4), sigma=np.ones(64), color=np.ones(192),
        interp=InterpMode.NEAREST))
    assert not f_near.supports_packed_eval
    f_thin = DenseGridField.create(DenseGridConfig(
        resolution=(1, 4, 4), sigma=np.ones(16), color=np.ones(48)))
    assert not f_thin.supports_packed_eval


def test_take_rows_exact_bitwise_and_vjp():
    """The u16 hi/lo gather (ops/grid.py::take_rows_exact) returns the
    identical 32 bits as a plain f32 row gather, and its custom VJP is the
    standard scatter-add (matching jnp.take's transpose exactly)."""
    from dvren_tpu.ops.grid import take_rows_exact

    rng = np.random.default_rng(9)
    table = jnp.asarray(np.float32(rng.standard_normal((257, 32)) * 1e3))
    idx = jnp.asarray(rng.integers(0, 257, size=(1000,)).astype(np.int32))

    fast = take_rows_exact(table, idx)
    ref = jnp.take(table, idx, axis=0)
    assert np.asarray(fast).tobytes() == np.asarray(ref).tobytes()

    ct = jnp.asarray(np.float32(rng.standard_normal((1000, 32))))
    g_fast = jax.grad(lambda t: jnp.vdot(take_rows_exact(t, idx), ct))(table)
    g_ref = jax.grad(lambda t: jnp.vdot(jnp.take(t, idx, axis=0), ct))(table)
    np.testing.assert_array_equal(np.asarray(g_fast), np.asarray(g_ref))


def test_take_rows_exact_out_of_range_clips_fwd_and_bwd():
    from dvren_tpu.ops.grid import take_rows_exact

    table = jnp.asarray(np.arange(12, dtype=np.float32).reshape(3, 4))
    idx = jnp.asarray(np.int32([0, 5]))  # 5 clips to the last row
    fast = take_rows_exact(table, idx)
    ref = jnp.take(table, idx, axis=0, mode="clip")
    assert np.asarray(fast).tobytes() == np.asarray(ref).tobytes()

    ct = jnp.ones((2, 4), jnp.float32)
    g_fast = jax.grad(lambda t: jnp.vdot(take_rows_exact(t, idx), ct))(table)
    g_ref = jax.grad(
        lambda t: jnp.vdot(jnp.take(t, idx, axis=0, mode="clip"), ct))(table)
    np.testing.assert_array_equal(np.asarray(g_fast), np.asarray(g_ref))
    assert np.asarray(g_fast)[2].sum() == 4.0  # OOB cotangent landed on edge
