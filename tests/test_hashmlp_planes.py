"""Features-leading hash-MLP eval (one-hot encode) ==
the reference-layout eval, values and gradients."""

import numpy as np
import jax
import jax.numpy as jnp

from dvren_tpu.fields.hash_mlp import HashMLPConfig, HashMLPField
from dvren_tpu.ops.hashmlp import (
    HashMLPSpec, eval_color, eval_planes, eval_sigma)

SPEC = HashMLPSpec()


def field(seed=0):
    rng = np.random.default_rng(seed)
    return HashMLPField.create(HashMLPConfig(
        params=rng.uniform(-0.5, 0.5, SPEC.param_count).astype(np.float32)))


def coords(seed=1, n=200):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.uniform(0, 1, n), jnp.float32)
                 for _ in range(3))


def test_planes_match_reference_layout():
    f = field()
    px, py, pz = coords()
    pos = jnp.stack([px, py, pz], axis=-1)
    s_ref = eval_sigma(pos, f.params, SPEC)
    c_ref = eval_color(pos, f.params, SPEC)
    s, r, g, b = eval_planes(px, py, pz, f.params, SPEC)
    np.testing.assert_allclose(np.asarray(s), np.asarray(s_ref),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r), np.asarray(c_ref[..., 0]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(g), np.asarray(c_ref[..., 1]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(b), np.asarray(c_ref[..., 2]),
                               rtol=1e-5, atol=1e-6)


def test_planes_gradients_match():
    f = field(seed=2)
    px, py, pz = coords(seed=3, n=64)
    pos = jnp.stack([px, py, pz], axis=-1)

    def loss_planes(params):
        s, r, g, b = eval_planes(px, py, pz, params, SPEC)
        return jnp.sum(s ** 2) + jnp.sum(r + 2 * g + 3 * b)

    def loss_ref(params):
        s = eval_sigma(pos, params, SPEC)
        c = eval_color(pos, params, SPEC)
        return jnp.sum(s ** 2) + jnp.sum(
            c[..., 0] + 2 * c[..., 1] + 3 * c[..., 2])

    gp = jax.grad(loss_planes)(f.params)
    gr = jax.grad(loss_ref)(f.params)
    for k in gp:
        np.testing.assert_allclose(np.asarray(gp[k]), np.asarray(gr[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_render_uses_single_pass():
    from dvren_tpu import Plan, PlanConfig, SamplingConfig
    from dvren_tpu.render.pipeline import render

    f = field(seed=4)
    assert f.supports_packed_eval
    plan = Plan.create(PlanConfig(
        width=6, height=6, t_near=0.2, t_far=1.8,
        sampling=SamplingConfig(dt=0.1, max_steps=16)))
    out = render(plan, f)
    assert np.isfinite(np.asarray(out.planes.image)).all()
