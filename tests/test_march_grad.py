"""The march kernel's custom VJP (recompute along the plain streamed path)
against ``jax.grad`` of the plain ``render``: voxel and camera gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvren_tpu import CameraModel, SamplingMode
from dvren_tpu.ops import march
from dvren_tpu.ops.raygen import camera_arrays
from dvren_tpu.render.pipeline import plan_jitter_table, render
from tests import march_cases as mc

CASES = [
    ("pinhole", "sigma"), ("pinhole", "color"), ("pinhole", "k"),
    ("pinhole", "c2w"), ("pinhole_fixed", "sigma"),
    ("ortho", "sigma"), ("ortho", "c2w"), ("ortho", "ortho_scale"),
]


def _setup(camera):
    if camera == "ortho":
        plan = mc.plan(width=12, height=10, model=CameraModel.ORTHOGRAPHIC,
                       ortho_scale=1.1)
    elif camera == "pinhole_fixed":
        plan = mc.plan(width=12, height=10, mode=SamplingMode.FIXED)
    else:
        plan = mc.plan(width=12, height=10)
    field = mc.field(shape=(6, 7, 5), blob=True, scale=6.0)
    jt = plan_jitter_table(plan)
    return plan, field, None if jt is None else jnp.asarray(jt)


def _loss(planes_fn, plan, field, jitter):
    rng = np.random.default_rng(5)
    w_img = jnp.asarray(rng.normal(size=(plan.height, plan.width, 3)),
                        jnp.float32)
    w_d = jnp.asarray(rng.normal(size=(plan.height, plan.width)),
                      jnp.float32)

    def loss(sigma, color, k, c2w, ortho):
        p = planes_fn(plan, field.with_params(sigma, color), k=k, c2w=c2w,
                      ortho_scale=ortho, jitter=jitter)
        return (jnp.sum(p.image * w_img) + 0.1 * jnp.sum(p.depth * w_d)
                + jnp.sum(p.opacity) - jnp.sum(p.transmittance))
    return loss


@pytest.mark.parametrize("camera,wrt", CASES)
def test_march_vjp_matches_plain_grad(camera, wrt):
    plan, field, jitter = _setup(camera)
    k, c2w, ortho = camera_arrays(plan)
    args = (field.sigma, field.color, k, c2w, ortho)
    arg = ("sigma", "color", "k", "c2w", "ortho_scale").index(wrt)

    def kernel(plan, f, **kw):
        return march.render_march(plan, f, interpret=True, **kw)

    def plain(plan, f, **kw):
        return render(plan, f, **kw).planes

    got = jax.grad(_loss(kernel, plan, field, jitter), argnums=arg)(*args)
    want = jax.grad(_loss(plain, plan, field, jitter), argnums=arg)(*args)
    want = np.asarray(want)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(np.asarray(got), want,
                               rtol=1e-4, atol=1e-5 * np.abs(want).max())


def test_march_vjp_under_jit_and_value_and_grad():
    plan, field, jitter = _setup("pinhole")
    target = jnp.zeros((plan.height, plan.width, 3), jnp.float32)

    def loss(params, render_fn):
        img = render_fn(plan, field.with_params(*params),
                        jitter=jitter).image
        return jnp.mean((img - target) ** 2)

    kern = jax.jit(jax.value_and_grad(lambda p: loss(
        p, lambda *a, **kw: march.render_march(*a, interpret=True, **kw))))
    plain = jax.jit(jax.value_and_grad(lambda p: loss(
        p, lambda *a, **kw: render(*a, **kw).planes)))
    params = (field.sigma, field.color)
    (lk, gk), (lp, gp) = kern(params), plain(params)
    np.testing.assert_allclose(float(lk), float(lp), rtol=1e-5)
    for a, b in zip(gk, gp):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
