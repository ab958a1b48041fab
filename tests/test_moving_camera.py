"""Moving cameras and evolving fields: the camera is an ordinary traced
``c2w`` argument to ``render`` and to the march kernel, so an orbit replays
one executable with no per-pose schedule. Checked against the scalar
oracle (tests/oracle.py) and, for the kernel, against the plain path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvren_tpu import Context, Renderer
from dvren_tpu.ops import march, rng
from dvren_tpu.render.pipeline import plan_jitter_table, render
from tests import march_cases as mc
from tests import oracle

W = H = 16


def _blob(n=10, cx=0.5):
    zs, ys, xs = np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")
    sigma = (9.0 * np.exp(-((xs - cx) ** 2 + (ys - 0.5) ** 2
                            + (zs - 0.45) ** 2) / 0.05)).astype(np.float32)
    color = np.stack([xs, 1 - xs, np.full_like(xs, 0.5)],
                     axis=-1).astype(np.float32)
    return sigma, color


def _field(sigma, color):
    from dvren_tpu import DenseGridConfig, DenseGridField
    n = sigma.shape[0]
    return DenseGridField.create(DenseGridConfig(
        resolution=(n, n, n), sigma=sigma.reshape(-1),
        color=color.reshape(-1)))


def _oracle_check(plan, image, depth, c2w, sigma, color, seed_pixels=0,
                  n=6, img_tol=3e-3, depth_tol=1e-2):
    K = np.asarray(plan.camera.k).reshape(3, 3)
    pix = np.random.default_rng(seed_pixels)
    for px, py in zip(pix.integers(0, W, n), pix.integers(0, H, n)):
        px, py = int(px), int(py)
        o, d = oracle.pinhole_ray(px, py, K, c2w)
        ray = py * W + px
        exp = oracle.integrate_pixel(
            o, d, plan.t_near, plan.t_far, plan.sampling.dt,
            plan.sampling.max_steps, sigma, color, (0, 0, 0), (1, 1, 1),
            jitter_fn=lambda s, r=ray: rng.stratified_jitter_py(
                plan.seed, r, s))
        assert np.abs(image[py, px] - exp["radiance"]).max() < img_tol
        if exp["opacity"] > 1e-3:
            assert abs(depth[py, px] - exp["depth"]) < depth_tol


def _orbit_fn(plan, field, kernel):
    jitter = jnp.asarray(plan_jitter_table(plan))
    if kernel:
        return jax.jit(lambda f, c2w: march.render_march(
            plan, f, c2w=c2w, jitter=jitter, interpret=True))
    return jax.jit(lambda f, c2w: render(plan, f, c2w=c2w,
                                         jitter=jitter).planes)


@pytest.mark.parametrize("pose", range(len(mc.ORBIT)))
def test_orbit_pose_matches_oracle(pose):
    sigma, color = _blob()
    field = _field(sigma, color)
    plan = mc.plan(width=W, height=H)
    c2w = mc.ORBIT[pose]
    p = _orbit_fn(plan, field, kernel=False)(
        field, jnp.asarray(c2w, jnp.float32).reshape(3, 4))
    _oracle_check(plan, np.asarray(p.image), np.asarray(p.depth), c2w,
                  sigma, color, seed_pixels=pose)


@pytest.mark.parametrize("pose", range(len(mc.ORBIT)))
def test_orbit_pose_march_matches_plain(pose):
    sigma, color = _blob()
    field = _field(sigma, color)
    plan = mc.plan(width=W, height=H)
    c2w = jnp.asarray(mc.ORBIT[pose], jnp.float32).reshape(3, 4)
    got = _orbit_fn(plan, field, kernel=True)(field, c2w)
    want = _orbit_fn(plan, field, kernel=False)(field, c2w)
    mc.assert_planes_close(got, want)
    assert float(np.asarray(got.opacity).max()) > 0.05  # scene in view


@pytest.mark.parametrize("kernel", [False, True])
def test_orbit_replays_one_executable(kernel):
    sigma, color = _blob(n=8)
    field = _field(sigma, color)
    plan = mc.plan(width=8, height=8)
    fn = _orbit_fn(plan, field, kernel)
    images = []
    for i, c2w in enumerate(mc.ORBIT):
        f = field.with_params(field.sigma * (1.0 + 0.1 * i), field.color)
        images.append(np.asarray(
            fn(f, jnp.asarray(c2w, jnp.float32).reshape(3, 4)).image))
    assert fn._cache_size() == 1
    assert all(np.abs(a - b).max() > 1e-4
               for a, b in zip(images, images[1:]))


@pytest.mark.parametrize("frame", [0, 3, 7, 11])
def test_animation_orbit_evolving_field(frame):
    """The reference's animation workload on an orbit: the field evolves
    per frame while the camera moves; the kernel frame matches the
    oracle."""
    t = frame / 12.0
    sigma, color = _blob(cx=0.35 + 0.3 * t)
    field = _field(sigma, color)
    plan = mc.plan(width=W, height=H)
    ang = 2 * np.pi * t
    c2w = mc.lookat((0.5 + 1.5 * np.sin(ang), 0.6, 0.5 - 1.5 * np.cos(ang)))
    p = _orbit_fn(plan, field, kernel=True)(
        field, jnp.asarray(c2w, jnp.float32).reshape(3, 4))
    _oracle_check(plan, np.asarray(p.image), np.asarray(p.depth), c2w,
                  sigma, color, seed_pixels=frame, img_tol=4e-3)


def test_animation_renderer_kernel_route(monkeypatch):
    """A fixed camera over an evolving field through the Renderer on the
    kernel route: the plan's executable is reused across frames."""
    monkeypatch.setattr(march, "select_route", mc.kernel_route)
    plan = mc.plan(width=W, height=H)
    renderer = Renderer(Context.create(), plan)
    prev = None
    for frame in (0, 5, 10):
        sigma, color = _blob(cx=0.35 + 0.3 * frame / 12.0)
        fr = renderer.forward(_field(sigma, color))
        assert "march_kernel" in fr.stats.notes
        img = fr.image.reshape(H, W, 3)
        _oracle_check(plan, img, fr.depth.reshape(H, W), plan.camera.c2w,
                      sigma, color, seed_pixels=frame, img_tol=4e-3)
        if prev is not None:
            assert np.abs(img - prev).max() > 1e-5
        prev = img
    assert renderer._march_jit[1]._cache_size() == 1
