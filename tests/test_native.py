"""Native C++ runtime library: build, and three-way parity with the JAX
pipeline (the C++ double-precision kernels play the reference-CPU-oracle
role; SURVEY.md section 4: 'the CPU implementation *is* the reference
oracle')."""

import numpy as np
import jax.numpy as jnp
import pytest

from dvren_tpu import native
from dvren_tpu.core.plan import (
    CameraConfig, CameraModel, InterpMode, OobPolicy, Plan, PlanConfig,
    SamplingConfig,
)
from dvren_tpu.ops.grid import eval_grid
from dvren_tpu.ops.integrate import integrate
from dvren_tpu.ops.raygen import generate_rays
from dvren_tpu.ops.sampling import generate_samples

pytestmark = pytest.mark.skipif(
    not native.available(),
    reason=f"native library unavailable: {native.load_error()}")


def test_abi_builds():
    assert native.available()


def test_raygen_parity_pinhole():
    k = np.array([50.0, 0, 8.0, 0, 45.0, 6.0, 0, 0, 1.0], np.float32)
    c2w = np.array([0, -1, 0, 0.2, 1, 0, 0, -0.1, 0, 0, 1, 0.5], np.float32)
    plan = Plan.create(PlanConfig(
        width=16, height=12, t_near=0.1, t_far=3.0,
        camera=CameraConfig(k=tuple(k), c2w=tuple(c2w)),
        sampling=SamplingConfig(dt=0.1, max_steps=8)))
    rays = generate_rays(plan)
    o, d, tn, tf, pids = native.generate_rays(
        0, k, c2w, 1.0, 16, 12, (0, 0, 16, 12), 0.1, 3.0)
    np.testing.assert_allclose(np.asarray(rays.origins), o, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rays.directions), d, atol=1e-6)
    np.testing.assert_array_equal(
        np.asarray(rays.pixel_ids).astype(np.uint32), pids)


def test_raygen_parity_ortho():
    k = np.array([2.0, 0, 8.0, 0, 2.0, 6.0, 0, 0, 1.0], np.float32)
    c2w = np.array([1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2.0], np.float32)
    plan = Plan.create(PlanConfig(
        width=16, height=12, t_near=0.1, t_far=3.0,
        camera=CameraConfig(model=CameraModel.ORTHOGRAPHIC, k=tuple(k),
                            c2w=tuple(c2w), ortho_scale=0.5),
        sampling=SamplingConfig(dt=0.1, max_steps=8)))
    rays = generate_rays(plan)
    o, d, _, _, _ = native.generate_rays(
        1, k, c2w, 0.5, 16, 12, (0, 0, 16, 12), 0.1, 3.0)
    np.testing.assert_allclose(np.asarray(rays.origins), o, atol=1e-6)
    np.testing.assert_allclose(np.asarray(rays.directions), d, atol=1e-6)


@pytest.mark.parametrize("interp,oob", [
    (InterpMode.LINEAR, OobPolicy.ZERO),
    (InterpMode.LINEAR, OobPolicy.CLAMP),
    (InterpMode.NEAREST, OobPolicy.ZERO),
])
def test_grid_eval_parity(interp, oob):
    rng = np.random.default_rng(0)
    grid = rng.uniform(0, 1, (5, 6, 7)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, (200, 3)).astype(np.float32)
    ours = np.asarray(eval_grid(jnp.asarray(grid), jnp.asarray(pts),
                                (0, 0, 0), (1, 1, 1), interp, oob))
    theirs = native.eval_grid(grid, (0, 0, 0), (1, 1, 1),
                              int(interp), int(oob), pts)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)


def test_grid_eval_color_parity():
    rng = np.random.default_rng(1)
    grid = rng.uniform(0, 1, (4, 4, 4, 3)).astype(np.float32)
    pts = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    ours = np.asarray(eval_grid(jnp.asarray(grid), jnp.asarray(pts),
                                (0, 0, 0), (1, 1, 1)))
    theirs = native.eval_grid(grid, (0, 0, 0), (1, 1, 1), 1, 0, pts)
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)


def test_integrate_parity_with_aux():
    rng = np.random.default_rng(2)
    n, k = 12, 30
    sigma = rng.uniform(0, 12.0, (n, k)).astype(np.float32)
    color = rng.uniform(0, 1, (n, k, 3)).astype(np.float32)
    dt = np.full((n, k), 0.07, np.float32)
    mask = np.ones((n, k), bool)
    mask[:, 22:] = False
    dt[~mask] = 0.0

    ref = native.integrate(sigma, color, dt, mask, 0.2, 2.3, want_aux=True)
    ours = integrate(jnp.asarray(sigma), jnp.asarray(color),
                     jnp.asarray(dt), jnp.asarray(mask), 0.2, 2.3)
    np.testing.assert_allclose(np.asarray(ours.radiance), ref["radiance"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ours.transmittance),
                               ref["transmittance"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ours.depth), ref["depth"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ours.aux), ref["aux"],
                               rtol=1e-4, atol=1e-6)


def test_pack_unpack_roundtrip_and_offsets():
    plan = Plan.create(PlanConfig(
        width=4, height=4, t_near=0.0, t_far=1.0,
        sampling=SamplingConfig(dt=0.3, max_steps=8)))
    lattice = generate_samples(plan, generate_rays(plan))
    mask = np.asarray(lattice.mask)

    offsets = native.ray_offsets(mask)
    np.testing.assert_array_equal(
        offsets, np.asarray(lattice.ray_offsets()).astype(np.uint32))

    pos = np.asarray(lattice.positions)
    packed = native.pack_samples(mask, pos)
    assert packed.shape == (int(mask.sum()), 3)
    # packed stream order: ray-major, step-minor over live slots
    np.testing.assert_array_equal(packed[0], pos[0, 0])
    back = native.unpack_samples(mask, packed)
    np.testing.assert_array_equal(back[mask], pos[mask])
    assert (back[~mask] == 0).all()


def test_native_ppm_matches_python(tmp_path):
    from dvren_tpu.io.ppm import read_ppm, write_ppm
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.1, 1.1, (6, 5, 3)).astype(np.float32)
    p1 = tmp_path / "native.ppm"
    p2 = tmp_path / "python.ppm"
    native.write_ppm(str(p1), img)
    write_ppm(p2, img)
    assert p1.read_bytes() == p2.read_bytes()


def test_orthographic_end_to_end_vs_native_oracle():
    """Full ortho pipeline (raygen + sampling + trilinear + integrate) vs
    the independent C++ double-precision kernels."""
    from dvren_tpu import (CameraConfig, CameraModel, Context, DenseGridConfig,
                           DenseGridField, Renderer)
    rng = np.random.default_rng(4)
    n = 6
    sigma = rng.uniform(0.5, 6.0, (n, n, n)).astype(np.float32)
    color = rng.uniform(0, 1, (n, n, n, 3)).astype(np.float32)
    w, h = 10, 8
    k = np.array([2.0, 0, w / 2, 0, 2.0, h / 2, 0, 0, 1], np.float32)
    # translation chosen so no ray grazes a bbox face exactly (knife-edge
    # OOB classification differs between f32 and f64 ray generation)
    c2w = np.array([1, 0, 0, 0.53, 0, 1, 0, 0.51, 0, 0, 1, -0.5], np.float32)
    plan = Plan.create(PlanConfig(
        width=w, height=h, t_near=0.1, t_far=2.0,
        camera=CameraConfig(model=CameraModel.ORTHOGRAPHIC, k=tuple(k),
                            c2w=tuple(c2w), ortho_scale=0.2),
        sampling=SamplingConfig(dt=0.05, max_steps=40)))
    field = DenseGridField.create(DenseGridConfig(
        resolution=(n, n, n), sigma=sigma.reshape(-1),
        color=color.reshape(-1)))
    fr = Renderer(Context.create(), plan).forward(field)

    o, d, tn, tf, _ = native.generate_rays(
        1, k, c2w, 0.2, w, h, (0, 0, w, h), 0.1, 2.0)
    K = plan.sampling.max_steps
    dt = plan.sampling.dt
    nrays = w * h
    sig_s = np.zeros((nrays, K), np.float32)
    col_s = np.zeros((nrays, K, 3), np.float32)
    dts = np.zeros((nrays, K), np.float32)
    mask = np.zeros((nrays, K), bool)
    dt32 = np.float32(dt)
    for r in range(nrays):
        for s in range(K):
            base_t = np.float32(tn[r] + np.float32(s) * dt32)
            if base_t >= tf[r]:
                break
            t = np.float32(base_t + np.float32(0.5) * dt32)
            if t >= tf[r]:
                t = np.nextafter(tf[r], tn[r])
            p = (o[r] + d[r] * t).astype(np.float32)
            sig_s[r, s] = native.eval_grid(sigma, (0, 0, 0), (1, 1, 1),
                                           1, 0, p[None])[0]
            col_s[r, s] = native.eval_grid(color, (0, 0, 0), (1, 1, 1),
                                           1, 0, p[None])[0]
            dts[r, s] = min(base_t + dt, tf[r]) - base_t
            mask[r, s] = True
    ref = native.integrate(sig_s, col_s, dts, mask, 0.1, 2.0)
    np.testing.assert_allclose(
        fr.image.reshape(h, w, 3).reshape(-1, 3),
        ref["radiance"], atol=2e-3)
    np.testing.assert_allclose(
        fr.transmittance, ref["transmittance"], atol=2e-3)
