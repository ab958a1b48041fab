"""Hash-MLP field (hash_mlp_cpu_basic / hash_mlp_cpu_determinism analogues;
hp_runner.cpp:2104-2224 builds a zeroed param blob with only output biases
set so expected sigma/color are known constants)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from dvren_tpu.fields.hash_mlp import HashMLPConfig, HashMLPField
from dvren_tpu.ops.hashmlp import HashMLPSpec, hash_coords, pack_params, unpack_params

SPEC = HashMLPSpec()


def blob_with_biases(sigma_bias=0.0, color_bias=(0.0, 0.0, 0.0)):
    """All-zero params except the output biases -> constant outputs."""
    flat = np.zeros(SPEC.param_count, np.float32)
    # sigma_b2 is the last element of the sigma biases block
    off = SPEC.hash_table_size + SPEC.sigma_weights_size
    flat[off + SPEC.hidden_dim] = sigma_bias
    off2 = off + SPEC.sigma_biases_size + SPEC.color_weights_size
    flat[off2 + SPEC.hidden_dim: off2 + SPEC.hidden_dim + 3] = color_bias
    return flat


def test_constant_bias_outputs():
    field = HashMLPField.create(HashMLPConfig(params=blob_with_biases(
        sigma_bias=1.25, color_bias=(0.25, 0.5, 0.75))))
    pts = jnp.asarray(
        np.random.default_rng(0).uniform(0, 1, (32, 3)), jnp.float32)
    sigma = np.asarray(field.sigma_at(pts))
    color = np.asarray(field.color_at(pts))
    np.testing.assert_allclose(sigma, 1.25, rtol=1e-6)
    np.testing.assert_allclose(color, np.broadcast_to(
        [0.25, 0.5, 0.75], color.shape), rtol=1e-6)


def test_negative_bias_clamped():
    field = HashMLPField.create(HashMLPConfig(params=blob_with_biases(
        sigma_bias=-2.0, color_bias=(-1.0, 2.0, 0.5))))
    pts = jnp.asarray([[0.3, 0.4, 0.5]])
    assert float(field.sigma_at(pts)[0]) == 0.0       # ReLU
    np.testing.assert_allclose(
        np.asarray(field.color_at(pts))[0], [0.0, 1.0, 0.5])  # clamp [0,1]


def test_hash_function_golden():
    """3-prime XOR hash parity with a pure-Python uint32 oracle."""
    def oracle(x, y, z, t):
        m = 0xFFFFFFFF
        h = ((x * 1) & m) ^ ((y * 2654435761) & m) ^ ((z * 805459861) & m)
        return h % t

    xs = np.array([0, 1, 2, 7, 15, 100], np.int32)
    got = np.asarray(hash_coords(
        jnp.asarray(xs), jnp.asarray(xs + 1), jnp.asarray(xs * 3), 16))
    want = [oracle(int(x), int(x) + 1, int(x) * 3, 16) for x in xs]
    np.testing.assert_array_equal(got, want)


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(2)
    flat = rng.uniform(-1, 1, SPEC.param_count).astype(np.float32)
    params = unpack_params(jnp.asarray(flat), SPEC)
    back = np.asarray(pack_params(params, SPEC))
    np.testing.assert_array_equal(back, flat)


def test_determinism_memcmp():
    rng = np.random.default_rng(3)
    field = HashMLPField.create(HashMLPConfig(
        params=rng.uniform(-0.5, 0.5, SPEC.param_count).astype(np.float32)))
    pts = jnp.asarray(rng.uniform(0, 1, (64, 3)), jnp.float32)
    a = np.asarray(field.sigma_at(pts))
    b = np.asarray(field.sigma_at(pts))
    assert a.tobytes() == b.tobytes()
    ca = np.asarray(field.color_at(pts))
    cb = np.asarray(field.color_at(pts))
    assert ca.tobytes() == cb.tobytes()


def test_spatial_variation():
    rng = np.random.default_rng(4)
    field = HashMLPField.create(HashMLPConfig(
        params=rng.uniform(-0.5, 0.5, SPEC.param_count).astype(np.float32)))
    pts = jnp.asarray(rng.uniform(0, 1, (128, 3)), jnp.float32)
    sigma = np.asarray(field.sigma_at(pts))
    assert sigma.std() > 0  # encoding actually varies over space


def test_gradients_flow_to_all_param_groups():
    """New capability: the reference hash-MLP is forward-only (SURVEY #10)."""
    field = HashMLPField.init_random(jax.random.PRNGKey(0))
    pts = jnp.asarray(
        np.random.default_rng(5).uniform(0, 1, (32, 3)), jnp.float32)

    def loss(params):
        f = field.with_params(params)
        return jnp.sum(f.sigma_at(pts) ** 2) + jnp.sum(f.color_at(pts) ** 2)

    grads = jax.grad(loss)(field.params)
    nonzero = {k: float(jnp.abs(v).sum()) for k, v in grads.items()}
    assert nonzero["hash_table"] > 0
    assert nonzero["sigma_w1"] > 0 and nonzero["color_w1"] > 0
    for v in grads.values():
        assert np.isfinite(np.asarray(v)).all()


def test_render_with_hash_mlp_field():
    """Hash-MLP drives the full pipeline (samp_cpu.cpp:255-289 dispatch
    analogue: any field exposing sigma_at/color_at plugs into render)."""
    from dvren_tpu import Plan, PlanConfig, SamplingConfig
    from dvren_tpu.render.pipeline import render

    field = HashMLPField.init_random(jax.random.PRNGKey(1))
    plan = Plan.create(PlanConfig(
        width=6, height=6, t_near=0.2, t_far=1.8,
        sampling=SamplingConfig(dt=0.1, max_steps=16)))
    out = render(plan, field)
    img = np.asarray(out.planes.image)
    assert img.shape == (6, 6, 3)
    assert np.isfinite(img).all()


@pytest.mark.parametrize("sync_every", [1, 2])
def test_fit_hash_mlp_plain_path(sync_every):
    """fit_hash_mlp trains all parameter groups through jax.grad of the
    plain render: the loss falls toward a target rendered from another
    random field, and blocked sync keeps the per-step history."""
    from dvren_tpu import CameraConfig, Plan, PlanConfig, SamplingConfig
    from dvren_tpu.opt.fit import FitConfig, fit_hash_mlp, render_views

    plan = Plan.create(PlanConfig(
        width=8, height=8, t_near=0.2, t_far=1.8,
        camera=CameraConfig(k=(9.0, 0, 4.0, 0, 9.0, 4.0, 0, 0, 1),
                            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1,
                                 -0.6)),
        sampling=SamplingConfig(dt=0.1, max_steps=16)))
    cams = [CameraConfig(c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0, 0.5, 0, 0, 1,
                              -0.6)) for dx in (-0.1, 0.1)]
    truth = HashMLPField.init_random(jax.random.PRNGKey(7))
    targets = np.asarray(render_views(plan, truth, cams))
    init = HashMLPField.init_random(jax.random.PRNGKey(8))
    res = fit_hash_mlp(plan, init, cams, targets,
                       FitConfig(learning_rate=3e-2, steps=6,
                                 target_psnr=None, sync_every=sync_every))
    assert res.mode == "plain" and res.steps_run == 6
    assert len(res.loss_history) == 6
    assert res.loss_history[-1] < res.loss_history[0]
    moved = jax.tree.map(lambda a, b: float(jnp.abs(a - b).max()),
                         res.field.params, init.params)
    assert all(v > 0 for v in moved.values())
