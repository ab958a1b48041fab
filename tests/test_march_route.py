"""The Renderer on the march route, driven on the CPU by injecting the
interpreter through ``ops.march.select_route``; fits stay on the plain
path."""

import jax.numpy as jnp
import numpy as np
import pytest

from dvren_tpu import (Context, DvrenError, InterpMode, Renderer,
                       RenderOptions, SamplingMode)
from dvren_tpu.ops import march
from dvren_tpu.opt.fit import FitConfig, fit_dense_grid, render_views
from tests import march_cases as mc


@pytest.fixture
def kernel_route(monkeypatch):
    monkeypatch.setattr(march, "select_route", mc.kernel_route)


@pytest.mark.parametrize("mode", [SamplingMode.FIXED,
                                  SamplingMode.STRATIFIED])
def test_renderer_march_forward_backward(mode, kernel_route, monkeypatch):
    plan = mc.plan(width=12, height=10, mode=mode)
    field = mc.field(shape=(6, 6, 6), blob=True)
    r_k = Renderer(Context.create(), plan)
    fr_k = r_k.forward(field)
    assert "march_kernel" in fr_k.stats.notes

    monkeypatch.setattr(march, "select_route",
                        lambda f, **kw: march.Route(kernel=False))
    r_p = Renderer(Context.create(), plan)
    fr_p = r_p.forward(field)
    assert "march_kernel" not in fr_p.stats.notes
    for name in ("image", "transmittance", "opacity", "depth"):
        np.testing.assert_allclose(getattr(fr_k, name), getattr(fr_p, name),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(fr_k.hitmask, fr_p.hitmask)
    assert fr_k.sample_count == fr_p.sample_count

    dl = np.random.default_rng(2).normal(
        size=plan.ray_count * 3).astype(np.float32)
    b_k, b_p = r_k.backward(field, dl), r_p.backward(field, dl)
    for name in ("sigma", "color", "camera", "camera_k"):
        want = getattr(b_p, name)
        np.testing.assert_allclose(getattr(b_k, name), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def test_renderer_march_graph_replay(kernel_route):
    plan = mc.plan(width=10, height=8)
    field = mc.field(shape=(5, 5, 5), blob=True)
    r = Renderer(Context.create(), plan, RenderOptions(enable_graph=True))
    a = r.forward(field)
    assert "graph_executed" in a.stats.notes
    assert any(n.startswith("graph_captured_bwd_compile_ms")
               for n in a.stats.notes)
    b = r.forward(field)
    np.testing.assert_array_equal(a.image, b.image)
    assert r.workspace_info().workspace_buffer_bytes > 0
    br = r.backward(field, np.ones(plan.ray_count * 3, np.float32))
    assert np.isfinite(br.sigma).all() and np.abs(br.sigma).max() > 0


def test_renderer_march_parity_views(kernel_route, monkeypatch):
    """Per-sample views after a march forward recompute the lattice and
    equal the in-memory fused path's views."""
    plan = mc.plan(width=8, height=6)
    field = mc.field(shape=(5, 5, 5))
    r_k = Renderer(Context.create(), plan)
    r_k.forward(field)
    monkeypatch.setattr(march, "select_route",
                        lambda f, **kw: march.Route(kernel=False))
    r_f = Renderer(Context.create(), plan)
    r_f.forward(field)
    np.testing.assert_allclose(r_k.packed_aux(), r_f.packed_aux(),
                               rtol=1e-5, atol=1e-6)
    a, b = r_k.packed_samples(), r_f.packed_samples()
    for key in ("positions", "dt", "sigma", "color", "ray_offset"):
        np.testing.assert_allclose(a[key], b[key], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("interp", [InterpMode.NEAREST, InterpMode.LINEAR])
def test_renderer_route_follows_eligibility(interp, kernel_route):
    plan = mc.plan(width=8, height=6)
    f = mc.field(shape=(5, 5, 5))
    f = f.__class__(sigma=f.sigma, color=f.color, interp=interp)
    fr = Renderer(Context.create(), plan).forward(f)
    kernel = interp == InterpMode.LINEAR
    assert ("march_kernel" in fr.stats.notes) is kernel


def test_renderer_explicit_window_wins_over_kernel(kernel_route):
    plan = mc.plan(width=8, height=6)
    fr = Renderer(Context.create(), plan,
                  RenderOptions(use_window=True)).forward(mc.field())
    assert "windowed_path" in fr.stats.notes
    assert "march_kernel" not in fr.stats.notes


def test_renderer_ray_override_takes_plain_path(kernel_route):
    """An override bundle renders on the plain path even where generated
    rays take the kernel; the plan's own rays give the kernel's frame."""
    from dvren_tpu.ops.raygen import generate_rays

    plan = mc.plan(width=8, height=6)
    field = mc.field(shape=(5, 5, 5), blob=True)
    r = Renderer(Context.create(), plan)
    fr_k = r.forward(field)
    fr_o = r.forward(field, rays=generate_rays(plan))
    assert r.last_path == "override"
    assert "override_path" in fr_o.stats.notes
    assert "march_kernel" not in fr_o.stats.notes
    np.testing.assert_allclose(fr_o.image, fr_k.image, atol=1e-5)


@pytest.mark.parametrize("sync_every", [1, 3])
def test_fit_dense_grid_trains_on_plain_path(sync_every, kernel_route):
    """Even where renders take the kernel, fits train on the plain path
    (the kernel's VJP would recompute the same plain lattice)."""
    plan = mc.plan(width=10, height=8, mode=SamplingMode.FIXED,
                   max_steps=24, dt=2.0 / 24)
    cams = [mc.plan(c2w=(1, 0, 0, 0.5 + dx, 0, 1, 0, 0.5, 0, 0, 1, -1.0)
                    ).camera for dx in (-0.1, 0.1)]
    truth = mc.field(shape=(6, 6, 6), blob=True)
    targets = np.asarray(render_views(plan, truth, cams))
    init = truth.with_params(jnp.full_like(truth.sigma, 0.5),
                             jnp.full_like(truth.color, 0.5))
    cfg = FitConfig(learning_rate=5e-2, steps=6, target_psnr=None,
                    sync_every=sync_every)
    got = fit_dense_grid(plan, init, cams, targets, cfg)
    assert march.select_route(init).kernel
    assert got.mode == "plain" and got.steps_run == 6
    assert got.loss_history[-1] < got.loss_history[0]

    def loss(params):
        f = init.with_params(*params)
        imgs = jnp.stack([march.render_march(
            plan, f, c2w=jnp.asarray(c.c2w, jnp.float32).reshape(3, 4),
            interpret=True).image for c in cams])
        return jnp.mean((imgs - targets) ** 2)

    # the kernel route's loss at the start is the plain fit's first loss
    np.testing.assert_allclose(float(loss((init.sigma, init.color))),
                               got.loss_history[0], rtol=1e-5)


@pytest.mark.parametrize("key,value", [("use_tiles", True),
                                       ("use_occupancy", False),
                                       ("tile_pitch", 2)])
def test_config_rejects_removed_tile_options(key, value):
    from dvren_tpu.io.config import parse_config
    root = {"render": {"width": 4, "height": 4, "t_far": 1.0, "dt": 0.1,
                       "max_steps": 8, "options": {key: value}},
            "volume": {"size": [2, 2, 2], "density": [0.0] * 8}}
    with pytest.raises(DvrenError, match=key):
        parse_config(root)
