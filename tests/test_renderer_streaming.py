"""Renderer streaming mode: parity with the in-memory paths + backward."""

import numpy as np
import pytest

from dvren_tpu import (
    CameraConfig, Context, DenseGridConfig, DenseGridField, DvrenError,
    Plan, PlanConfig, Renderer, RenderOptions, SamplingConfig, SamplingMode,
)
from dvren_tpu.render.pipeline import render


def scene(mode=SamplingMode.STRATIFIED):
    rng = np.random.default_rng(2)
    n = 6
    plan = Plan.create(PlanConfig(
        width=14, height=10, t_near=0.3, t_far=2.3, seed=5,
        camera=CameraConfig(
            k=(18.0, 0, 7.0, 0, 18.0, 5.0, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=SamplingConfig(dt=0.08, max_steps=26, mode=mode)))
    field = DenseGridField.create(DenseGridConfig(
        resolution=(n, n, n),
        sigma=rng.uniform(0.5, 6.0, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3)))
    return plan, field


def test_streaming_forward_matches_fused():
    plan, field = scene()
    ctx = Context.create()
    a = Renderer(ctx, plan, RenderOptions(streaming=True)).forward(field)
    b = Renderer(ctx, plan, RenderOptions(streaming=False)).forward(field)
    np.testing.assert_allclose(a.image, b.image, atol=1e-6)
    np.testing.assert_allclose(a.depth, b.depth, atol=1e-5)
    np.testing.assert_array_equal(a.hitmask, b.hitmask)
    assert a.sample_count == b.sample_count  # analytic == measured
    assert "streaming_path" in a.stats.notes


def test_streaming_backward_matches_fused():
    plan, field = scene()
    ctx = Context.create()
    dl = np.random.default_rng(3).uniform(
        -1, 1, (plan.ray_count, 3)).astype(np.float32)

    rs = Renderer(ctx, plan, RenderOptions(streaming=True))
    rs.forward(field)
    bs = rs.backward(field, dl)

    rf = Renderer(ctx, plan, RenderOptions(streaming=False))
    rf.forward(field)
    bf = rf.backward(field, dl)

    np.testing.assert_allclose(bs.sigma, bf.sigma, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(bs.color, bf.color, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(bs.camera, bf.camera, rtol=1e-3, atol=1e-6)


def test_streaming_auto_selection():
    plan, field = scene()
    ctx = Context.create()
    r_small = Renderer(ctx, plan)  # tiny plan -> in-memory
    assert not r_small._streaming
    r_forced = Renderer(ctx, plan, RenderOptions(streaming_budget=10))
    assert r_forced._streaming


def test_streaming_per_sample_views_match_fused():
    """Streaming-mode parity views recompute the lattice tile-by-tile and
    must match the in-memory views exactly (the reference persists aux
    always, int_cpu.cpp:201-207; production sizes stream it here)."""
    plan, field = scene()
    ctx = Context.create()
    dl = np.random.default_rng(9).uniform(
        -1, 1, (plan.ray_count, 3)).astype(np.float32)

    rf = Renderer(ctx, plan, RenderOptions(streaming=False))
    rf.forward(field)
    ref_samples = rf.packed_samples()
    ref_aux = rf.packed_aux()
    ref_ds, ref_dc = rf.per_sample_gradients(dl)

    rs = Renderer(ctx, plan, RenderOptions(streaming=True))
    rs.forward(field)
    got_samples = rs.packed_samples()
    got_aux = rs.packed_aux()
    got_ds, got_dc = rs.per_sample_gradients(dl)

    for key in ("positions", "dt", "sigma", "color", "ray_offset"):
        np.testing.assert_array_equal(got_samples[key], ref_samples[key])
    np.testing.assert_array_equal(got_aux, ref_aux)
    np.testing.assert_array_equal(got_ds, ref_ds)
    np.testing.assert_array_equal(got_dc, ref_dc)


def test_windowed_per_sample_views_match_fused():
    """Window scheduling only skips provably-zero contributions; the packed
    parity views are defined on the full lattice and must be identical."""
    plan, field = windowed_scene()
    ctx = Context.create()
    rf = Renderer(ctx, plan, RenderOptions())
    rf.forward(field)
    rw = Renderer(ctx, plan, RenderOptions(use_window=True))
    rw.forward(field)
    ref = rf.packed_samples()
    got = rw.packed_samples()
    for key in ("positions", "dt", "sigma", "color", "ray_offset"):
        np.testing.assert_array_equal(got[key], ref[key])
    np.testing.assert_array_equal(rw.packed_aux(), rf.packed_aux())


def test_streaming_graph_replay():
    plan, field = scene()
    r = Renderer(Context.create(), plan,
                 RenderOptions(streaming=True, enable_graph=True))
    a = r.forward(field)
    b = r.forward(field)
    assert a.image.tobytes() == b.image.tobytes()
    assert "graph_executed" in b.stats.notes


def windowed_scene(mode=SamplingMode.STRATIFIED):
    plan, _ = scene(mode)
    rng = np.random.default_rng(11)
    n = 6
    sub = DenseGridField.create(DenseGridConfig(
        resolution=(n, n, n),
        sigma=rng.uniform(0.5, 6.0, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3),
        bbox_min=(0.25, 0.3, 0.2), bbox_max=(0.8, 0.85, 0.7)))
    return plan, sub


def test_windowed_renderer_matches_fused():
    plan, field = windowed_scene()
    ctx = Context.create()
    a = Renderer(ctx, plan, RenderOptions(use_window=True)).forward(field)
    b = Renderer(ctx, plan, RenderOptions()).forward(field)
    np.testing.assert_allclose(a.image, b.image, atol=2e-6)
    np.testing.assert_allclose(a.depth, b.depth, atol=1e-5)
    np.testing.assert_array_equal(a.hitmask, b.hitmask)
    assert "windowed_path" in a.stats.notes


def test_windowed_renderer_backward_and_replay():
    plan, field = windowed_scene()
    ctx = Context.create()
    dl = np.random.default_rng(7).uniform(
        -1, 1, (plan.ray_count, 3)).astype(np.float32)

    rw = Renderer(ctx, plan,
                  RenderOptions(use_window=True, enable_graph=True))
    a = rw.forward(field)
    b = rw.forward(field)  # schedule + AOT executable reused
    assert a.image.tobytes() == b.image.tobytes()
    assert "graph_executed" in b.stats.notes
    bw = rw.backward(field, dl)

    rf = Renderer(ctx, plan, RenderOptions())
    rf.forward(field)
    bf = rf.backward(field, dl)
    np.testing.assert_allclose(bw.sigma, bf.sigma, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(bw.color, bf.color, rtol=1e-4, atol=1e-7)


def test_windowed_renderer_rejects_unbounded_fields():
    plan, _ = windowed_scene()
    from dvren_tpu import HashMLPConfig, HashMLPField
    hm = HashMLPField.create(HashMLPConfig())
    r = Renderer(Context.create(), plan, RenderOptions(use_window=True))
    with pytest.raises(DvrenError):
        r.forward(hm)


def test_windowed_renderer_backward_rejects_sparse_fields():
    from dvren_tpu import SparseGridField
    plan, field = windowed_scene()
    sparse = SparseGridField.from_dense(field)
    r = Renderer(Context.create(), plan, RenderOptions(use_window=True))
    r.forward(sparse)  # windowed forward supports sparse bricks
    dl = np.zeros((plan.ray_count, 3), np.float32)
    with pytest.raises(DvrenError):
        r.backward(sparse, dl)
