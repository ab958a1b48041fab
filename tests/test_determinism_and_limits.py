"""Backward determinism (diff_cuda_determinism analogue, hp_runner.cpp:2373)
and capacity-limit enforcement (samp_cpu.cpp:245-247 parity)."""

import numpy as np
import pytest

from dvren_tpu import (
    CameraConfig, Context, DenseGridConfig, DenseGridField, DvrenError,
    Plan, PlanConfig, Renderer, SamplingConfig, SamplingMode,
)


def scene(max_samples=0):
    rng = np.random.default_rng(11)
    n = 6
    plan = Plan.create(PlanConfig(
        width=8, height=6, t_near=0.3, t_far=2.1, seed=2,
        max_samples=max_samples,
        camera=CameraConfig(
            k=(9.0, 0, 4.0, 0, 9.0, 3.0, 0, 0, 1),
            c2w=(1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -0.9)),
        sampling=SamplingConfig(dt=0.06, max_steps=30,
                                mode=SamplingMode.STRATIFIED)))
    field = DenseGridField.create(DenseGridConfig(
        resolution=(n, n, n),
        sigma=rng.uniform(0.5, 6.0, n ** 3),
        color=rng.uniform(0.1, 1.0, 3 * n ** 3)))
    return plan, field


def test_backward_determinism_memcmp():
    """Repeated Backward produces bit-identical gradients (the reference
    checks this to catch atomicAdd nondeterminism; XLA's CPU scatters are
    deterministic; on the GPU they are atomics, and chip_smoke.py reports
    the run-to-run difference there)."""
    plan, field = scene()
    dl = np.random.default_rng(3).uniform(
        -1, 1, (plan.ray_count, 3)).astype(np.float32)
    r = Renderer(Context.create(), plan)
    r.forward(field)
    a = r.backward(field, dl)
    b = r.backward(field, dl)
    assert a.sigma.tobytes() == b.sigma.tobytes()
    assert a.color.tobytes() == b.color.tobytes()
    assert a.camera.tobytes() == b.camera.tobytes()


def test_forward_determinism_memcmp():
    plan, field = scene()
    r = Renderer(Context.create(), plan)
    a = r.forward(field)
    b = r.forward(field)
    assert a.image.tobytes() == b.image.tobytes()
    assert a.depth.tobytes() == b.depth.tobytes()


def test_sample_capacity_overflow_rejected():
    """Total live samples above plan.max_samples must raise
    INVALID_ARGUMENT (samp_cpu.cpp:245-247)."""
    # 48 rays x 30 live steps = 1440 live samples; cap at 100 (>= max_rays)
    plan, field = scene(max_samples=100)
    r = Renderer(Context.create(), plan)
    with pytest.raises(DvrenError):
        r.forward(field)


def test_max_samples_at_capacity_ok():
    plan, field = scene(max_samples=0)  # defaults to max_rays * max_steps
    r = Renderer(Context.create(), plan)
    fr = r.forward(field)
    assert fr.sample_count <= plan.max_samples
