"""Benchmark: the headline frame and train step on one GPU, on the route
the Renderer takes.

Headline scene: 512^2 pinhole frame, 64^3 dense grid, 128 stratified steps
(33.5 M lattice samples) - the reference's own 512^2 x 128 samples/ray
setup (BASELINE.md). Times, with ``block_until_ready`` after warm-up:

- forward ms/frame of the route ``ops.march.select_route`` picks (the
  march kernel on the GPU);
- train ms/step of the step ``opt.fit.fit_dense_grid`` runs (fits train on
  the plain full-lattice path on every backend): ``value_and_grad`` of an
  image MSE through ``render``.

Prints the card's name and power limit, then ONE JSON line. Exits non-zero
when JAX finds no GPU: the numbers only mean something on the card.

Usage: python bench.py
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def use_compile_cache() -> None:
    """Persistent compile cache: the directory JAX_COMPILATION_CACHE_DIR
    names (JAX reads it itself), else the fixed ``<repo>/.jax_cache``."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def card_line() -> str:
    """``name, power.limit`` of the first card as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _pinhole_plan(width, height, max_steps, c2w=None, stratified=True):
    from dvren_tpu import (CameraConfig, Plan, PlanConfig, SamplingConfig,
                           SamplingMode)
    return Plan.create(PlanConfig(
        width=width, height=height, t_near=0.2, t_far=2.2, seed=3,
        camera=CameraConfig(
            k=(width * 1.2, 0.0, width / 2, 0.0, width * 1.2, height / 2,
               0.0, 0.0, 1.0),
            c2w=c2w or (1, 0, 0, 0.5, 0, 1, 0, 0.5, 0, 0, 1, -1.0)),
        sampling=SamplingConfig(
            dt=2.0 / max_steps, max_steps=max_steps,
            mode=(SamplingMode.STRATIFIED if stratified
                  else SamplingMode.FIXED))))


def _grid_field(sigma, color):
    from dvren_tpu import DenseGridConfig, DenseGridField
    nz, ny, nx = sigma.shape
    return DenseGridField.create(DenseGridConfig(
        resolution=(nx, ny, nz), sigma=sigma.reshape(-1),
        color=color.reshape(-1)))


def _lattice(n):
    return np.meshgrid(*([np.linspace(0, 1, n)] * 3), indexing="ij")


def blob_volume(grid_n=64):
    """Host (sigma (n, n, n), color (n, n, n, 3)) float32 Gaussian blob."""
    zs, ys, xs = (a.astype(np.float32) for a in _lattice(grid_n))
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (12.0 * np.exp(-r2 / np.float32(0.05))).astype(np.float32)
    color = np.stack([xs, ys, 1.0 - zs], axis=-1)
    return sigma, color


def headline_plan(width=512, height=512, max_steps=128):
    return _pinhole_plan(width, height, max_steps)


def headline_scene(width=512, height=512, grid_n=64, max_steps=128):
    """Gaussian blob in a 64^3 grid seen by a 512^2 pinhole camera."""
    return (headline_plan(width, height, max_steps),
            _grid_field(*blob_volume(grid_n)))


def sdf_shell_scene(width=800, grid_n=160, max_steps=256):
    """The reference's SDF sphere shell (test_sdf_sphere.cpp): density 25
    on |r - 0.33| < 0.05 in a 160^3 grid, seen at 800^2."""
    zs, ys, xs = _lattice(grid_n)
    r = np.sqrt((xs - .5) ** 2 + (ys - .5) ** 2 + (zs - .5) ** 2)
    sigma = np.where(np.abs(r - 0.33) < 0.05, 25.0, 0.0).astype(np.float32)
    color = np.stack([xs, ys, 1 - zs], -1).astype(np.float32)
    return (_pinhole_plan(width, width, max_steps),
            _grid_field(sigma, color))


def fit_scene(views=8, res=96, grid_n=64, max_steps=96):
    """The grid-fit workload (tools/fit_benchmark.py): a 64^3 blob seen
    from ``views`` orbiting 96^2 cameras, fixed sampling. Returns
    (plan, truth field, cameras)."""
    from dvren_tpu import CameraConfig
    zs, ys, xs = _lattice(grid_n)
    r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
    sigma = (10.0 * np.exp(-r2 / 0.06)).astype(np.float32)
    color = np.stack([xs, ys, 1 - zs], axis=-1).astype(np.float32)
    cams = []
    for i in range(views):
        ang = 2 * math.pi * i / views
        cams.append(CameraConfig(c2w=(
            1, 0, 0, 0.5 + 0.25 * math.sin(ang),
            0, 1, 0, 0.5 + 0.15 * math.cos(ang),
            0, 0, 1, -1.0)))
    return (_pinhole_plan(res, res, max_steps, stratified=False),
            _grid_field(sigma, color), cams)


def time_ms(fn, *args, iters=10):
    """(compile+first-call seconds, median steady ms) of ``fn(*args)``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first_s = time.perf_counter() - t0
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return first_s, float(np.median(times)) * 1e3


def route_fns(plan, field, route):
    """Jitted (forward, train step) of a route: ``route`` is "kernel" (the
    march kernel) or "plain" (render_streamed forward, the Renderer's
    plain route at this size; full-lattice ``render`` train step, the
    plain fit step)."""
    import jax
    import jax.numpy as jnp

    from dvren_tpu.ops import march
    from dvren_tpu.render.pipeline import render, render_streamed

    def fwd_planes(f, j):
        if route == "kernel":
            return march.render_march(plan, f, jitter=j)
        return render_streamed(plan, f, jitter=j)

    def train_image(f, j):
        if route == "kernel":
            return march.render_march(plan, f, jitter=j).image
        return render(plan, f, jitter=j).planes.image

    target = jnp.zeros((plan.height, plan.width, 3), jnp.float32)

    def loss(params, j):
        img = train_image(field.with_params(*params), j)
        return jnp.mean((img - target) ** 2)

    return (jax.jit(lambda f, j: fwd_planes(f, j).image),
            jax.jit(jax.value_and_grad(loss)))


def measure(card: str) -> dict:
    """Time the headline forward on the route the Renderer takes and the
    train step on the route fits take; returns the result dict ``main``
    prints."""
    import jax
    import jax.numpy as jnp

    from dvren_tpu.ops import march
    from dvren_tpu.render.pipeline import plan_jitter_table

    dev = jax.devices()[0]
    plan, field = headline_scene()
    route = march.select_route(field)
    name = "kernel" if route.kernel else "plain"
    jitter = jnp.asarray(plan_jitter_table(plan))
    fwd, _ = route_fns(plan, field, name)
    _, train = route_fns(plan, field, "plain")
    fwd_first_s, fwd_ms = time_ms(fwd, field, jitter)
    train_first_s, train_ms = time_ms(train, (field.sigma, field.color),
                                      jitter, iters=5)
    return {
        "metric": "fwd_Mrays_per_s_512",
        "value": plan.ray_count / fwd_ms / 1e3,
        "unit": "Mrays/s",
        "extra": {
            "route": route.note,
            "train_route": "plain_path (fit_dense_grid step)",
            "fwd_ms_per_frame": fwd_ms,
            "train_ms_per_step": train_ms,
            "fwdbwd_Mrays_per_s": plan.ray_count / train_ms / 1e3,
            "fwd_first_call_s": fwd_first_s,
            "train_first_call_s": train_first_s,
            "config": "512x512, 64^3 grid, 128 steps, stratified",
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
        },
    }


def main() -> int:
    import jax

    use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}", flush=True)
    print(json.dumps(measure(card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
