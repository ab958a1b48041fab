"""Smoke test of the main path on the GPU, phase by phase, in one process.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded paths only

Phases (one card):

1. device  - JAX must see a GPU (else exit 1, no result line); prints the
             card's name and power limit.
2. render  - ``Renderer.forward`` at the 512^2 / 64^3 / 128-step headline
             and the 800^2 / 160^3 SDF shell on the march route, against
             the plain ``render_streamed``. Image, transmittance and
             opacity within 1e-4 (the reference's staged/fused parity
             budget; the kernel sums optical depth sequentially where the
             plain path uses a cumulative sum), depth within 1e-3 off
             knife-edge pixels. Two forwards must give identical bytes.
3. backward - ``Renderer.backward`` after the march forward (the streamed
             plain VJP, remat chosen by frame size) at the SDF shell first,
             with the device's peak bytes, which must stay below what the
             whole frame's residuals would take; then at the headline,
             against ``jax.grad`` of the plain ``render``, as is
             ``jax.grad`` through ``render_march``'s custom VJP: voxel and
             camera gradients within 1e-4 relative to the largest entry.
             The backward is run twice and the run-to-run difference
             printed: scatter-adds are atomics on the GPU.
4. fit     - ``fit_dense_grid``, 4 Adam steps at 64^3 from 8 views at
             96^2 (the plain path, where fits train): the loss must fall.
5. cli     - ``dvren_tpu.cli.main`` on examples/simple_volume.json.
6. timing  - kernel vs plain route: forward ms/frame and train ms/step at
             the headline, Renderer forward()/backward() at the headline,
             train ms/step at the fit shape.

``--multi`` runs, on four cards: the z-sharded render of a 512^3 grid at
512^2, one view-data-parallel train step over 4 views and the ray-sharded
render, each against its single-card counterpart.

Every float32 reference runs jitted, under ``jax.default_matmul_precision
("highest")``. Jitted, because an eager ``render`` rounds sample positions
differently (no fused multiply-adds): a sample 1 ulp from an OOB_ZERO
bbox face then lands on the other side, which moves a headline pixel by
up to 9.2e-4. A failed phase makes the run exit 1 without the result line;
the last line of a passing run is the device JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4          # image / T / opacity / relative gradient
DEPTH_TOL = 1e-3


class PhaseError(AssertionError):
    pass


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg):
    print(msg, flush=True)


def max_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def rel_diff(a, b):
    b = np.asarray(b, np.float64)
    return max_diff(a, b) / max(float(np.max(np.abs(b))), 1e-30)


def compare_planes(name, got, want):
    """Max differences of (image, T, opacity, depth off knife edges)."""
    from dvren_tpu.ops.integrate import OPACITY_EPS

    d = {k: max_diff(getattr(got, k), getattr(want, k))
         for k in ("image", "transmittance", "opacity")}
    op = np.asarray(want.opacity)
    keep = np.abs(op - OPACITY_EPS) >= 4 * OPACITY_EPS
    d["depth"] = max_diff(np.asarray(got.depth)[keep],
                          np.asarray(want.depth)[keep])
    log(f"  {name}: " + " ".join(f"{k}={v:.3e}" for k, v in d.items()))
    for k in ("image", "transmittance", "opacity"):
        require(d[k] <= TOL, f"{name}: {k} differs by {d[k]:.3e}")
    require(d["depth"] <= DEPTH_TOL, f"{name}: depth {d['depth']:.3e}")


def forward_planes(fr, plan):
    """ForwardResult -> namespace of (H, W[, 3]) planes."""
    from types import SimpleNamespace
    h, w = plan.height, plan.width
    return SimpleNamespace(
        image=fr.image.reshape(h, w, 3),
        transmittance=fr.transmittance.reshape(h, w),
        opacity=fr.opacity.reshape(h, w), depth=fr.depth.reshape(h, w))


# ------------------------------------------------------------ one card


def phase_render(state):
    import jax
    import jax.numpy as jnp

    import bench
    from dvren_tpu import Context, Renderer
    from dvren_tpu.render.pipeline import plan_jitter_table, render_streamed

    for name, (plan, field) in (("headline 512^2/64^3/128",
                                 bench.headline_scene()),
                                ("sdf shell 800^2/160^3/256",
                                 bench.sdf_shell_scene())):
        r = Renderer(Context.create(), plan)
        fr = r.forward(field)
        log(f"  {name}: route={r.last_path} notes={fr.stats.notes}")
        require(r.last_path == "march" and "march_kernel" in fr.stats.notes,
                f"{name}: forward did not take the march kernel")
        jitter = jnp.asarray(plan_jitter_table(plan))
        with jax.default_matmul_precision("highest"):
            ref = jax.jit(lambda f, j: render_streamed(plan, f, jitter=j))(
                field, jitter)
        compare_planes(name, forward_planes(fr, plan), ref)
        fr2 = r.forward(field)
        same = all(np.array_equal(getattr(fr, k), getattr(fr2, k))
                   for k in ("image", "transmittance", "opacity", "depth"))
        log(f"  {name}: second forward bit-identical={same}")
        require(same, f"{name}: two forwards differ")
        state.setdefault("headline", (plan, field, r))
        state["sdf"] = (plan, field, r)


def phase_backward(state):
    import jax
    import jax.numpy as jnp

    from dvren_tpu.ops import march
    from dvren_tpu.ops.raygen import camera_arrays
    from dvren_tpu.render.pipeline import (STREAM_RESIDUAL_BYTES,
                                           plan_jitter_table,
                                           remat_residual_budget, render,
                                           stream_needs_remat)

    def peak_bytes():
        st = jax.devices()[0].memory_stats() or {}
        return st.get("peak_bytes_in_use")

    # SDF shell first: the device's high-water mark then reads its backward
    plan, field, r = state["sdf"]
    samples = plan.ray_count * plan.sampling.max_steps
    dl = np.random.default_rng(1).normal(
        size=plan.ray_count * 3).astype(np.float32)
    t0 = time.perf_counter()
    b = r.backward(field, dl)
    peak = peak_bytes()
    log(f"  sdf shell Renderer.backward: {samples} lattice samples, "
        f"remat={stream_needs_remat(plan)} (budget "
        f"{remat_residual_budget()} B), "
        f"{time.perf_counter() - t0:.2f} s incl. compile, "
        f"device peak bytes so far {peak}")
    require(all(np.isfinite(getattr(b, k)).all()
                for k in ("sigma", "color", "camera", "camera_k")),
            "sdf shell: non-finite gradients")
    require(np.abs(b.sigma).max() > 0, "sdf shell: zero sigma gradient")
    require(peak is None or peak < samples * STREAM_RESIDUAL_BYTES,
            f"sdf shell backward peak {peak} B reaches what the whole "
            f"frame's residuals would take")

    plan, field, r = state["headline"]
    dl = np.random.default_rng(0).normal(
        size=plan.ray_count * 3).astype(np.float32)
    b1 = r.backward(field, dl)
    b2 = r.backward(field, dl)
    runs = {k: max_diff(getattr(b1, k), getattr(b2, k))
            for k in ("sigma", "color", "camera", "camera_k")}
    log("  headline Renderer.backward run-to-run max diff: "
        + " ".join(f"{k}={v:.3e}" for k, v in runs.items())
        + f"; remat={stream_needs_remat(plan)}, device peak bytes so far "
        f"{peak_bytes()}")

    jitter = jnp.asarray(plan_jitter_table(plan))
    dl_img = jnp.asarray(dl.reshape(plan.height, plan.width, 3))
    k0, c2w0, _ = camera_arrays(plan)

    def loss(sigma, color, k, c2w, kernel=False):
        f = field.with_params(sigma, color)
        if kernel:
            img = march.render_march(plan, f, k=k, c2w=c2w,
                                     jitter=jitter).image
        else:
            img = render(plan, f, k=k, c2w=c2w, jitter=jitter).planes.image
        return jnp.sum(img * dl_img)

    args = (field.sigma, field.color, k0, c2w0)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*args)
    kern = jax.jit(jax.grad(functools.partial(loss, kernel=True),
                            argnums=(0, 1, 2, 3)))(*args)
    names = ("sigma", "color", "camera_k", "camera")
    for label, got in (("Renderer.backward", (b1.sigma, b1.color,
                                              b1.camera_k, b1.camera)),
                       ("jax.grad(render_march)", kern)):
        rels = {n: rel_diff(np.asarray(g).reshape(-1),
                            np.asarray(w).reshape(-1))
                for n, g, w in zip(names, got, ref)}
        log(f"  {label} vs jax.grad(plain render), relative: "
            + " ".join(f"{k}={v:.3e}" for k, v in rels.items()))
        for n, v in rels.items():
            require(v <= TOL, f"{label}: {n} gradient rel diff {v:.3e}")


def phase_fit(state):
    import jax.numpy as jnp

    import bench
    from dvren_tpu.opt.fit import FitConfig, fit_dense_grid, render_views

    plan, truth, cams = bench.fit_scene()
    targets = np.asarray(render_views(plan, truth, cams))
    init = truth.with_params(jnp.full_like(truth.sigma, 0.5),
                             jnp.full_like(truth.color, 0.5))
    res = fit_dense_grid(plan, init, cams, targets,
                         FitConfig(learning_rate=5e-2, steps=4,
                                   target_psnr=None))
    log(f"  fit 64^3 from 8 views @ 96^2: route={res.mode} "
        f"losses={res.loss_history} first_step_s={res.first_step_s:.2f}")
    require(all(np.isfinite(res.loss_history)), "non-finite fit loss")
    require(res.loss_history[-1] < res.loss_history[0],
            "fit loss did not decrease")


def phase_cli(state):
    from dvren_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "out.ppm")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([os.path.join(REPO, "examples",
                                        "simple_volume.json"), out_path])
        text = buf.getvalue()
        log("  " + text.strip().replace("\n", "\n  "))
        require(rc == 0, f"cli exited {rc}")
        require(os.path.getsize(out_path) > 16, "cli wrote no image")
        require("Render path: march" in text, "cli did not take the kernel")


def phase_timing(state):
    import jax
    import jax.numpy as jnp

    import bench
    from dvren_tpu import Context, Renderer
    from dvren_tpu.ops import march
    from dvren_tpu.opt.fit import _scheduled_views, mse
    from dvren_tpu.render.pipeline import plan_jitter_table

    plan, field, _ = state["headline"]
    jitter = jnp.asarray(plan_jitter_table(plan))
    params = (field.sigma, field.color)
    res = {}
    for route in ("kernel", "plain", "kernel", "plain"):
        fwd, train = bench.route_fns(plan, field, route)
        _, f_ms = bench.time_ms(fwd, field, jitter)
        _, t_ms = bench.time_ms(train, params, jitter, iters=5)
        res.setdefault(route, []).append((f_ms, t_ms))
    for route, vals in res.items():
        log(f"  headline {route}: forward ms/frame "
            f"{[round(v[0], 3) for v in vals]}, train ms/step "
            f"{[round(v[1], 3) for v in vals]}")

    # what a Renderer user sees, host copies included: forward() and
    # backward() on the kernel route and with the route forced plain
    dl = np.ones(plan.ray_count * 3, np.float32)
    for route in ("kernel", "plain"):
        with (plain_route() if route == "plain"
              else contextlib.nullcontext()):
            r = Renderer(Context.create(), plan)
            r.forward(field)
            r.backward(field, dl)
            _, f_ms = bench.time_ms(lambda: r.forward(field), iters=5)
            _, b_ms = bench.time_ms(lambda: r.backward(field, dl), iters=5)
        log(f"  headline Renderer {route} ({r.last_path}): forward() "
            f"{f_ms:.3f} ms, backward() {b_ms:.3f} ms")

    # the fit workload's train step through the kernel's VJP vs the plain
    # step fit_dense_grid runs
    fplan, truth, cams = bench.fit_scene()
    targets = jnp.zeros((len(cams), fplan.height, fplan.width, 3))
    _, c2ws, plain_stack = _scheduled_views(fplan, cams, truth, "plain")

    def kernel_stack(f, c2ws):
        return jnp.stack([march.render_march(fplan, f, c2w=c2ws[v]).image
                          for v in range(c2ws.shape[0])])

    for mode, render_stack in (("kernel", kernel_stack),
                               ("plain", plain_stack),
                               ("kernel", kernel_stack),
                               ("plain", plain_stack)):
        def loss(p, s, render_stack=render_stack):
            return mse(render_stack(truth.with_params(*p), s), targets)

        step = jax.jit(jax.value_and_grad(loss))
        _, ms = bench.time_ms(step, (truth.sigma, truth.color), c2ws,
                              iters=5)
        log(f"  fit shape 8 x 96^2 / 64^3 {mode}: train ms/step {ms:.3f}")


@contextlib.contextmanager
def plain_route():
    """Force the plain route (to time the Renderer without the kernel)."""
    from dvren_tpu.ops import march

    select = march.select_route
    march.select_route = lambda field, **kw: march.Route(kernel=False)
    try:
        yield
    finally:
        march.select_route = select


ONE_CARD = (("render", phase_render), ("backward", phase_backward),
            ("fit", phase_fit), ("cli", phase_cli),
            ("timing", phase_timing))


# ---------------------------------------------------------- four cards


def phase_multi(state, grid_n=512, width=512, dp_res=96, dp_grid=64):
    import jax
    import jax.numpy as jnp
    import optax

    import bench
    from dvren_tpu import DenseGridField
    from dvren_tpu.parallel.mesh import make_mesh
    from dvren_tpu.parallel.shard import (make_dp_train_step,
                                          render_sharded, render_zsharded)
    from dvren_tpu.render.pipeline import (plan_jitter_table, render,
                                           render_streamed)

    devs = jax.devices()
    require(len(devs) == 4, f"--multi needs 4 devices, found {len(devs)}")
    mesh = make_mesh(4)

    # z-sharded 512^3 grid: the host volume goes slab by slab to its
    # device; the single-card reference evaluates the 8 corners directly
    # (the packed stencil of a 512^3 grid would not fit one card)
    plan = bench.headline_plan(width, width)
    host = DenseGridField(*bench.blob_volume(grid_n))
    jitter = jnp.asarray(plan_jitter_table(plan))
    t0 = time.perf_counter()
    zp = jax.block_until_ready(render_zsharded(plan, host, mesh,
                                               jitter=jitter))
    log(f"  render_zsharded {grid_n}^3 at {width}^2: "
        f"{time.perf_counter() - t0:.2f} s incl. compile")
    stats = [d.memory_stats() for d in devs]
    if None in stats:
        log("  peak bytes per device: not reported by this backend")
    else:
        peaks = [st["peak_bytes_in_use"] for st in stats]
        log(f"  peak bytes per device after the z-sharded render: {peaks}")
        require(max(peaks) <= 1.5 * min(peaks),
                f"z-sharded memory not balanced across devices: {peaks}")

    class Corners:
        """Plain 8-corner trilinear evaluation (no packed table)."""

        def __init__(self, f):
            self.f = f

        def sigma_at_planes(self, px, py, pz):
            return self.f.sigma_at_planes(px, py, pz)

        def color_at_planes(self, px, py, pz):
            return self.f.color_at_planes(px, py, pz)

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda s, c, j: render_streamed(
            plan, Corners(DenseGridField(sigma=s, color=c)), jitter=j))(
                jax.device_put(host.sigma, devs[0]),
                jax.device_put(host.color, devs[0]), jitter)
    compare_planes(f"z-sharded {grid_n}^3 vs single card", zp, ref)
    del ref, zp

    # view-data-parallel train step over 4 views vs single-card jax.grad
    fplan, truth, cams = bench.fit_scene(views=4, res=dp_res,
                                         grid_n=dp_grid)
    c2ws = jnp.stack([jnp.asarray(c.c2w, jnp.float32).reshape(3, 4)
                      for c in cams])
    targets = 0.7 * jnp.stack([render(fplan, truth, c2w=c).planes.image
                               for c in c2ws])
    params = (truth.sigma, truth.color)

    def loss_single(p):
        f = truth.with_params(*p)
        pred = jnp.stack([render(fplan, f, c2w=c).planes.image
                          for c in c2ws])
        return jnp.mean((pred - targets) ** 2)

    with jax.default_matmul_precision("highest"):
        want = jax.jit(jax.grad(loss_single))(params)
    # A plain descent step scaled per leaf so the update is as large as the
    # parameters: reading the gradient back as (p - new) / scale then loses
    # no more than float32 rounding of p.
    scales = tuple(float(jnp.max(jnp.abs(p)) / jnp.max(jnp.abs(w)))
                   for p, w in zip(params, want))
    opt = optax.GradientTransformation(
        lambda p: optax.EmptyState(),
        lambda g, s, p=None: (tuple(-gi * sc for gi, sc in zip(g, scales)),
                              s))
    step = make_dp_train_step(fplan, truth, opt, mesh)
    with mesh:
        new, _, loss = step(params, opt.init(params), c2ws, targets)
    got = [(p - n) / sc for p, n, sc in zip(params, new, scales)]
    rels = [rel_diff(g, w) for g, w in zip(got, want)]
    log(f"  view-DP step over 4 views: loss={float(loss):.6e} grad rel "
        f"diff sigma={rels[0]:.3e} color={rels[1]:.3e}")
    require(max(rels) <= TOL, f"view-DP gradients differ: {rels}")

    # ray-sharded render vs single card
    hplan, hfield = bench.headline_scene()
    rs = render_sharded(hplan, hfield, mesh)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda f: render(hplan, f).planes)(hfield)
    compare_planes("ray-sharded 512^2 vs single card", rs, ref)


# ---------------------------------------------------------------- main


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run the four-card sharded paths only")
    args = parser.parse_args(argv)

    import subprocess

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(REPO, ".jax_cache"))
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found '{dev.platform}'",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    log(f"device: {card}")
    log(f"jax devices: {jax.devices()}")
    sys.path.insert(0, REPO)

    phases = (("multi", phase_multi),) if args.multi else ONE_CARD
    state, failed = {}, []
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"[{name}]")
        try:
            fn(state)
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            failed.append(name)
            log(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s")
            continue
        log(f"[{name}] ok in {time.perf_counter() - t0:.1f} s")
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
