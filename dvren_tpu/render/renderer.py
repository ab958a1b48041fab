"""Renderer: the stateful orchestrator with a Plan-keyed executable cache.

The analogue of ``dvren::Renderer`` (reference
``include/dvren/render/renderer.hpp:15-152``, ``src/render/renderer.cpp``).
Buffer management changes completely: the reference sizes 25 host vectors and
a scratch workspace (renderer.cpp:45-113) and replays a CUDA Graph; here
buffers belong to jit-compiled executables and "graph capture" is AOT
compilation (``jax.jit(...).lower().compile()``) - compile once per Plan,
replay many times. Workspace accounting is preserved as an API
(:meth:`Renderer.workspace_info`): analytic bytes per buffer family mirroring
renderer.cpp:572-610 plus the real XLA temp allocation when compiled.

Forward/Backward semantics preserved:
- Forward runs the per-ray march kernel where ``ops.march.select_route``
  picks it (dense trilinear grids on the GPU), else the staged or fused
  path per ``RenderOptions.use_fused_path``
  (renderer.cpp:276-349), collects per-stage timings when ``capture_stats``
  and raises on sample-capacity overflow (samp_cpu.cpp:245-247 parity);
- Backward requires a prior Forward and a dL/dI of exactly ray_count*3
  (renderer.cpp:396-403), zeroes grads, produces per-sample grads
  (``hp_diff`` parity), scatters them into voxel grads, and returns real
  camera gradients where the reference returns a zero stub.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field

import jax
import jax.numpy as jnp
import numpy as np

from dvren_tpu.core.context import Context
from dvren_tpu.core.plan import Plan
from dvren_tpu.core.status import DvrenError, check
from dvren_tpu.fields.dense_grid import DenseGridField
from dvren_tpu.ops import diff as diff_ops
from dvren_tpu.ops import march
from dvren_tpu.ops.compose import compose
from dvren_tpu.ops.integrate import integrate
from dvren_tpu.ops.raygen import generate_rays
from dvren_tpu.ops.sampling import generate_samples
from dvren_tpu.render import pipeline as pipeline_mod
from dvren_tpu.render.pipeline import RenderOutputs, eval_fields, render


@dataclass(frozen=True)
class RenderOptions:
    """Mirrors ``dvren::RenderOptions`` (renderer.hpp:17-21).

    ``enable_graph`` maps to AOT precompilation (the jit-replay equivalent of
    CUDA Graph capture). ``streaming`` selects the fixed-workspace ray-tile
    path (None = automatic for plans whose lattice exceeds
    ``streaming_budget`` samples); the per-sample parity views (packed
    samples, aux, per-sample grads) stay available - they recompute the
    lattice tile-by-tile on demand with the same bounded workspace.
    ``use_window`` enables the host-built bbox window schedule
    (render/windowed.py) for forward renders of OOB_ZERO grid fields:
    provably-zero lattice steps outside the field bbox are skipped, with
    bit-exact output; the schedule is built once per (plan, field bbox) and
    replayed.

    The route itself is not an option: on the GPU, dense trilinear OOB_ZERO
    grids with generated rays render through the per-ray march kernel
    (ops/march.py); ``ops.march.select_route`` makes that choice, and the
    stats notes name the path taken.
    """

    use_fused_path: bool = True
    enable_graph: bool = False
    capture_stats: bool = True
    streaming: bool | None = None
    streaming_budget: int = 1 << 22
    use_window: bool = False


@dataclass
class WorkspaceInfo:
    """Mirrors ``dvren::WorkspaceInfo`` (renderer.hpp:23-39)."""

    ray_buffer_bytes: int = 0
    sample_buffer_bytes: int = 0
    integration_buffer_bytes: int = 0
    image_buffer_bytes: int = 0
    gradient_buffer_bytes: int = 0
    workspace_buffer_bytes: int = 0

    def total_bytes(self) -> int:
        return (self.ray_buffer_bytes + self.sample_buffer_bytes
                + self.integration_buffer_bytes + self.image_buffer_bytes
                + self.gradient_buffer_bytes + self.workspace_buffer_bytes)


@dataclass
class RenderStats:
    """Mirrors ``dvren::RenderStats`` (renderer.hpp:41-48)."""

    total_ms: float = 0.0
    ray_ms: float = 0.0
    sample_ms: float = 0.0
    integrate_ms: float = 0.0
    compose_ms: float = 0.0
    notes: list[str] = dc_field(default_factory=list)


@dataclass
class ForwardResult:
    """Mirrors ``dvren::ForwardResult`` (renderer.hpp:50-59); flat numpy
    buffers in the reference's layouts."""

    image: np.ndarray           # (H*W*3,) float32
    transmittance: np.ndarray   # (H*W,) float32
    opacity: np.ndarray         # (H*W,) float32
    depth: np.ndarray           # (H*W,) float32
    hitmask: np.ndarray         # (H*W,) uint32
    ray_count: int = 0
    sample_count: int = 0
    stats: RenderStats = dc_field(default_factory=RenderStats)


@dataclass
class BackwardResult:
    """Mirrors ``dvren::BackwardResult`` (renderer.hpp:61-66) plus real
    camera gradients (reference camera grad is a zero stub)."""

    sigma: np.ndarray           # (voxel_count,) float32, [z][y][x]
    color: np.ndarray           # (3*voxel_count,) float32
    camera: np.ndarray          # (3, 4) float32 = dL/d(c2w)
    camera_k: np.ndarray | None = None        # (3, 3) dL/dK
    sample_count: int = 0


class Renderer:
    """Plan-bound renderer with jit executable caching."""

    def __init__(self, ctx: Context, plan: Plan,
                 options: RenderOptions | None = None):
        self._ctx = ctx
        self._plan = plan
        self._options = options or RenderOptions()
        self._last_outputs: RenderOutputs | None = None
        self._last_field = None
        self._compiled_fused = None   # AOT executable when enable_graph
        self._fused_jit = jax.jit(
            lambda field, jitter: render(self._plan, field, jitter=jitter))
        self._stage_jits = None
        self._backward_jit = jax.jit(self._backward_impl,
                                     static_argnums=(4,))
        # Stratified jitter is a pure function of (seed, ray, step) -
        # precomputed host-side, device-resident across calls.
        self._jitter_host = pipeline_mod.plan_jitter_table(plan)
        self._jitter = None
        lattice_samples = plan.ray_count * plan.sampling.max_steps
        if self._options.streaming is None:
            self._streaming = lattice_samples > self._options.streaming_budget
        else:
            self._streaming = bool(self._options.streaming)
        self._stream_jit = jax.jit(
            lambda field, jitter: pipeline_mod.render_streamed(
                self._plan, field, jitter=jitter))
        self._stream_bwd_jit = None
        self._stream_bwd_key = None
        self._window_schedule = None
        self._window_bbox = None
        self._window_jit = None
        self._window_aot = None
        self._window_bwd_jit = None
        self._window_bwd_key = None
        self._march_jit = None      # (interpret, jitted render_march)
        self._march_aot = None      # (AOT executable, field meta key)
        self._last_mode = None
        self._last_ray_count = plan.ray_count
        self._override_jit = None
        self._parity_jit = None  # (key, fn) parity-view tile executable
        self._override_jitter = {}  # bundle size -> host jitter table
        self._bwd_aot = {}  # mode -> (AOT executable, field meta key)

    # ------------------------------------------------------------------ fwd

    @property
    def plan(self) -> Plan:
        return self._plan

    @property
    def options(self) -> RenderOptions:
        return self._options

    def _build_stage_jits(self):
        plan = self._plan

        def stage_rays():
            return generate_rays(plan)

        def stage_samples(rays, jitter):
            return generate_samples(plan, rays, jitter=jitter)

        def stage_fields(field, lattice):
            return eval_fields(field, lattice)

        def stage_integrate(sigma, color, lattice):
            return integrate(sigma, color, lattice.dt, lattice.mask,
                             plan.t_near, plan.t_far)

        def stage_compose(rays, intl):
            return compose(rays.pixel_ids, intl.radiance, intl.transmittance,
                           intl.opacity, intl.depth, plan.width, plan.height,
                           plan.t_far)

        return dict(
            rays=jax.jit(stage_rays),
            samples=jax.jit(stage_samples),
            fields=jax.jit(stage_fields),
            integrate=jax.jit(stage_integrate),
            compose=jax.jit(stage_compose),
        )

    def _device_jitter(self):
        if self._jitter is None and self._jitter_host is not None:
            self._jitter = jax.device_put(self._jitter_host)
        return self._jitter

    def _analytic_sample_count(self) -> int:
        """Live-sample count for generated rays: every ray marches
        min(max_steps, #k with t_near + k*dt < t_far) steps."""
        plan = self._plan
        span = plan.t_far - plan.t_near
        import math
        k_live = int(math.ceil(span / plan.sampling.dt - 1e-9))
        return plan.ray_count * min(plan.sampling.max_steps, max(k_live, 0))

    def forward(self, field, out: ForwardResult | None = None,
                rays=None) -> ForwardResult:
        """Render one frame; analogue of Renderer::Forward (renderer.cpp:232).

        ``rays``: optional override bundle (the hp_ray override path,
        ray_cpu.cpp:148-150) - a :class:`dvren_tpu.ops.raygen.Rays` with up
        to plan.max_rays entries. Override bundles may collide on pixels;
        the compose then accumulates (image +=, T *=, depth = min) exactly
        like img_cpu.cpp:161-185. Overrides always run the in-memory fused
        path (streaming/window schedules assume generated rays).
        """
        stats = RenderStats()
        t0 = time.perf_counter()

        if rays is not None:
            outputs = self._forward_override(field, rays, stats)
            jax.block_until_ready(outputs.planes)
            stats.total_ms = (time.perf_counter() - t0) * 1e3
            sample_count = int(outputs.lattice.sample_count())
            planes = outputs.planes
            self._last_mode = "override"
        elif self._options.use_window:
            planes = self._forward_windowed(field, stats)
            jax.block_until_ready(planes)
            stats.total_ms = (time.perf_counter() - t0) * 1e3
            sample_count = self._analytic_sample_count()
            outputs = None
            self._last_mode = "windowed"
        elif (route := march.select_route(field)).kernel:
            planes = self._forward_march(field, stats, route)
            jax.block_until_ready(planes)
            stats.total_ms = (time.perf_counter() - t0) * 1e3
            sample_count = self._analytic_sample_count()
            outputs = None
            self._last_mode = "march"
        elif self._streaming:
            planes = self._forward_streamed(field, stats)
            jax.block_until_ready(planes)
            stats.total_ms = (time.perf_counter() - t0) * 1e3
            sample_count = self._analytic_sample_count()
            outputs = None
            self._last_mode = "streamed"
        else:
            if self._options.use_fused_path:
                outputs = self._forward_fused(field, stats)
            else:
                outputs = self._forward_staged(field, stats)
            jax.block_until_ready(outputs.planes)
            stats.total_ms = (time.perf_counter() - t0) * 1e3
            sample_count = int(outputs.lattice.sample_count())
            planes = outputs.planes
            self._last_mode = "fused"
        check(sample_count <= self._plan.max_samples,
              f"sample capacity exceeded: {sample_count} > "
              f"{self._plan.max_samples}")

        self._last_outputs = outputs
        self._last_field = field
        self._last_ray_count = (rays.origins.shape[0] if rays is not None
                                else self._plan.ray_count)
        result = out or ForwardResult(
            image=np.empty(0), transmittance=np.empty(0),
            opacity=np.empty(0), depth=np.empty(0), hitmask=np.empty(0))
        result.image = np.asarray(planes.image, np.float32).reshape(-1)
        result.transmittance = np.asarray(
            planes.transmittance, np.float32).reshape(-1)
        result.opacity = np.asarray(planes.opacity, np.float32).reshape(-1)
        result.depth = np.asarray(planes.depth, np.float32).reshape(-1)
        result.hitmask = np.asarray(planes.hitmask, np.uint32).reshape(-1)
        result.ray_count = self._last_ray_count
        result.sample_count = sample_count
        result.stats = stats
        return result

    # Keep the reference-style capitalized aliases.
    Forward = forward

    def _forward_streamed(self, field, stats: RenderStats):
        jitter = self._device_jitter()
        if self._options.enable_graph:
            meta = self._field_meta_key(field)
            if (self._compiled_fused is None
                    or self._compiled_fused[1] != meta):
                t0 = time.perf_counter()
                self._compiled_fused = (self._stream_jit.lower(
                    field, jitter).compile(), meta)
                stats.notes.append(
                    f"graph_captured_aot_compile_ms="
                    f"{(time.perf_counter() - t0) * 1e3:.3f}")
                self._graph_capture_backward("streamed", field, stats)
            planes = self._compiled_fused[0](field, jitter)
            stats.notes.append("graph_executed")
        else:
            planes = self._stream_jit(field, jitter)
        stats.notes.append("streaming_path")
        return planes

    def _forward_override(self, field, rays, stats: RenderStats):
        """Override-bundle forward (hp_ray override, ray_cpu.cpp:14-43).

        Stratified jitter is keyed on the BUNDLE index (the reference hashes
        (seed, ray_idx, step) where ray_idx is the bundle position,
        samp_cpu.cpp:233), so the host table is built per bundle size."""
        from dvren_tpu.ops.raygen import validate_override

        rays = validate_override(self._plan, rays)
        n = rays.origins.shape[0]
        jitter = None
        if self._jitter_host is not None:  # stratified plan
            if n not in self._override_jitter:
                from dvren_tpu.ops import rng
                self._override_jitter[n] = jax.device_put(rng.jitter_table(
                    self._plan.seed, n, self._plan.sampling.max_steps))
            jitter = self._override_jitter[n]
        if self._override_jit is None:
            self._override_jit = jax.jit(
                lambda f, r, j: render(self._plan, f, rays=r, jitter=j))
        outputs = self._override_jit(field, rays, jitter)
        stats.notes.append("override_path")
        return outputs

    def _forward_march(self, field, stats: RenderStats, route):
        """Per-ray fused march kernel (ops/march.py): no schedule, no
        lattice in device memory; the backward that follows is the
        streamed path's."""
        jitter = self._device_jitter()
        if self._march_jit is None or self._march_jit[0] != route.interpret:
            self._march_jit = (route.interpret, jax.jit(
                lambda f, j: march.render_march(
                    self._plan, f, jitter=j, interpret=route.interpret)))
            self._march_aot = None
        if self._options.enable_graph:
            meta = self._field_meta_key(field)
            if self._march_aot is None or self._march_aot[1] != meta:
                t0 = time.perf_counter()
                self._march_aot = (self._march_jit[1].lower(
                    field, jitter).compile(), meta)
                stats.notes.append(
                    f"graph_captured_aot_compile_ms="
                    f"{(time.perf_counter() - t0) * 1e3:.3f}")
                self._graph_capture_backward("streamed", field, stats)
            planes = self._march_aot[0](field, jitter)
            stats.notes.append("graph_executed")
        else:
            planes = self._march_jit[1](field, jitter)
        stats.notes.append(route.note)
        return planes

    def _graph_capture_backward(self, mode, field, stats: RenderStats):
        """AOT-compile the backward with the forward under ``enable_graph``
        - the reference's graph capture includes hp_diff when dL/dI is
        bound (graph_cuda.cu:151-168); here "capture" = jit AOT, so the
        training-step replay never hits a cold compile."""
        try:
            params = self._grad_params(field)
            dl0 = jnp.zeros((self._plan.height, self._plan.width, 3),
                            jnp.float32)
            k0 = jnp.asarray(self._plan.camera.k, jnp.float32).reshape(3, 3)
            c2w0 = jnp.asarray(
                self._plan.camera.c2w, jnp.float32).reshape(3, 4)
            t0 = time.perf_counter()
            if mode == "windowed":
                aot = self._get_window_bwd(field).lower(
                    params, c2w0, k0, dl0, self._window_schedule).compile()
            else:  # streamed (after a streamed or march forward)
                aot = self._get_stream_bwd(field).lower(
                    params, c2w0, k0, dl0, self._device_jitter()).compile()
            self._bwd_aot[mode] = (aot, self._field_meta_key(field))
            stats.notes.append(
                f"graph_captured_bwd_compile_ms="
                f"{(time.perf_counter() - t0) * 1e3:.3f}")
        except Exception as exc:  # degrade gracefully (renderer.cpp:515-533)
            stats.notes.append(f"graph_capture_bwd_failed:{exc}")

    def _forward_windowed(self, field, stats: RenderStats):
        from dvren_tpu.render import windowed as windowed_mod

        check(hasattr(field, "bbox_min") and hasattr(field, "bbox_max"),
              "use_window requires a bounded grid field "
              "(bbox_min/bbox_max); unbounded fields (hash-MLP) cannot be "
              "window-clipped")
        bbox = (tuple(np.asarray(field.bbox_min, np.float64).tolist()),
                tuple(np.asarray(field.bbox_max, np.float64).tolist()))
        if self._window_schedule is None or self._window_bbox != bbox:
            t0 = time.perf_counter()
            self._window_schedule = windowed_mod.build_schedule(
                self._plan, field.bbox_min, field.bbox_max,
                jitter=self._jitter_host)
            self._window_bbox = bbox
            self._window_jit = jax.jit(
                lambda f, s: windowed_mod.render_windowed_traced(
                    self._plan, f, s))
            self._window_aot = None
            self._window_bwd_jit = None
            self._window_bwd_key = None
            self._bwd_aot.pop("windowed", None)
            sched = self._window_schedule
            stats.notes.append(
                f"window_schedule_build_ms="
                f"{(time.perf_counter() - t0) * 1e3:.3f}")
            stats.notes.append(
                f"window_samples={sched.windowed_samples}"
                f"/{sched.full_lattice_samples}"
                f" skipped_rays={sched.skipped_rays}")
        if self._options.enable_graph:
            meta = self._field_meta_key(field)
            if self._window_aot is None or self._window_aot[1] != meta:
                t0 = time.perf_counter()
                self._window_aot = (self._window_jit.lower(
                    field, self._window_schedule).compile(), meta)
                stats.notes.append(
                    f"graph_captured_aot_compile_ms="
                    f"{(time.perf_counter() - t0) * 1e3:.3f}")
                self._graph_capture_backward("windowed", field, stats)
            planes = self._window_aot[0](field, self._window_schedule)
            stats.notes.append("graph_executed")
        else:
            planes = self._window_jit(field, self._window_schedule)
        stats.notes.append("windowed_path")
        return planes

    def _forward_fused(self, field, stats: RenderStats) -> RenderOutputs:
        jitter = self._device_jitter()
        if self._options.enable_graph:
            meta = self._field_meta_key(field)
            if (self._compiled_fused is None
                    or self._compiled_fused[1] != meta):
                t0 = time.perf_counter()
                lowered = self._fused_jit.lower(field, jitter)
                self._compiled_fused = (lowered.compile(), meta)
                stats.notes.append(
                    f"graph_captured_aot_compile_ms="
                    f"{(time.perf_counter() - t0) * 1e3:.3f}")
            outputs = self._compiled_fused[0](field, jitter)
            stats.notes.append("graph_executed")
        else:
            outputs = self._fused_jit(field, jitter)
            stats.notes.append("fused_path")
        return outputs

    def _forward_staged(self, field, stats: RenderStats) -> RenderOutputs:
        if self._stage_jits is None:
            self._stage_jits = self._build_stage_jits()
        s = self._stage_jits
        capture = self._options.capture_stats

        def timed(label, fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            if capture:
                jax.block_until_ready(out)
                setattr(stats, label, (time.perf_counter() - t0) * 1e3)
            return out

        rays = timed("ray_ms", s["rays"])
        lattice = timed("sample_ms", s["samples"], rays,
                        self._device_jitter())
        t0 = time.perf_counter()
        sigma, color = s["fields"](field, lattice)
        intl = s["integrate"](sigma, color, lattice)
        if capture:
            jax.block_until_ready(intl)
            stats.integrate_ms = (time.perf_counter() - t0) * 1e3
        planes = timed("compose_ms", s["compose"], rays, intl)
        stats.notes.append("staged_path")
        return RenderOutputs(rays=rays, lattice=lattice, sigma=sigma,
                             color=color, intl=intl, planes=planes)

    # ------------------------------------------------------------------ bwd

    def _backward_impl(self, field, outputs: RenderOutputs,
                       dl_dradiance: jnp.ndarray, jitter,
                       with_camera: bool = True):
        d_sigma_s, d_color_s = diff_ops.per_sample_grads(
            dl_dradiance, outputs.sigma, outputs.color,
            outputs.lattice.dt, outputs.lattice.mask)
        sigma_g, color_g = field.accumulate_sample_gradients(
            outputs.lattice.positions, d_sigma_s, d_color_s)
        if with_camera:
            cam = diff_ops.camera_grads(self._plan, field, dl_dradiance,
                                        jitter=jitter)
        else:
            # Override bundles have no generating camera; the reference's
            # dCam is a zero stub always (diff_cpu.cpp:41-47,74).
            cam = {"c2w": jnp.zeros((3, 4), jnp.float32),
                   "k": jnp.zeros((3, 3), jnp.float32),
                   "ortho_scale": jnp.zeros((), jnp.float32)}
        return d_sigma_s, d_color_s, sigma_g, color_g, cam

    def backward(self, field: DenseGridField, dl_di,
                 out: BackwardResult | None = None) -> BackwardResult:
        """Analogue of Renderer::Backward (renderer.cpp:390-446).

        ``dl_di`` is flat (ray_count*3,) or (ray_count, 3): the loss gradient
        w.r.t. per-ray radiance.
        """
        if self._last_field is None or self._last_mode is None:
            raise DvrenError.invalid_argument(
                "Backward requires a prior Forward")
        mode = self._last_mode
        # The streamed/windowed backward drives field.with_params + the
        # dense sigma/color params; the in-memory path needs the explicit
        # scatter hook.
        dense_like = (
            hasattr(field, "accumulate_sample_gradients")
            if mode in ("fused", "override")
            else (hasattr(field, "with_params")
                  and hasattr(field, "sigma")
                  and hasattr(field, "color")))
        if not dense_like:
            raise DvrenError.unsupported(
                "Renderer.backward targets dense voxel grids (the reference "
                "hp_diff contract); train other field families through "
                "jax.grad over dvren_tpu.render.pipeline.render (hash-MLP: "
                "opt.fit.fit_hash_mlp)")
        n = self._last_ray_count
        dl = np.asarray(dl_di, np.float32).reshape(-1)
        check(dl.size == n * 3,
              f"dL/dI must have {n * 3} elements, got {dl.size}")
        if mode == "windowed" and self._window_schedule is not None:
            # Differentiate the windowed replay itself: the schedule's
            # zero-contribution clipping is gradient-exact for OOB_ZERO
            # fields (skipped samples have sigma == 0 in an open
            # neighborhood, so their adjoint is identically zero).
            return self._backward_windowed(field, dl.reshape(n, 3), out)
        if mode in ("streamed", "windowed", "march"):
            # Streaming and march forwards never materialize the lattice;
            # the streamed backward recomputes it (same math) and adds
            # camera grads.
            return self._backward_streamed(field, dl.reshape(n, 3), out)
        outputs = self._last_outputs
        sample_count = int(outputs.lattice.sample_count())
        check(sample_count > 0, "Backward requires a non-empty sample set")

        dl_dev = jnp.asarray(dl.reshape(n, 3))
        _, _, sigma_g, color_g, cam = self._backward_jit(
            field, outputs, dl_dev, self._device_jitter(),
            mode != "override")

        result = out or BackwardResult(
            sigma=np.empty(0), color=np.empty(0),
            camera=np.zeros((3, 4), np.float32))
        result.sigma = np.asarray(sigma_g, np.float32).reshape(-1)
        result.color = np.asarray(color_g, np.float32).reshape(-1)
        result.camera = np.asarray(cam["c2w"], np.float32)
        result.camera_k = np.asarray(cam["k"], np.float32)
        result.sample_count = sample_count
        return result

    Backward = backward

    def _dl_image(self, dl: np.ndarray) -> jnp.ndarray:
        """Scatter per-ray dL/dI (N, 3) into the (H, W, 3) image plane
        (generated rays own their pixels)."""
        plan = self._plan
        roi = plan.roi
        dl_img = np.zeros((plan.height, plan.width, 3), np.float32)
        ys = roi.y + np.arange(plan.ray_count) // roi.width
        xs = roi.x + np.arange(plan.ray_count) % roi.width
        dl_img[ys, xs] = dl
        return jnp.asarray(dl_img)

    @staticmethod
    def _grad_params(field) -> tuple:
        """Traced parameter leaves for ``field.with_params`` on the
        replay backward paths."""
        return (field.sigma, field.color)

    @staticmethod
    def _field_meta_key(field) -> tuple:
        """Static facts a cached backward executable was traced against;
        a later call with different field *metadata* (same array shapes)
        must rebuild, or gradients silently use the stale configuration."""
        if isinstance(getattr(field, "params", None), dict):
            return (getattr(field, "spec", None),)     # hash-MLP field
        return (tuple(field.bbox_min), tuple(field.bbox_max),
                getattr(field, "interp", None), getattr(field, "oob", None),
                getattr(field, "packed_dtype", None))

    def _finish_backward(self, grads, out: BackwardResult | None):
        params_g, dc2w, dk = grads
        result = out or BackwardResult(
            sigma=np.empty(0), color=np.empty(0),
            camera=np.zeros((3, 4), np.float32))
        sigma_g, color_g = params_g
        result.sigma = np.asarray(sigma_g, np.float32).reshape(-1)
        result.color = np.asarray(color_g, np.float32).reshape(-1)
        result.camera = np.asarray(dc2w, np.float32)
        result.camera_k = np.asarray(dk, np.float32)
        result.sample_count = self._analytic_sample_count()
        return result

    def _get_stream_bwd(self, field):
        """Jitted gradient of the streamed plain path; it saves the
        lattice's residuals or rematerializes per tile by the plan's size
        (``pipeline.stream_needs_remat``)."""
        meta_key = self._field_meta_key(field)
        if self._stream_bwd_jit is None or self._stream_bwd_key != meta_key:
            plan_ref = self._plan
            field_ref = field  # static metadata only; params are traced

            def loss(params, c2w, k_mat, dl_img_dev, jitter):
                f = field_ref.with_params(*params)
                planes = pipeline_mod.render_streamed(
                    plan_ref, f, k=k_mat, c2w=c2w, jitter=jitter)
                return jnp.sum(planes.image * dl_img_dev)

            self._stream_bwd_jit = jax.jit(
                jax.grad(loss, argnums=(0, 1, 2)))
            self._stream_bwd_key = meta_key
        return self._stream_bwd_jit

    def _backward_streamed(self, field: DenseGridField, dl: np.ndarray,
                           out: BackwardResult | None) -> BackwardResult:
        """Streaming/march-mode backward: per-ray dL/dI is scattered to the
        image plane (generated rays own their pixels) and the gradient
        recomputes the lattice ray tile by ray tile - nothing persisted
        between Forward and Backward, matching the in-kernel-recompute
        design (BASELINE.json north star) rather than the reference's
        stored aux."""
        plan = self._plan
        dl_dev = self._dl_image(dl)
        jitter = self._device_jitter()
        k0 = jnp.asarray(plan.camera.k, jnp.float32).reshape(3, 3)
        c2w0 = jnp.asarray(plan.camera.c2w, jnp.float32).reshape(3, 4)
        aot = self._bwd_aot.get("streamed")
        if aot is not None and aot[1] == self._field_meta_key(field):
            grads = aot[0]((field.sigma, field.color), c2w0, k0, dl_dev,
                           jitter)
        else:
            grads = self._get_stream_bwd(field)(
                (field.sigma, field.color), c2w0, k0, dl_dev, jitter)
        return self._finish_backward(grads, out)

    def _get_window_bwd(self, field):
        from dvren_tpu.render import windowed as windowed_mod

        meta_key = self._field_meta_key(field)
        if self._window_bwd_jit is None or self._window_bwd_key != meta_key:
            plan_ref = self._plan
            field_ref = field

            def loss(params, c2w, k_mat, dl_img_dev, sched):
                f = field_ref.with_params(*params)
                planes = windowed_mod.render_windowed_traced(
                    plan_ref, f, sched, k=k_mat, c2w=c2w)
                return jnp.sum(planes.image * dl_img_dev)

            self._window_bwd_jit = jax.jit(
                jax.grad(loss, argnums=(0, 1, 2)))
            self._window_bwd_key = meta_key
        return self._window_bwd_jit

    def _backward_windowed(self, field: DenseGridField, dl: np.ndarray,
                           out: BackwardResult | None) -> BackwardResult:
        """Windowed-mode backward: differentiates the same windowed replay
        the forward executed (schedule reuse), instead of falling back to
        the full-lattice streamed gradient. Camera gradients flow through
        the windowed ray generation at the schedule's camera."""
        from dvren_tpu.render import windowed as windowed_mod

        plan = self._plan
        dl_dev = self._dl_image(dl)
        schedule = self._window_schedule

        k0 = jnp.asarray(plan.camera.k, jnp.float32).reshape(3, 3)
        c2w0 = jnp.asarray(plan.camera.c2w, jnp.float32).reshape(3, 4)
        aot = self._bwd_aot.get("windowed")
        if aot is not None and aot[1] == self._field_meta_key(field):
            grads = aot[0]((field.sigma, field.color), c2w0, k0, dl_dev,
                           schedule)
        else:
            grads = self._get_window_bwd(field)(
                (field.sigma, field.color), c2w0, k0, dl_dev, schedule)
        return self._finish_backward(grads, out)

    # ------------------------------------------------- parity views (packed)

    def _parity_tile_fn(self, field, with_grads: bool):
        """One jit executable computing a ray tile's parity quantities.

        The production-size analogue of the reference's always-persisted
        per-sample state (int_cpu.cpp:201-207): instead of materializing the
        whole lattice, the view streams fixed-shape ray tiles (bounded device
        memory) and packs on the host. The tile function is cached per
        (field metadata, with_grads)."""
        key = (self._field_meta_key(field), with_grads)
        cached = getattr(self, "_parity_jit", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        plan = self._plan
        tile = pipeline_mod.default_ray_tile(plan)

        def tile_fn(field, start, jitter, dl_tile):
            rays = generate_rays(plan, start=start, count=tile)
            block_jitter = None
            if jitter is not None:
                block_jitter = jax.lax.dynamic_slice(
                    jitter, (start, 0), (tile, jitter.shape[1]))
            lattice = generate_samples(plan, rays, ray_index_offset=start,
                                       jitter=block_jitter)
            sigma, color = eval_fields(field, lattice)
            out = dict(mask=lattice.mask, positions=lattice.positions,
                       dt=lattice.dt, sigma=sigma,
                       color=jnp.stack(color, axis=-1))
            if with_grads:
                d_sigma, d_color = diff_ops.per_sample_grads(
                    dl_tile, sigma, color, lattice.dt, lattice.mask)
                out.update(d_sigma=d_sigma, d_color=d_color)
            else:
                intl = integrate(sigma, color, lattice.dt, lattice.mask,
                                 plan.t_near, plan.t_far, with_aux=True)
                out.update(aux=intl.aux)
            return out

        fn = jax.jit(tile_fn)
        self._parity_jit = (key, fn)
        return fn

    def _stream_parity_views(self, field, keys: tuple,
                             dl: np.ndarray | None = None) -> dict:
        """Packed per-sample views for streaming/windowed/march modes by
        recomputing the full lattice tile-by-tile. The window schedules
        only skip provably-zero contributions, so the reference-parity view
        IS the full lattice's (same live mask, same values)."""
        plan = self._plan
        n = plan.ray_count
        tile = pipeline_mod.default_ray_tile(plan)
        n_tiles = -(-n // tile)
        jitter = self._device_jitter()
        if jitter is not None and jitter.shape[0] < n_tiles * tile:
            jitter = jnp.pad(
                jitter, ((0, n_tiles * tile - jitter.shape[0]), (0, 0)))
        fn = self._parity_tile_fn(field, dl is not None)
        packed = {k: [] for k in keys}
        counts = []
        for t in range(n_tiles):
            start = t * tile
            valid = min(tile, n - start)
            dl_tile = None
            if dl is not None:
                dl_tile = np.zeros((tile, 3), np.float32)
                dl_tile[:valid] = dl[start:start + valid]
                dl_tile = jnp.asarray(dl_tile)
            out = fn(field, jnp.int32(start), jitter, dl_tile)
            mask = np.asarray(out["mask"])[:valid]
            counts.append(mask.sum(axis=1))
            for k in keys:
                packed[k].append(np.asarray(out[k])[:valid][mask])
        views = {k: np.concatenate(packed[k]) for k in keys}
        live = np.concatenate(counts)
        views["ray_offset"] = np.concatenate(
            [[0], np.cumsum(live)]).astype(np.uint32)
        return views

    def per_sample_gradients(self, dl_di) -> tuple[np.ndarray, np.ndarray]:
        """Packed per-sample (dsigma (M,), dcolor (M,3)) - ``hp_diff`` parity
        view over live samples in ray-major order. In streaming/windowed/
        march modes the lattice is recomputed tile-by-tile (bounded device
        memory) - the view works at production sizes."""
        n = self._last_ray_count
        dl = np.asarray(dl_di, np.float32).reshape(n, 3)
        if self._last_mode in ("streamed", "windowed", "march"):
            if self._last_field is None:
                raise DvrenError.invalid_argument(
                    "per_sample_gradients requires a prior Forward")
            views = self._stream_parity_views(
                self._last_field, ("d_sigma", "d_color"), dl=dl)
            return views["d_sigma"], views["d_color"]
        if self._last_outputs is None:
            raise DvrenError.invalid_argument(
                "per_sample_gradients requires a prior Forward")
        outputs = self._last_outputs
        dl_dev = jnp.asarray(dl)
        d_sigma, d_color = diff_ops.per_sample_grads(
            dl_dev, outputs.sigma, outputs.color,
            outputs.lattice.dt, outputs.lattice.mask)
        mask = np.asarray(outputs.lattice.mask)
        return (np.asarray(d_sigma)[mask], np.asarray(d_color)[mask])

    def packed_aux(self) -> np.ndarray:
        """Packed per-sample aux (M, 4) = (alpha, weight, T_before,
        logT_before) over live samples in ray-major order - the reference's
        always-persisted integration state (int_cpu.cpp:201-207). Available
        in every mode; streaming/windowed/march recompute it tile-by-tile."""
        if self._last_field is None:
            raise DvrenError.invalid_argument(
                "packed_aux requires a prior Forward")
        if self._last_mode in ("streamed", "windowed", "march"):
            return self._stream_parity_views(self._last_field, ("aux",))["aux"]
        out = self._last_outputs
        if out.intl.aux is None:  # pragma: no cover - render() keeps aux
            return self._stream_parity_views(self._last_field, ("aux",))["aux"]
        mask = np.asarray(out.lattice.mask)
        return np.asarray(out.intl.aux)[mask]

    def packed_samples(self) -> dict:
        """Reference-style packed sample stream (``hp_samp_t`` parity view,
        hp.h:132-138): positions (M,3), dt (M,), sigma (M,), color (M,3),
        ray_offset (N+1,) over live samples in ray-major order. Uses the
        native C packing when available. In streaming/windowed/march modes
        the lattice is recomputed tile-by-tile (bounded device memory)."""
        if self._last_mode in ("streamed", "windowed", "march"):
            if self._last_field is None:
                raise DvrenError.invalid_argument(
                    "packed_samples requires a prior Forward")
            views = self._stream_parity_views(
                self._last_field, ("positions", "dt", "sigma", "color"))
            return {k: views[k] for k in
                    ("positions", "dt", "sigma", "color", "ray_offset")}
        if self._last_outputs is None:
            raise DvrenError.invalid_argument(
                "packed_samples requires a prior Forward")
        out = self._last_outputs
        mask = np.asarray(out.lattice.mask)
        color = np.stack([np.asarray(c) for c in out.color], axis=-1)
        try:
            from dvren_tpu import native
            if native.available():
                return {
                    "positions": native.pack_samples(
                        mask, np.asarray(out.lattice.positions)),
                    "dt": native.pack_samples(mask,
                                              np.asarray(out.lattice.dt)),
                    "sigma": native.pack_samples(mask, np.asarray(out.sigma)),
                    "color": native.pack_samples(mask, color),
                    "ray_offset": native.ray_offsets(mask),
                }
        except Exception:  # pragma: no cover - toolchain-dependent
            pass
        positions = np.asarray(out.lattice.positions)
        offsets = np.asarray(out.lattice.ray_offsets()).astype(np.uint32)
        return {
            "positions": positions[mask],
            "dt": np.asarray(out.lattice.dt)[mask],
            "sigma": np.asarray(out.sigma)[mask],
            "color": color[mask],
            "ray_offset": offsets,
        }

    # ------------------------------------------------------------ accounting

    @property
    def last_path(self) -> str | None:
        """Path the last forward took: "march" (the kernel), "fused",
        "streamed", "windowed" or "override"."""
        return self._last_mode

    @property
    def last_outputs(self) -> RenderOutputs | None:
        """Device-side outputs of the last forward (for functional users)."""
        return self._last_outputs

    def workspace_info(self) -> WorkspaceInfo:
        """Analytic byte accounting per buffer family (renderer.cpp:572-610).

        Sample-family capacity is the dense lattice N*K (the static-shape
        replacement for max_samples ragged packing). ``workspace_buffer_bytes``
        reports XLA's real temp allocation when an AOT executable exists,
        else an estimate.
        """
        plan = self._plan
        n = plan.ray_count
        k = plan.sampling.max_steps
        nk = n * k
        f32 = 4
        info = WorkspaceInfo()
        info.ray_buffer_bytes = n * (3 + 3 + 1 + 1) * f32 + n * 4
        info.sample_buffer_bytes = (nk * (3 + 1 + 1 + 3) * f32
                                    + nk * 1  # mask (bool)
                                    + (n + 1) * 4)
        info.integration_buffer_bytes = n * (3 + 1 + 1 + 1) * f32 + nk * 4 * f32
        pixels = plan.pixel_count
        info.image_buffer_bytes = pixels * (3 + 1 + 1 + 1) * f32 + pixels * 4
        info.gradient_buffer_bytes = nk * f32 + nk * 3 * f32 + 12 * f32
        # Real XLA temp allocation from whichever executables exist: the
        # production path's forward AOT (march/windowed/fused-stream) plus
        # any captured backward (the reference reports real scratch on its
        # real path, renderer.cpp:572-610).
        candidates = [self._compiled_fused, self._march_aot,
                      self._window_aot] + list(self._bwd_aot.values())
        for aot in candidates:
            if aot is None:
                continue
            try:
                mem = aot[0].memory_analysis()
                info.workspace_buffer_bytes = max(
                    info.workspace_buffer_bytes,
                    int(getattr(mem, "temp_size_in_bytes", 0)))
            except Exception:  # pragma: no cover - backend-dependent
                pass
        if not info.workspace_buffer_bytes:
            # Analytic scratch estimate when no AOT executable exists (the
            # reference reports real scratch always, renderer.cpp:572-610):
            # the dominant XLA temporaries are the gathered packed-stencil
            # rows (32 f32/sample) plus ~8 live sample planes, over one
            # streaming tile (streamed/windowed) or the full lattice.
            if self._streaming or self._options.use_window:
                live = min(nk, pipeline_mod.default_ray_tile(plan) * k)
            else:
                live = nk
            info.workspace_buffer_bytes = live * (32 + 8) * f32
        return info
