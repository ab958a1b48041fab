"""dvren-tpu: a differentiable emission-absorption volume renderer in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
C++/CUDA project ``HinaPE/diff-volume-renderer`` (dvren):

- the staged ``hp_ray -> hp_samp -> hp_int -> hp_img`` pipeline and the fused
  ``hp_samp_int_fused`` path (reference ``hotpath/include/hotpath/hp.h:162-216``)
  become pure jit-compiled functions over static-shape ray/sample lattices;
- the ragged per-ray sample packing (``hp_samp_t.ray_offset``) becomes a dense
  ``(num_rays, max_steps)`` lattice with a validity mask (XLA needs static
  shapes); packed views are provided at the API boundary for parity;
- the sequential transmittance loop with early termination
  (``hotpath/src/cpu/int_cpu.cpp:173-226``) becomes a parallel cumulative
  product - mathematically identical, O(log K) depth; on the GPU the
  Renderer's forward instead runs the reference's per-ray design as one
  fused march kernel (``ops/march.py``);
- the entire backward subsystem (``hotpath/src/cpu/diff_cpu.cpp``,
  ``src/fields/dense_grid.cpp:171-309``) is derived by ``jax.vjp`` through the
  same forward program, yielding per-sample, per-voxel *and* camera gradients
  (the reference's camera gradient is a zero stub);
- CUDA Graph capture/replay (``hotpath/src/cuda/graph_cuda.cu``) maps to
  AOT-compiled jit executables keyed by an immutable :class:`~dvren_tpu.Plan`.

Public API mirrors the reference host library (``include/dvren/``):
Context, Plan, DenseGridField, Renderer, plus a JSON-driven CLI.
"""

from dvren_tpu.version import __version__

from dvren_tpu.core.status import Status, StatusCode, DvrenError
from dvren_tpu.core.context import Context, ContextOptions
from dvren_tpu.core.plan import (
    CameraConfig,
    CameraModel,
    InterpMode,
    OobPolicy,
    Plan,
    PlanConfig,
    Roi,
    SamplingConfig,
    SamplingMode,
)
from dvren_tpu.fields.dense_grid import DenseGridConfig, DenseGridField
from dvren_tpu.fields.hash_mlp import HashMLPConfig, HashMLPField
from dvren_tpu.fields.sparse_grid import SparseGridField
from dvren_tpu.render.renderer import (
    BackwardResult,
    ForwardResult,
    Renderer,
    RenderOptions,
    RenderStats,
    WorkspaceInfo,
)
from dvren_tpu.render.windowed import (
    WindowedSchedule,
    build_schedule,
    render_windowed,
    render_windowed_traced,
)

__all__ = [
    "__version__",
    "Status",
    "StatusCode",
    "DvrenError",
    "Context",
    "ContextOptions",
    "CameraConfig",
    "CameraModel",
    "InterpMode",
    "OobPolicy",
    "Plan",
    "PlanConfig",
    "Roi",
    "SamplingConfig",
    "SamplingMode",
    "DenseGridConfig",
    "DenseGridField",
    "HashMLPConfig",
    "HashMLPField",
    "SparseGridField",
    "Renderer",
    "RenderOptions",
    "RenderStats",
    "ForwardResult",
    "BackwardResult",
    "WorkspaceInfo",
    "WindowedSchedule",
    "build_schedule",
    "render_windowed",
    "render_windowed_traced",
]
