"""Dense voxel grid field evaluation: nearest / trilinear, OOB zero / clamp.

Vectorized replacement for ``hotpath/src/cpu/grid_dense_cpu.cpp:56-245``:
batched gathers over a (Z, Y, X[, C]) grid instead of a per-sample fetch
lambda. Written as one differentiable jnp program - its ``jax.vjp`` w.r.t.
the grid *is* the trilinear 8-corner scatter-add the reference hand-codes in
``src/fields/dense_grid.cpp:171-309``, and its vjp
w.r.t. positions feeds camera gradients.

Layout: the hot entry point is :func:`eval_grid_planes`, which takes the
sample coordinates as three (N, K) planes and returns per-channel planes.
:func:`eval_grid` keeps the (..., 3)-positions API for parity callers.

Coordinate convention (grid_dense_cpu.cpp:94-119,157-159): world position is
normalized by the field bbox to local in [0,1], then scaled by (n-1) so voxel
centers sit at the lattice points. OOB_ZERO returns 0 outside; OOB_CLAMP
clamps local coords into [0,1].

Note: the reference *forward* hardcodes the bbox to [0,1]^3
(hp_internal.hpp:29-30) while its gradient scatter honors the configured bbox
(dense_grid.cpp:201-213) - a forward/backward inconsistency we do not
replicate: here one bbox is honored on both sides by construction.

Nearest rounding matches C++ ``std::round`` (half away from zero) via
``floor(x + 0.5)``; jnp.round would round half to even.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from dvren_tpu.core.plan import InterpMode, OobPolicy


def _axis_local(p, lo: float, hi: float):
    """World coord -> [0,1] local along one axis + outside mask.

    bbox endpoints are static Python floats (field meta), so the degenerate
    extent branch resolves at trace time (grid_dense_cpu.cpp:99-105)."""
    extent = float(hi) - float(lo)
    if extent == 0.0:
        local = jnp.zeros_like(p)
    else:
        local = (p - lo) * (1.0 / extent)
    outside = (local < 0.0) | (local > 1.0)
    return local, outside


def eval_grid_planes(
    grid: jnp.ndarray,
    px: jnp.ndarray,
    py: jnp.ndarray,
    pz: jnp.ndarray,
    bbox_min,
    bbox_max,
    interp: InterpMode = InterpMode.LINEAR,
    oob: OobPolicy = OobPolicy.ZERO,
):
    """Evaluate a dense grid at SoA world coordinates.

    grid: (Z, Y, X) scalar or (Z, Y, X, C) vector field.
    px/py/pz: equal-shaped coordinate planes.
    Returns one array (scalar grid) or a tuple of C arrays, each the shape
    of the coordinate planes, float32.
    """
    scalar = grid.ndim == 3
    nz, ny, nx = grid.shape[0], grid.shape[1], grid.shape[2]

    lx, ox = _axis_local(px, bbox_min[0], bbox_max[0])
    ly, oy = _axis_local(py, bbox_min[1], bbox_max[1])
    lz, oz = _axis_local(pz, bbox_min[2], bbox_max[2])

    if oob == OobPolicy.CLAMP:
        lx = jnp.clip(lx, 0.0, 1.0)
        ly = jnp.clip(ly, 0.0, 1.0)
        lz = jnp.clip(lz, 0.0, 1.0)
        outside = None
    else:
        outside = ox | oy | oz

    fx = lx * (nx - 1)
    fy = ly * (ny - 1)
    fz = lz * (nz - 1)

    planes = [grid] if scalar else [grid[..., c] for c in range(grid.shape[3])]

    if interp == InterpMode.NEAREST:
        # round-half-away-from-zero for non-negative coords
        ix = jnp.clip(jnp.floor(fx + 0.5).astype(jnp.int32), 0, nx - 1)
        iy = jnp.clip(jnp.floor(fy + 0.5).astype(jnp.int32), 0, ny - 1)
        iz = jnp.clip(jnp.floor(fz + 0.5).astype(jnp.int32), 0, nz - 1)
        outs = [g[iz, iy, ix].astype(jnp.float32) for g in planes]
    else:
        ix0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx - 1)
        iy0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny - 1)
        iz0 = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, nz - 1)
        ix1 = jnp.minimum(ix0 + 1, nx - 1)
        iy1 = jnp.minimum(iy0 + 1, ny - 1)
        iz1 = jnp.minimum(iz0 + 1, nz - 1)
        tx = fx - ix0.astype(jnp.float32)
        ty = fy - iy0.astype(jnp.float32)
        tz = fz - iz0.astype(jnp.float32)

        outs = []
        for g in planes:
            c000 = g[iz0, iy0, ix0].astype(jnp.float32)
            c100 = g[iz0, iy0, ix1].astype(jnp.float32)
            c010 = g[iz0, iy1, ix0].astype(jnp.float32)
            c110 = g[iz0, iy1, ix1].astype(jnp.float32)
            c001 = g[iz1, iy0, ix0].astype(jnp.float32)
            c101 = g[iz1, iy0, ix1].astype(jnp.float32)
            c011 = g[iz1, iy1, ix0].astype(jnp.float32)
            c111 = g[iz1, iy1, ix1].astype(jnp.float32)

            # Same lerp chain as trilinear_sample (grid_dense_cpu.cpp:57-85).
            c00 = c000 + (c100 - c000) * tx
            c10 = c010 + (c110 - c010) * tx
            c01 = c001 + (c101 - c001) * tx
            c11 = c011 + (c111 - c011) * tx
            c0 = c00 + (c10 - c00) * ty
            c1 = c01 + (c11 - c01) * ty
            outs.append(c0 + (c1 - c0) * tz)

    if outside is not None:
        outs = [jnp.where(outside, 0.0, o) for o in outs]
    return outs[0] if scalar else tuple(outs)


def eval_grid(
    grid: jnp.ndarray,
    positions: jnp.ndarray,
    bbox_min,
    bbox_max,
    interp: InterpMode = InterpMode.LINEAR,
    oob: OobPolicy = OobPolicy.ZERO,
) -> jnp.ndarray:
    """(..., 3)-positions API over :func:`eval_grid_planes` (parity callers;
    hot paths pass coordinate planes directly)."""
    out = eval_grid_planes(
        grid, positions[..., 0], positions[..., 1], positions[..., 2],
        bbox_min, bbox_max, interp, oob)
    if isinstance(out, tuple):
        return jnp.stack(out, axis=-1)
    return out


def table_dtype(packed_dtype: str):
    """Map a field's ``packed_dtype`` string to the gather-table jnp dtype.

    "float32" (parity default), "bfloat16" and "float16" (hp_dtype F16
    parity, hotpath/include/hotpath/hp.h:44-50). Both 16-bit types halve
    the table bytes; f16 keeps ~3 decimal digits with a narrower exponent
    than bf16.
    """
    try:
        return {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
                "float16": jnp.float16}[packed_dtype]
    except KeyError:
        from dvren_tpu.core.status import DvrenError
        raise DvrenError.invalid_argument(
            f"unknown packed_dtype {packed_dtype!r}; expected float32, "
            "bfloat16 or float16") from None


def build_packed_stencil(sigma: jnp.ndarray, color: jnp.ndarray,
                         dtype=jnp.float32) -> jnp.ndarray:
    """Pack the (2,2,2)x(sigma,r,g,b) trilinear stencil per base voxel.

    Returns (Z-1, Y-1, X-1, 32): row [dz*4C + dy*2C + dx*C + ch] holds
    channel ch of corner (dz, dy, dx), C = 4 channels (sigma, r, g, b).

    One gather of 32 packed floats replaces the 8 corners x 4 channels =
    32 scalar gathers of the naive trilinear. Differentiable: the vjp of
    the shifted-slice concatenation scatters per-corner gradients back
    into the voxel grids exactly.

    ``dtype=bfloat16`` halves the table bytes at ~3 decimal digits of
    field precision; float32 is the parity default.
    """
    z, y, x = sigma.shape
    zm, ym, xm = z - 1, y - 1, x - 1
    parts = []
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                parts.append(sigma[dz:dz + zm, dy:dy + ym, dx:dx + xm])
                for ch in range(3):
                    parts.append(
                        color[dz:dz + zm, dy:dy + ym, dx:dx + xm, ch])
    # Stack on a leading axis + one transpose: bit-identical to the
    # minor-axis concat and much cheaper for XLA to compile.
    return jnp.moveaxis(jnp.stack(parts, axis=0), 0, -1).astype(dtype)


def _split_u16(table: jnp.ndarray) -> jnp.ndarray:
    """f32 (C, W) -> u16 (C, 2W): hi halves then lo halves, row-aligned."""
    bits = jax.lax.bitcast_convert_type(table, jnp.uint32)
    return jnp.concatenate([(bits >> 16).astype(jnp.uint16),
                            (bits & jnp.uint32(0xFFFF)).astype(jnp.uint16)],
                           axis=1)


def _u16_rows_to_f32(rows: jnp.ndarray, w: int) -> jnp.ndarray:
    hi = rows[:, :w].astype(jnp.uint32) << 16
    lo = rows[:, w:].astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(hi | lo, jnp.float32)


@jax.custom_vjp
def take_rows_exact(table: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact f32 row gather through a uint16 hi/lo split.

    Each f32 is split into hi/lo uint16 halves - laid out [all hi | all lo]
    per row so reconstruction is two contiguous slices, a shift and an or -
    and the rows are gathered at the 2-byte element type. Whether the split
    pays on the GPU against a plain f32 row gather is not yet measured
    (ROADMAP S3). The backward is the standard scatter-add of the row cotangent,
    declared via custom_vjp because integer bit-plumbing has no autodiff
    path. Out-of-range indices CLAMP to the edge row, forward and
    backward consistently (callers pre-clip; this pins the contract).
    """
    return _u16_rows_to_f32(
        jnp.take(_split_u16(table), idx, axis=0, mode="clip"),
        table.shape[1])


def _take_rows_exact_fwd(table, idx):
    return take_rows_exact(table, idx), (idx, table.shape)


def _take_rows_exact_bwd(res, ct):
    idx, table_shape = res
    # mode="clip" matches the forward's jnp.take clamping: an out-of-range
    # index reads the edge row, so its cotangent must land there too.
    d_table = jnp.zeros(table_shape, ct.dtype).at[idx].add(ct, mode="clip")
    return d_table, None


take_rows_exact.defvjp(_take_rows_exact_fwd, _take_rows_exact_bwd)


def eval_packed_trilinear(
    packed: jnp.ndarray,
    grid_shape_zyx: tuple[int, int, int],
    px: jnp.ndarray,
    py: jnp.ndarray,
    pz: jnp.ndarray,
    bbox_min,
    bbox_max,
    oob: OobPolicy = OobPolicy.ZERO,
):
    """Trilinear (sigma, r, g, b) via one packed-stencil gather per sample.

    Value-identical to :func:`eval_grid_planes` with LINEAR interpolation
    (the upper-edge case fx == n-1 lands on base n-2 with t == 1, selecting
    the same corner value). Requires every grid dim >= 2.
    Returns four planes shaped like the coordinate inputs.
    """
    nz, ny, nx = grid_shape_zyx
    shape = px.shape
    lx, ox = _axis_local(px, bbox_min[0], bbox_max[0])
    ly, oy = _axis_local(py, bbox_min[1], bbox_max[1])
    lz, oz = _axis_local(pz, bbox_min[2], bbox_max[2])
    if oob == OobPolicy.CLAMP:
        lx = jnp.clip(lx, 0.0, 1.0)
        ly = jnp.clip(ly, 0.0, 1.0)
        lz = jnp.clip(lz, 0.0, 1.0)
        outside = None
    else:
        outside = (ox | oy | oz).reshape(-1)

    fx = lx.reshape(-1) * (nx - 1)
    fy = ly.reshape(-1) * (ny - 1)
    fz = lz.reshape(-1) * (nz - 1)
    ix = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, nx - 2)
    iy = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, ny - 2)
    iz = jnp.clip(jnp.floor(fz).astype(jnp.int32), 0, nz - 2)
    tx = fx - ix.astype(jnp.float32)
    ty = fy - iy.astype(jnp.float32)
    tz = fz - iz.astype(jnp.float32)

    flat = packed.reshape(-1, packed.shape[-1])
    v = (iz * (ny - 1) + iy) * (nx - 1) + ix
    if flat.dtype == jnp.float32:
        cube = take_rows_exact(flat, v)                     # (S, 32) @ 2B rate
    else:
        cube = jnp.take(flat, v, axis=0).astype(jnp.float32)  # (S, 32)

    wx0, wx1 = 1.0 - tx, tx
    wy0, wy1 = 1.0 - ty, ty
    wz0, wz1 = 1.0 - tz, tz
    w = jnp.stack([
        wz0 * wy0 * wx0, wz0 * wy0 * wx1, wz0 * wy1 * wx0, wz0 * wy1 * wx1,
        wz1 * wy0 * wx0, wz1 * wy0 * wx1, wz1 * wy1 * wx0, wz1 * wy1 * wx1,
    ], axis=-1)                                      # (S, 8)
    if outside is not None:
        w = w * (~outside)[:, None]

    s = cube.shape[0]
    # channel-major output (4, S). HIGHEST: a float32 contraction may
    # otherwise run in TF32 on the GPU (~3 decimal digits).
    outs = jnp.einsum("sc,sck->ks", w, cube.reshape(s, 8, 4),
                      precision=jax.lax.Precision.HIGHEST)
    return tuple(outs[c].reshape(shape) for c in range(4))


def scatter_grid_grads(
    grid_shape: tuple[int, ...],
    positions: jnp.ndarray,
    sample_grads: jnp.ndarray,
    bbox_min,
    bbox_max,
    interp: InterpMode = InterpMode.LINEAR,
    oob: OobPolicy = OobPolicy.ZERO,
) -> jnp.ndarray:
    """Scatter per-sample gradients back into a voxel grid.

    The analogue of ``DenseGridField::AccumulateSampleGradients``
    (dense_grid.cpp:171-309), derived as the exact vjp of :func:`eval_grid`
    so forward and backward interpolation weights always agree. XLA
    scatter-add uses atomics on the GPU, so unlike the reference's ordered
    CPU accumulation the sums may differ in the last bits between runs.
    """
    zeros = jnp.zeros(grid_shape, jnp.float32)

    def f(grid):
        return eval_grid(grid, positions, bbox_min, bbox_max, interp, oob)

    _, vjp = jax.vjp(f, zeros)
    (grads,) = vjp(sample_grads.astype(jnp.float32))
    return grads
