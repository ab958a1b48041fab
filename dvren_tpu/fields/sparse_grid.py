"""Sparse brick-grid field: NanoVDB-style two-level indirection.

The reference only ever scaffolded VDB support (CMake fetch rules that no
target references - SURVEY.md section 0); this implements the capability
for the BASELINE.json large-field configs (256^3-512^3). It renders through
the plain ``render`` path:

- base cells (the (Z-1, Y-1, X-1) trilinear stencil lattice) are grouped
  into 8^3-cell *bricks*;
- a dense int32 occupancy table maps brick coords -> brick slot (slot 0 is
  the shared all-zero brick, so empty space needs no storage);
- each occupied brick stores the packed 32-float trilinear stencil rows of
  its cells (see ops/grid.py::build_packed_stencil) - the apron problem of
  VDB (stencils crossing brick borders) is absorbed at build time because
  each row already contains its full 8-corner stencil;
- evaluation costs two gathers per sample (occupancy lookup + brick row)
  versus the dense packed path's one.

Memory: O(occupied bricks) * 64 KB (f32) / 32 KB (bf16). A 512^3 volume at
10% occupancy fits in ~1.7 GB where the dense packed table needs 16 GB.

Construction streams over z-slabs of the dense source so the full packed
table is never materialized.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from dvren_tpu.core.plan import OobPolicy
from dvren_tpu.core.status import check
from dvren_tpu.ops import grid as grid_ops
from dvren_tpu.ops.grid import _axis_local
from dvren_tpu.utils.pytree import pytree_dataclass

BRICK = 8
_CHANNELS = 32  # channel-major: col = ch * 8 + corner (dz*4 + dy*2 + dx),
#                 ch in (sigma, r, g, b)
_SIGMA_CH = tuple(range(8))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@pytree_dataclass(meta_fields=("grid_shape", "bbox_min", "bbox_max", "oob"))
@dataclass(frozen=True)
class SparseGridField:
    """bricks: (n_bricks, BRICK^3, 32); occupancy: (Bz, By, Bx) int32.

    ``grid_shape`` is the dense source shape (Z, Y, X); slot 0 of ``bricks``
    is the reserved zero brick.
    """

    bricks: jnp.ndarray
    occupancy: jnp.ndarray
    grid_shape: tuple[int, int, int]
    bbox_min: tuple[float, float, float] = (0.0, 0.0, 0.0)
    bbox_max: tuple[float, float, float] = (1.0, 1.0, 1.0)
    oob: OobPolicy = OobPolicy.ZERO

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_dense(field, threshold: float = 0.0,
                   dtype="float32") -> "SparseGridField":
        """Build from a DenseGridField (LINEAR interp), streaming z-slabs.

        A brick is kept iff any sigma stencil value in it exceeds
        ``threshold``. With threshold 0 the render is exactly the dense
        packed render (dropped bricks have identically zero density, so
        their color cannot contribute)."""
        check(field.interp.name == "LINEAR",
              "sparse bricks require trilinear interpolation")
        sigma = np.asarray(field.sigma)
        color = np.asarray(field.color)
        nz, ny, nx = sigma.shape
        check(min(nx, ny, nz) >= 2, "sparse bricks require dims >= 2")
        zm, ym, xm = nz - 1, ny - 1, nx - 1
        bz, by, bx = _cdiv(zm, BRICK), _cdiv(ym, BRICK), _cdiv(xm, BRICK)

        occupancy = np.zeros((bz, by, bx), np.int32)
        brick_rows: list[np.ndarray] = [
            np.zeros((BRICK ** 3, _CHANNELS), np.float32)]  # slot 0: zeros

        pad_z, pad_y, pad_x = bz * BRICK, by * BRICK, bx * BRICK
        for bz_i in range(bz):
            z0 = bz_i * BRICK
            z_hi = min(z0 + BRICK, zm)
            # source voxels needed for stencils of base cells [z0, z_hi)
            slab_sigma = sigma[z0:z_hi + 1]
            slab_color = color[z0:z_hi + 1]
            zc = z_hi - z0
            # packed stencil for this slab of base cells, channel-major
            # (col = ch * 8 + corner)
            parts = [[], [], [], []]
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        parts[0].append(
                            slab_sigma[dz:dz + zc, dy:dy + ym,
                                       dx:dx + xm, None])
                        for ch in range(3):
                            parts[ch + 1].append(
                                slab_color[dz:dz + zc, dy:dy + ym,
                                           dx:dx + xm, ch:ch + 1])
            packed = np.concatenate(
                parts[0] + parts[1] + parts[2] + parts[3],
                axis=-1)                                  # (zc, ym, xm, 32)
            packed = np.pad(
                packed,
                ((0, BRICK - zc), (0, pad_y - ym), (0, pad_x - xm), (0, 0)))
            # (BRICK, by, BRICK, bx, BRICK, 32) -> (by, bx, brick-local...)
            tiles = packed.reshape(BRICK, by, BRICK, bx, BRICK, _CHANNELS)
            tiles = tiles.transpose(1, 3, 0, 2, 4, 5).reshape(
                by, bx, BRICK ** 3, _CHANNELS)
            sig_max = np.abs(tiles[..., list(_SIGMA_CH)]).max(axis=(2, 3))
            occ_y, occ_x = np.nonzero(sig_max > threshold)
            for j, (by_i, bx_i) in enumerate(zip(occ_y, occ_x)):
                occupancy[bz_i, by_i, bx_i] = len(brick_rows) + j
            if occ_y.size:
                brick_rows.extend(
                    tiles[occ_y, occ_x].astype(np.float32))

        from dvren_tpu.ops.grid import table_dtype as _table_dtype
        table_dtype = _table_dtype(str(dtype))
        bricks = np.stack(brick_rows)
        return SparseGridField(
            bricks=jnp.asarray(bricks).astype(table_dtype),
            occupancy=jnp.asarray(occupancy),
            grid_shape=(nz, ny, nx),
            bbox_min=field.bbox_min,
            bbox_max=field.bbox_max,
            oob=field.oob,
        )

    def with_params(self, bricks: jnp.ndarray) -> "SparseGridField":
        """Same topology (occupancy, shape, bbox), new brick table: the
        brick table IS the parameter set, topology is static."""
        return SparseGridField(
            bricks=bricks, occupancy=self.occupancy,
            grid_shape=self.grid_shape, bbox_min=self.bbox_min,
            bbox_max=self.bbox_max, oob=self.oob)

    # -- stats ----------------------------------------------------------------

    @property
    def occupied_bricks(self) -> int:
        return int(self.bricks.shape[0]) - 1

    @property
    def total_bricks(self) -> int:
        return int(np.prod(self.occupancy.shape))

    def memory_bytes(self) -> int:
        return int(self.bricks.size * self.bricks.dtype.itemsize
                   + self.occupancy.size * 4)

    # -- evaluation (packed protocol used by the render pipeline) -------------

    @property
    def supports_packed_eval(self) -> bool:
        return True

    def packed_eval_planes(self, px, py, pz):
        """(sigma, r, g, b) planes via occupancy lookup + brick-row gather."""
        nz, ny, nx = self.grid_shape
        shape = px.shape
        lx, ox = _axis_local(px, self.bbox_min[0], self.bbox_max[0])
        ly, oy = _axis_local(py, self.bbox_min[1], self.bbox_max[1])
        lz, oz = _axis_local(pz, self.bbox_min[2], self.bbox_max[2])
        if self.oob == OobPolicy.CLAMP:
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

        # two-level indirection
        occ_flat = self.occupancy.reshape(-1)
        _, by, bx = self.occupancy.shape
        b_idx = ((iz // BRICK) * by + (iy // BRICK)) * bx + (ix // BRICK)
        slot = jnp.take(occ_flat, b_idx)
        local = ((iz % BRICK) * BRICK + (iy % BRICK)) * BRICK + (ix % BRICK)
        row_idx = slot * (BRICK ** 3) + local
        flat = self.bricks.reshape(-1, _CHANNELS)
        if flat.dtype == jnp.float32:
            cube = grid_ops.take_rows_exact(flat, row_idx)
        else:
            cube = jnp.take(flat, row_idx, axis=0).astype(jnp.float32)

        wx0, wx1 = 1.0 - tx, tx
        wy0, wy1 = 1.0 - ty, ty
        wz0, wz1 = 1.0 - tz, tz
        w = jnp.stack([
            wz0 * wy0 * wx0, wz0 * wy0 * wx1, wz0 * wy1 * wx0,
            wz0 * wy1 * wx1, wz1 * wy0 * wx0, wz1 * wy0 * wx1,
            wz1 * wy1 * wx0, wz1 * wy1 * wx1,
        ], axis=-1)
        if outside is not None:
            w = w * (~outside)[:, None]

        s = cube.shape[0]
        outs = jnp.einsum("sc,skc->ks", w, cube.reshape(s, 4, 8),
                          precision=jax.lax.Precision.HIGHEST)
        return tuple(outs[c].reshape(shape) for c in range(4))

    # parity protocol used by tests / generic callers
    def sigma_at_planes(self, px, py, pz):
        return self.packed_eval_planes(px, py, pz)[0]

    def color_at_planes(self, px, py, pz):
        return self.packed_eval_planes(px, py, pz)[1:]
