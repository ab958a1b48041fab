"""Instant-NGP-style multiresolution hash encoding + tiny MLP heads.

Vectorized replacement for ``hotpath/src/cpu/hash_mlp_cpu.cpp:9-281`` (and
the never-wired CUDA twin ``hash_mlp_cuda.cu``): batched over samples so the
two MLP layers run as real matmuls instead of per-sample scalar
loops. Fully differentiable - the reference is forward-only (SURVEY.md #10),
so hash-MLP training is a new capability.

Parity notes:
- hash: ``(x*1 ^ y*2654435761 ^ z*805459861) mod table_size`` on uint32 with
  wrapping (hash_mlp_cpu.cpp:9-18);
- per-level resolution ``base * exp(l * ln(finest/base)/(L-1))`` (:31-34);
- feature layout ``[level][entry][feature]`` per level block (:59-78);
- sigma head: 2-layer ReLU MLP, ReLU output; color head: 2-layer ReLU MLP,
  clamp to [0,1] (:95-148);
- flat parameter blob layout (:165-196):
  hash_table | sigma_w1,(hidden x enc) row-major + sigma_w2 (hidden,)
             | sigma_b1 (hidden,) + sigma_b2 (1,)
             | color_w1 (hidden x enc) + color_w2 (3 x hidden)
             | color_b1 (hidden,) + color_b2 (3,)
  Default hyperparameters L=4, F=2, T=16, hidden=8, base=2, finest=16 match
  the reference's hardcoded values; here they are configurable.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

_HI = jax.lax.Precision.HIGHEST

_PRIME_Y = 2654435761
_PRIME_Z = 805459861


@dataclass(frozen=True)
class HashMLPSpec:
    """Static hyperparameters (hash_mlp_cpu.cpp:170-177 defaults)."""

    n_levels: int = 4
    features_per_level: int = 2
    table_size: int = 16
    hidden_dim: int = 8
    base_resolution: float = 2.0
    finest_resolution: float = 16.0
    # Optional EXPLICIT per-level resolutions (tuple of floats, length
    # n_levels). None keeps the reference's geometric formula
    # base*exp(l*ln(finest/base)/(L-1)) (hash_mlp_cpu.cpp:31-34) -
    # whose f32 exp() lands 1-2 ulp off integers (e.g. 7.9999995 for a
    # 4..32 ladder). Integer power-of-two ladders (4, 8, 16, 32) make
    # the per-level cell arithmetic exact.
    resolutions: tuple | None = None

    @property
    def encoding_dim(self) -> int:
        return self.n_levels * self.features_per_level

    @property
    def hash_table_size(self) -> int:
        return self.n_levels * self.table_size * self.features_per_level

    @property
    def sigma_weights_size(self) -> int:
        return self.hidden_dim * self.encoding_dim + self.hidden_dim

    @property
    def sigma_biases_size(self) -> int:
        return self.hidden_dim + 1

    @property
    def color_weights_size(self) -> int:
        return self.hidden_dim * self.encoding_dim + 3 * self.hidden_dim

    @property
    def color_biases_size(self) -> int:
        return self.hidden_dim + 3

    @property
    def param_count(self) -> int:
        return (self.hash_table_size + self.sigma_weights_size
                + self.sigma_biases_size + self.color_weights_size
                + self.color_biases_size)


def hash_coords(ix, iy, iz, table_size: int):
    """3-prime XOR hash on wrapping uint32 (hash_mlp_cpu.cpp:9-18)."""
    h = (ix.astype(jnp.uint32)
         ^ (iy.astype(jnp.uint32) * jnp.uint32(_PRIME_Y))
         ^ (iz.astype(jnp.uint32) * jnp.uint32(_PRIME_Z)))
    return (h % jnp.uint32(table_size)).astype(jnp.int32)


def encode(positions: jnp.ndarray, hash_table: jnp.ndarray,
           spec: HashMLPSpec) -> jnp.ndarray:
    """Multiresolution hash encoding.

    positions: (..., 3); hash_table: (L, T, F) float32.
    Returns (..., L*F) with layout [level*F + feature].
    """
    levels = spec.n_levels
    if levels > 1:
        log_scale = (jnp.log(spec.finest_resolution / spec.base_resolution)
                     / (levels - 1))
    else:
        log_scale = jnp.log(spec.finest_resolution / spec.base_resolution)

    feats = []
    for level in range(levels):
        res = (jnp.float32(spec.resolutions[level])
               if spec.resolutions is not None
               else spec.base_resolution * jnp.exp(level * log_scale))
        scaled = positions * res
        i0 = jnp.floor(scaled).astype(jnp.int32)
        frac = scaled - i0.astype(jnp.float32)
        x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
        x1, y1, z1 = x0 + 1, y0 + 1, z0 + 1
        fx = frac[..., 0:1]
        fy = frac[..., 1:2]
        fz = frac[..., 2:3]

        table = hash_table[level]  # (T, F)

        def corner(xc, yc, zc):
            return table[hash_coords(xc, yc, zc, spec.table_size)]  # (..., F)

        v000 = corner(x0, y0, z0)
        v001 = corner(x0, y0, z1)
        v010 = corner(x0, y1, z0)
        v011 = corner(x0, y1, z1)
        v100 = corner(x1, y0, z0)
        v101 = corner(x1, y0, z1)
        v110 = corner(x1, y1, z0)
        v111 = corner(x1, y1, z1)

        v00 = v000 * (1.0 - fx) + v100 * fx
        v01 = v001 * (1.0 - fx) + v101 * fx
        v10 = v010 * (1.0 - fx) + v110 * fx
        v11 = v011 * (1.0 - fx) + v111 * fx
        v0 = v00 * (1.0 - fy) + v10 * fy
        v1 = v01 * (1.0 - fy) + v11 * fy
        feats.append(v0 * (1.0 - fz) + v1 * fz)

    return jnp.concatenate(feats, axis=-1)


def unpack_params(flat: jnp.ndarray, spec: HashMLPSpec) -> dict:
    """Split the reference's flat float32 blob (hash_mlp_cpu.cpp:179-193)."""
    enc = spec.encoding_dim
    hid = spec.hidden_dim
    o = 0

    def take(n):
        nonlocal o
        chunk = flat[o:o + n]
        o += n
        return chunk

    table = take(spec.hash_table_size).reshape(
        spec.n_levels, spec.table_size, spec.features_per_level)
    sw = take(spec.sigma_weights_size)
    sigma_w1 = sw[: hid * enc].reshape(hid, enc)
    sigma_w2 = sw[hid * enc:]
    sb = take(spec.sigma_biases_size)
    sigma_b1, sigma_b2 = sb[:hid], sb[hid]
    cw = take(spec.color_weights_size)
    color_w1 = cw[: hid * enc].reshape(hid, enc)
    color_w2 = cw[hid * enc:].reshape(3, hid)
    cb = take(spec.color_biases_size)
    color_b1, color_b2 = cb[:hid], cb[hid:]

    return dict(
        hash_table=table,
        sigma_w1=sigma_w1, sigma_w2=sigma_w2,
        sigma_b1=sigma_b1, sigma_b2=sigma_b2,
        color_w1=color_w1, color_w2=color_w2,
        color_b1=color_b1, color_b2=color_b2,
    )


def pack_params(params: dict, spec: HashMLPSpec) -> jnp.ndarray:
    """Inverse of :func:`unpack_params` (reference blob layout)."""
    return jnp.concatenate([
        params["hash_table"].reshape(-1),
        params["sigma_w1"].reshape(-1), params["sigma_w2"].reshape(-1),
        params["sigma_b1"].reshape(-1),
        jnp.atleast_1d(params["sigma_b2"]).reshape(-1),
        params["color_w1"].reshape(-1), params["color_w2"].reshape(-1),
        params["color_b1"].reshape(-1), params["color_b2"].reshape(-1),
    ]).astype(jnp.float32)


def eval_planes(px, py, pz, params: dict, spec: HashMLPSpec):
    """(sigma, r, g, b) planes - the hot path for hash-MLP fields.

    Value-identical to :func:`eval_sigma` + :func:`eval_color` but laid out
    feature-axis-leading (no minor dim of 2 or 3), the hash-table
    lookup is a weighted one-hot contraction (exact by linearity, and the
    tables are tiny - T entries - so the contraction is trivial), and the encoding is computed once for both heads (the reference
    encodes twice, hash_mlp_cpu.cpp:227/274).
    """
    shape = px.shape
    pxf = px.reshape(-1)
    pyf = py.reshape(-1)
    pzf = pz.reshape(-1)
    s = pxf.shape[0]
    levels = spec.n_levels
    t_size = spec.table_size
    if levels > 1:
        log_scale = (jnp.log(spec.finest_resolution / spec.base_resolution)
                     / (levels - 1))
    else:
        log_scale = jnp.log(spec.finest_resolution / spec.base_resolution)

    iota_t = jax.lax.broadcasted_iota(jnp.int32, (1, t_size), 1)
    enc_rows = []
    for level in range(levels):
        res = (jnp.float32(spec.resolutions[level])
               if spec.resolutions is not None
               else spec.base_resolution * jnp.exp(level * log_scale))
        sx, sy, sz = pxf * res, pyf * res, pzf * res
        x0 = jnp.floor(sx).astype(jnp.int32)
        y0 = jnp.floor(sy).astype(jnp.int32)
        z0 = jnp.floor(sz).astype(jnp.int32)
        fx = sx - x0.astype(jnp.float32)
        fy = sy - y0.astype(jnp.float32)
        fz = sz - z0.astype(jnp.float32)

        w_acc = jnp.zeros((s, t_size), jnp.float32)
        for dz in (0, 1):
            wz = fz if dz else 1.0 - fz
            for dy in (0, 1):
                wy = fy if dy else 1.0 - fy
                for dx in (0, 1):
                    wx = fx if dx else 1.0 - fx
                    idx = hash_coords(x0 + dx, y0 + dy, z0 + dz, t_size)
                    onehot = (idx[:, None] == iota_t).astype(jnp.float32)
                    w_acc = w_acc + onehot * (wx * wy * wz)[:, None]
        # (S, T) @ (T, F) -> features-leading (F, S)
        enc_rows.append(jnp.einsum(
            "st,tf->fs", w_acc, params["hash_table"][level],
            precision=_HI))
    enc = jnp.concatenate(enc_rows, axis=0)       # (L*F, S)

    def head(w1, b1):
        return jnp.maximum(
            jnp.einsum("hf,fs->hs", w1, enc, precision=_HI)
            + b1[:, None], 0.0)

    hidden_s = head(params["sigma_w1"], params["sigma_b1"])
    sigma = jnp.maximum(
        jnp.einsum("h,hs->s", params["sigma_w2"], hidden_s, precision=_HI)
        + params["sigma_b2"], 0.0)

    hidden_c = head(params["color_w1"], params["color_b1"])
    rgb = jnp.clip(
        jnp.einsum("ch,hs->cs", params["color_w2"], hidden_c, precision=_HI)
        + params["color_b2"][:, None], 0.0, 1.0)

    return (sigma.reshape(shape), rgb[0].reshape(shape),
            rgb[1].reshape(shape), rgb[2].reshape(shape))


def eval_sigma(positions, params: dict, spec: HashMLPSpec):
    """Sigma head (hash_mlp_cpp:95-119): ReLU MLP, non-negative output.

    float32 parity needs full-precision dots (a default float32 dot may run
    in TF32 on the GPU); these matrices are tiny, so HIGHEST costs nothing.
    """
    enc = encode(positions, params["hash_table"], spec)
    hidden = jnp.maximum(
        jnp.matmul(enc, params["sigma_w1"].T, precision=_HI)
        + params["sigma_b1"], 0.0)
    out = jnp.matmul(hidden, params["sigma_w2"], precision=_HI) \
        + params["sigma_b2"]
    return jnp.maximum(out, 0.0)


def eval_color(positions, params: dict, spec: HashMLPSpec):
    """Color head (hash_mlp_cpu.cpp:121-148): ReLU MLP, clamp to [0,1]."""
    enc = encode(positions, params["hash_table"], spec)
    hidden = jnp.maximum(
        jnp.matmul(enc, params["color_w1"].T, precision=_HI)
        + params["color_b1"], 0.0)
    out = jnp.matmul(hidden, params["color_w2"].T, precision=_HI) \
        + params["color_b2"]
    return jnp.clip(out, 0.0, 1.0)
