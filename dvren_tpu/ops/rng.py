"""Counter-based deterministic RNG: splitmix64 emulated on uint32 pairs.

The reference derives its stratified sampling jitter from a splitmix64-style
mix of ``(seed, ray_index, step)`` (``hotpath/src/cpu/samp_cpu.cpp:21-35``).
Reproducing it bit-exactly gives cross-implementation golden parity for the
stratified determinism tests (``hp_runner.cpp:1033-1038``).

JAX runs without 64-bit types by default, so 64-bit state is carried as
``(hi, lo)`` uint32 pairs with explicit carry propagation. All ops are vectorized and wrap
modulo 2^32 (XLA unsigned arithmetic is defined to wrap).
"""

from __future__ import annotations

import jax.numpy as jnp

_M1_HI = jnp.uint32(0xBF58476D)
_M1_LO = jnp.uint32(0x1CE4E5B9)
_M2_HI = jnp.uint32(0x94D049BB)
_M2_LO = jnp.uint32(0x133111EB)


def _shr64(hi, lo, k: int):
    """Logical right shift of (hi, lo) by static k in (0, 64)."""
    if k < 32:
        new_hi = hi >> k
        new_lo = (lo >> k) | (hi << (32 - k))
    else:
        new_hi = jnp.zeros_like(hi)
        new_lo = hi >> (k - 32)
    return new_hi, new_lo


def _mul32_wide(a, b):
    """Full 32x32 -> 64 multiply via 16-bit limbs. Returns (hi, lo) uint32."""
    a0 = a & jnp.uint32(0xFFFF)
    a1 = a >> 16
    b0 = b & jnp.uint32(0xFFFF)
    b1 = b >> 16

    p00 = a0 * b0            # <= (2^16-1)^2 < 2^32, exact
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1

    mid = p01 + p10
    mid_carry = (mid < p01).astype(jnp.uint32)  # wrapped -> carry into bit 32

    lo = p00 + (mid << 16)
    lo_carry = (lo < p00).astype(jnp.uint32)

    hi = p11 + (mid >> 16) + (mid_carry << 16) + lo_carry
    return hi, lo


def _mul64(ahi, alo, bhi, blo):
    """(a * b) mod 2^64 on uint32 pairs."""
    hi, lo = _mul32_wide(alo, blo)
    hi = hi + alo * bhi + ahi * blo
    return hi, lo


def mix_seed(hi, lo):
    """splitmix64 finalizer, bit-exact with samp_cpu.cpp:21-26.

    state ^= state >> 30; state *= 0xbf58476d1ce4e5b9;
    state ^= state >> 27; state *= 0x94d049bb133111eb;
    state ^= state >> 31.
    """
    s_hi, s_lo = _shr64(hi, lo, 30)
    hi, lo = hi ^ s_hi, lo ^ s_lo
    hi, lo = _mul64(hi, lo, _M1_HI, _M1_LO)
    s_hi, s_lo = _shr64(hi, lo, 27)
    hi, lo = hi ^ s_hi, lo ^ s_lo
    hi, lo = _mul64(hi, lo, _M2_HI, _M2_LO)
    s_hi, s_lo = _shr64(hi, lo, 31)
    return hi ^ s_hi, lo ^ s_lo


def stratified_jitter(seed: int, ray_index, step):
    """Jitter in [0, 1) for (seed, ray, step); samp_cpu.cpp:28-35.

    seed64 = base ^ (ray_index << 32) ^ step; j = mix(seed64) low 52 bits / 2^52.

    ``ray_index`` and ``step`` are broadcastable integer arrays; the reference
    uses ``size_t ray_index`` and ``uint32 step``, both of which fit uint32
    for any realistic plan.

    The final division is performed in float32 as
    ``bits[51:32] * 2^-20 + bits[31:0] * 2^-52``; versus the reference's
    float(double) path this differs by at most one float32 ulp.
    """
    base = int(seed) & 0xFFFFFFFFFFFFFFFF
    base_hi = jnp.uint32((base >> 32) & 0xFFFFFFFF)
    base_lo = jnp.uint32(base & 0xFFFFFFFF)

    ray_u32 = ray_index.astype(jnp.uint32)
    step_u32 = step.astype(jnp.uint32)

    hi = base_hi ^ ray_u32        # ray_index << 32 lands in the high word
    lo = base_lo ^ step_u32
    hi, lo = mix_seed(hi, lo)

    hi20 = (hi & jnp.uint32(0x000FFFFF)).astype(jnp.float32)
    lo32 = lo.astype(jnp.float32)
    return hi20 * jnp.float32(2.0 ** -20) + lo32 * jnp.float32(2.0 ** -52)


def jitter_table(seed: int, n_rays: int, n_steps: int,
                 ray_offset: int = 0):
    """Host-side (numpy uint64) jitter table: exact splitmix64, (N, K) f32.

    The stratified jitter is a pure function of (seed, ray, step) - constant
    for a given plan - so the production path precomputes it once and ships
    it to the device as a resident input. This is both bit-exact with the
    reference (true uint64, no limb emulation) and keeps the compiled
    program free of the uint32 emulation. The march kernel reads the same
    table, so its jitter is bit-identical to the plain path's.
    """
    import numpy as np

    rays = (np.arange(n_rays, dtype=np.uint64)
            + np.uint64(ray_offset))[:, None]
    steps = np.arange(n_steps, dtype=np.uint64)[None, :]
    s = np.uint64(seed & 0xFFFFFFFFFFFFFFFF) ^ (rays << np.uint64(32)) ^ steps
    with np.errstate(over="ignore"):
        s = (s ^ (s >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        s = (s ^ (s >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        s = s ^ (s >> np.uint64(31))
    frac = (s & np.uint64(0x000FFFFFFFFFFFFF)).astype(np.float64)
    return (frac / float(0x0010000000000000)).astype(np.float32)


def mix_seed_py(state: int) -> int:
    """Pure-Python splitmix64 finalizer (test oracle)."""
    mask = 0xFFFFFFFFFFFFFFFF
    state &= mask
    state = ((state ^ (state >> 30)) * 0xBF58476D1CE4E5B9) & mask
    state = ((state ^ (state >> 27)) * 0x94D049BB133111EB) & mask
    state = state ^ (state >> 31)
    return state


def stratified_jitter_py(seed: int, ray_index: int, step: int) -> float:
    """Pure-Python jitter oracle, matching samp_cpu.cpp:28-35 in float64."""
    mask = 0xFFFFFFFFFFFFFFFF
    s = seed & mask
    s ^= (ray_index << 32) & mask
    s ^= step & mask
    s = mix_seed_py(s)
    return float((s & 0x000FFFFFFFFFFFFF) / float(0x0010000000000000))
