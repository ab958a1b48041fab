"""Emission-absorption transmittance integration over the dense lattice.

Vectorized replacement for the reference's sequential per-ray loop
(``hotpath/src/cpu/int_cpu.cpp:98-229``). The key redesign: the recurrence

    alpha_k = 1 - exp(-sigma_k * dt_k)          (expm1, Taylor below 1e-4)
    T_{k+1} = T_k * (1 - alpha_k)
    break when T <= 1e-4                        (early termination)

is reformulated as a *parallel cumulative product*. Because T is
monotonically non-increasing along a ray, "the loop broke before step k" is
exactly "P_{k-1} <= 1e-4" where ``P_k = prod_{j<=k}(1 - alpha_j)``; the
early-termination prefix therefore needs no sequential scan:

    processed_k = mask_k AND (P_{k-1} > 1e-4)
    weight_k    = P_{k-1} * alpha_k * processed_k
    T_final     = min_k( processed_k ? P_k : 1 )

This runs at O(log K) depth on the VPU instead of O(K) sequential steps, and
the whole function is differentiable, so ``jax.vjp`` reproduces the
reference's hand-written adjoint recurrence (``diff_cpu.cpp:156-195``) -
including its convention that gradients do not flow through the termination
test (a boolean in both formulations).

Numerical contract preserved (DESIGN_SPECIFICATION.md:87-94):
- alpha via expm1 with 2nd-order Taylor below optical depth 1e-4 and clamp to
  [0,1] (int_cpu.cpp:98-109);
- per-sample aux = (alpha, weight, T_before, logT_before) persisted for the
  backward / parity tests (int_cpu.cpp:201-207), zeroed for unprocessed slots
  exactly as the reference leaves them zero-initialized;
- depth = weighted mid-segment distance / opacity, else t_far; the segment
  cursor starts at the *plan* t_near (int_cpu.cpp:170,198-199,224).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp

from dvren_tpu.utils.pytree import pytree_dataclass

STOP_THRESHOLD = 1e-4   # int_cpu.cpp:171
OPACITY_EPS = 1e-6      # int_cpu.cpp:224
LOG_T_FLOOR = 1e-30     # int_cpu.cpp:190


@pytree_dataclass
@dataclass(frozen=True)
class Integration:
    """Per-ray integration outputs; mirrors ``hp_intl_t`` (hp.h:140-146).

    radiance: (N, 3); transmittance/opacity/depth: (N,);
    aux: (N, K, 4) = (alpha, weight, T_before, logT_before) per sample.
    """

    radiance: jnp.ndarray
    transmittance: jnp.ndarray
    opacity: jnp.ndarray
    depth: jnp.ndarray
    aux: jnp.ndarray


def compute_alpha(sigma, dt):
    """alpha(sigma, dt); bit-faithful to int_cpu.cpp:98-109 in float32."""
    od = sigma * dt
    taylor = od * (1.0 - 0.5 * od)
    # Guard expm1 against huge optical depths producing inf intermediates.
    full = jnp.clip(-jnp.expm1(-jnp.minimum(od, 88.0)), 0.0, 1.0)
    alpha = jnp.where(od < 1e-4, taylor, full)
    return jnp.where(od <= 0.0, 0.0, alpha)


def _color_planes(color):
    """Accept color as (N, K, 3) or as a tuple of three (N, K) planes.

    The SoA tuple is the hot-path form (no minor dimension of 3).
    """
    if isinstance(color, (tuple, list)):
        return color[0], color[1], color[2]
    return color[..., 0], color[..., 1], color[..., 2]


def integrate(
    sigma: jnp.ndarray,
    color,
    dt: jnp.ndarray,
    mask: jnp.ndarray,
    t_near: float,
    t_far: float,
    stop_threshold: float = STOP_THRESHOLD,
    with_aux: bool = True,
    t_cursor_origin=None,
) -> Integration:
    """Integrate radiance along each ray of the dense lattice.

    sigma: (N, K); color: (N, K, 3) or a tuple of three (N, K) planes;
    dt: (N, K) with 0 in masked slots; mask: (N, K) bool prefix mask.
    t_near/t_far are the plan scalars.
    ``with_aux=False`` skips materializing the (N, K, 4) aux tensor (the
    production path; aux exists for reference parity and inspection only -
    backward recomputes everything it needs).

    ``t_cursor_origin``: where the depth segment cursor starts (scalar or
    per-ray (N,)). Defaults to t_near (int_cpu.cpp:170). The window-clipped
    path passes ``t_near + k_enter * dt``: every skipped leading lattice
    step has the full dt (truncation only happens at t_far), so the cursor
    advances exactly as if those zero-contribution steps were processed.
    """
    maskf = mask.astype(sigma.dtype)

    # P_k = prod_{j<=k}(1 - alpha_j) = exp(-sum_{j<=k} od_j): a parallel
    # prefix sum in log space. Identical to the reference's running product
    # ((1 - alpha) == exp(-od) exactly, including the Taylor branch to
    # O(od^3) and saturation to 0) and strictly more accurate than either a
    # sequential or a cumprod product of rounded factors.
    od = jnp.maximum(sigma * dt, 0.0) * maskf
    p = jnp.exp(-jnp.cumsum(od, axis=1))
    t_before = jnp.concatenate(
        [jnp.ones_like(p[:, :1]), p[:, :-1]], axis=1)

    processed = mask & (t_before > stop_threshold)
    procf = processed.astype(sigma.dtype)

    # weight_k = T_before_k * alpha_k = P_{k-1} - P_k: the telescoped form
    # keeps sum(w) == 1 - T exact and avoids expm1's vendor error entirely.
    weight = (t_before - p) * procf

    cr, cg, cb = _color_planes(color)
    radiance = jnp.stack([
        jnp.sum(weight * cr, axis=1),
        jnp.sum(weight * cg, axis=1),
        jnp.sum(weight * cb, axis=1),
    ], axis=-1)

    # Final T: P at the last processed slot (monotone decreasing -> min).
    t_final = jnp.min(jnp.where(processed, p, 1.0), axis=1)
    opacity = 1.0 - t_final

    # Segment cursor: plan t_near plus the dt of all preceding live samples.
    origin = t_near if t_cursor_origin is None else t_cursor_origin
    if hasattr(origin, "ndim") and getattr(origin, "ndim", 0) == 1:
        origin = origin[:, None]
    dt_masked = dt * maskf
    t_cursor = origin + jnp.cumsum(dt_masked, axis=1) - dt_masked
    segment_mid = t_cursor + 0.5 * dt
    depth_weighted = jnp.sum(weight * segment_mid, axis=1)
    depth = jnp.where(
        opacity > OPACITY_EPS, depth_weighted / jnp.maximum(opacity, OPACITY_EPS),
        t_far)

    if with_aux:
        alpha = compute_alpha(sigma, dt) * maskf  # int_cpu.cpp:201 parity
        log_t_before = jnp.log(jnp.maximum(t_before, LOG_T_FLOOR))
        aux = jnp.stack(
            [alpha * procf, weight, t_before * procf, log_t_before * procf],
            axis=-1)
    else:
        aux = None

    return Integration(
        radiance=radiance,
        transmittance=t_final,
        opacity=opacity,
        depth=depth,
        aux=aux,
    )


def radiance_only(sigma, color, dt, mask, stop_threshold: float = STOP_THRESHOLD):
    """Radiance head alone - the quantity ``hp_diff`` differentiates.

    Used by :mod:`dvren_tpu.ops.diff` to derive per-sample gradients with the
    exact reference semantics (dL/dI flows into radiance only; transmittance,
    opacity and depth heads receive no adjoint in hp_diff).
    """
    maskf = mask.astype(sigma.dtype)
    od = jnp.maximum(sigma * dt, 0.0) * maskf
    p = jnp.exp(-jnp.cumsum(od, axis=1))
    t_before = jnp.concatenate([jnp.ones_like(p[:, :1]), p[:, :-1]], axis=1)
    processed = mask & (t_before > stop_threshold)
    weight = (t_before - p) * processed.astype(sigma.dtype)
    cr, cg, cb = _color_planes(color)
    return jnp.stack([
        jnp.sum(weight * cr, axis=1),
        jnp.sum(weight * cg, axis=1),
        jnp.sum(weight * cb, axis=1),
    ], axis=-1)
