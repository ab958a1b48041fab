"""ctypes bindings for the native runtime library (libdvren_native.so).

Builds on demand with g++ (cached next to the source); all entry points
degrade gracefully - ``available()`` reports whether the library could be
built/loaded, and callers fall back to the pure-JAX/numpy paths.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "dvren_native.cpp")
_LIB = os.path.join(_DIR, "libdvren_native.so")

_lock = threading.Lock()
_lib = None
_load_error: str | None = None

_f32p = ctypes.POINTER(ctypes.c_float)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _build() -> None:
    # -ffp-contract=off: the double-precision referee keeps the exact
    # operation order of its source (no contracted mul+add FMAs).
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-shared",
           "-fPIC", "-std=c++17", _SRC, "-o", _LIB]
    subprocess.run(cmd, check=True, capture_output=True, text=True)


def _configure(lib) -> None:
    lib.dvn_abi_version.restype = ctypes.c_int
    lib.dvn_generate_rays.restype = ctypes.c_int
    lib.dvn_generate_rays.argtypes = [
        ctypes.c_int, _f32p, _f32p, ctypes.c_float,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float,
        _f32p, _f32p, _f32p, _f32p, _u32p]
    lib.dvn_eval_grid.restype = ctypes.c_int
    lib.dvn_eval_grid.argtypes = [
        _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _f32p, _f32p, ctypes.c_int, ctypes.c_int,
        _f32p, ctypes.c_long, _f32p]
    lib.dvn_integrate.restype = ctypes.c_int
    lib.dvn_integrate.argtypes = [
        ctypes.c_long, ctypes.c_int, _f32p, _f32p, _f32p, _u8p,
        ctypes.c_float, ctypes.c_float, _f32p, _f32p, _f32p, _f32p, _f32p]
    lib.dvn_ray_offsets.restype = ctypes.c_long
    lib.dvn_ray_offsets.argtypes = [
        ctypes.c_long, ctypes.c_int, _u8p, _u32p]
    lib.dvn_pack_samples.restype = ctypes.c_long
    lib.dvn_pack_samples.argtypes = [
        ctypes.c_long, ctypes.c_int, ctypes.c_int, _u8p, _f32p, _f32p]
    lib.dvn_unpack_samples.restype = ctypes.c_long
    lib.dvn_unpack_samples.argtypes = [
        ctypes.c_long, ctypes.c_int, ctypes.c_int, _u8p, _f32p, _f32p]
    lib.dvn_write_ppm.restype = ctypes.c_int
    lib.dvn_write_ppm.argtypes = [
        ctypes.c_char_p, _f32p, ctypes.c_int, ctypes.c_int]


def _get():
    global _lib, _load_error
    with _lock:
        if _lib is not None or _load_error is not None:
            return _lib
        try:
            if (not os.path.exists(_LIB)
                    or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
                _build()
            lib = ctypes.CDLL(_LIB)
            _configure(lib)
            if lib.dvn_abi_version() != 4:
                raise RuntimeError("native ABI version mismatch")
            _lib = lib
        except Exception as exc:  # pragma: no cover - toolchain-dependent
            _load_error = str(exc)
        return _lib


def available() -> bool:
    return _get() is not None


def load_error() -> str | None:
    _get()
    return _load_error


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctype)


def generate_rays(model: int, k: np.ndarray, c2w: np.ndarray,
                  ortho_scale: float, width: int, height: int,
                  roi, t_near: float, t_far: float):
    lib = _get()
    n = roi[2] * roi[3]
    origins = np.empty((n, 3), np.float32)
    dirs = np.empty((n, 3), np.float32)
    tn = np.empty(n, np.float32)
    tf = np.empty(n, np.float32)
    pids = np.empty(n, np.uint32)
    k = np.ascontiguousarray(k, np.float32).reshape(-1)
    c2w = np.ascontiguousarray(c2w, np.float32).reshape(-1)
    rc = lib.dvn_generate_rays(
        model, _ptr(k, _f32p), _ptr(c2w, _f32p), ortho_scale,
        width, height, roi[0], roi[1], roi[2], roi[3], t_near, t_far,
        _ptr(origins, _f32p), _ptr(dirs, _f32p), _ptr(tn, _f32p),
        _ptr(tf, _f32p), _ptr(pids, _u32p))
    if rc != 0:
        raise RuntimeError(f"dvn_generate_rays failed: {rc}")
    return origins, dirs, tn, tf, pids


def eval_grid(grid: np.ndarray, bbox_min, bbox_max, interp: int, oob: int,
              positions: np.ndarray) -> np.ndarray:
    lib = _get()
    grid = np.ascontiguousarray(grid, np.float32)
    scalar = grid.ndim == 3
    nz, ny, nx = grid.shape[:3]
    channels = 0 if scalar else grid.shape[3]
    positions = np.ascontiguousarray(positions, np.float32).reshape(-1, 3)
    n = positions.shape[0]
    out = np.empty((n, max(channels, 1)), np.float32)
    bmin = np.asarray(bbox_min, np.float32)
    bmax = np.asarray(bbox_max, np.float32)
    rc = lib.dvn_eval_grid(
        _ptr(grid, _f32p), nx, ny, nz, channels,
        _ptr(bmin, _f32p), _ptr(bmax, _f32p), interp, oob,
        _ptr(positions, _f32p), n, _ptr(out, _f32p))
    if rc != 0:
        raise RuntimeError(f"dvn_eval_grid failed: {rc}")
    return out[:, 0] if scalar else out


def integrate(sigma: np.ndarray, color: np.ndarray, dt: np.ndarray,
              mask: np.ndarray, t_near: float, t_far: float,
              want_aux: bool = False):
    lib = _get()
    n, k = sigma.shape
    sigma = np.ascontiguousarray(sigma, np.float32)
    color = np.ascontiguousarray(color, np.float32)
    dt = np.ascontiguousarray(dt, np.float32)
    mask8 = np.ascontiguousarray(mask, np.uint8)
    radiance = np.empty((n, 3), np.float32)
    trans = np.empty(n, np.float32)
    opacity = np.empty(n, np.float32)
    depth = np.empty(n, np.float32)
    aux = np.zeros((n, k, 4), np.float32) if want_aux else None
    rc = lib.dvn_integrate(
        n, k, _ptr(sigma, _f32p), _ptr(color, _f32p), _ptr(dt, _f32p),
        _ptr(mask8, _u8p), t_near, t_far,
        _ptr(radiance, _f32p), _ptr(trans, _f32p), _ptr(opacity, _f32p),
        _ptr(depth, _f32p),
        _ptr(aux, _f32p) if aux is not None else _f32p())
    if rc != 0:
        raise RuntimeError(f"dvn_integrate failed: {rc}")
    out = dict(radiance=radiance, transmittance=trans, opacity=opacity,
               depth=depth)
    if want_aux:
        out["aux"] = aux
    return out


def ray_offsets(mask: np.ndarray) -> np.ndarray:
    lib = _get()
    n, k = mask.shape
    mask8 = np.ascontiguousarray(mask, np.uint8)
    offsets = np.empty(n + 1, np.uint32)
    lib.dvn_ray_offsets(n, k, _ptr(mask8, _u8p), _ptr(offsets, _u32p))
    return offsets


def pack_samples(mask: np.ndarray, dense: np.ndarray) -> np.ndarray:
    """dense: (N, K) or (N, K, C) -> packed (M,) or (M, C)."""
    lib = _get()
    n, k = mask.shape
    scalar = dense.ndim == 2
    channels = 1 if scalar else dense.shape[2]
    mask8 = np.ascontiguousarray(mask, np.uint8)
    dense = np.ascontiguousarray(dense, np.float32)
    total = int(mask8.sum())
    packed = np.empty((total, channels), np.float32)
    got = lib.dvn_pack_samples(n, k, channels, _ptr(mask8, _u8p),
                               _ptr(dense, _f32p), _ptr(packed, _f32p))
    assert got == total
    return packed[:, 0] if scalar else packed


def unpack_samples(mask: np.ndarray, packed: np.ndarray) -> np.ndarray:
    lib = _get()
    n, k = mask.shape
    scalar = packed.ndim == 1
    channels = 1 if scalar else packed.shape[1]
    mask8 = np.ascontiguousarray(mask, np.uint8)
    packed = np.ascontiguousarray(packed, np.float32)
    dense = np.empty((n, k, channels), np.float32)
    lib.dvn_unpack_samples(n, k, channels, _ptr(mask8, _u8p),
                           _ptr(packed, _f32p), _ptr(dense, _f32p))
    return dense[..., 0] if scalar else dense


def write_ppm(path: str, image: np.ndarray) -> None:
    lib = _get()
    image = np.ascontiguousarray(image, np.float32)
    h, w, _ = image.shape
    rc = lib.dvn_write_ppm(path.encode(), _ptr(image, _f32p), w, h)
    if rc != 0:
        raise RuntimeError(f"dvn_write_ppm failed: {rc}")
