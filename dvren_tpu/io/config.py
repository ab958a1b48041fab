"""JSON render config: schema parity with the reference CLI
(``apps/dvren_render/main.cpp:77-253``; schema documented README.md:99-131).

Top-level nodes:
  render: width, height, t_near (default 0), t_far (required), dt (required),
          max_steps (required), sampling_mode ("fixed"|"stratified"),
          seed (default 0), roi {x, y, width, height},
          camera {model, K[9], c2w[12], ortho_scale},
          options {use_fused_path, enable_graph, capture_stats, use_window}
          (the removed tile-path keys use_tiles, use_occupancy and
          tile_pitch are rejected)
  volume: size [nx, ny, nz], density [n], color [3n] (defaults to grayscale
          density, main.cpp:167-177), bbox_min [3], bbox_max [3],
          interp ("linear"|"nearest"), oob ("zero"|"clamp")
  output: path (default "frame.ppm")
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field as dc_field

import numpy as np

from dvren_tpu.core.plan import (
    CameraConfig, CameraModel, InterpMode, OobPolicy, PlanConfig, Roi,
    SamplingConfig, SamplingMode,
)
from dvren_tpu.core.status import DvrenError, check
from dvren_tpu.fields.dense_grid import DenseGridConfig
from dvren_tpu.render.renderer import RenderOptions


@dataclass
class RenderConfig:
    """Everything the CLI needs; mirrors the reference's RenderConfig.

    ``table_precision``: "float32" (default) or "bfloat16" - the packed
    field-table precision (extension; the reference's hp_dtype also lists
    F16/BF16, hp.h:44-50)."""

    plan: PlanConfig = dc_field(default_factory=PlanConfig)
    grid: DenseGridConfig | None = None
    options: RenderOptions = dc_field(default_factory=RenderOptions)
    output_path: str = "frame.ppm"
    table_precision: str = "float32"


def _parse_sampling_mode(value: str) -> SamplingMode:
    if value == "fixed":
        return SamplingMode.FIXED
    if value == "stratified":
        return SamplingMode.STRATIFIED
    raise DvrenError.invalid_argument(f"unsupported sampling mode: {value}")


def _parse_interp(value: str) -> InterpMode:
    if value == "linear":
        return InterpMode.LINEAR
    if value == "nearest":
        return InterpMode.NEAREST
    raise DvrenError.invalid_argument(
        f"unsupported interpolation mode: {value}")


def _parse_oob(value: str) -> OobPolicy:
    if value == "zero":
        return OobPolicy.ZERO
    if value == "clamp":
        return OobPolicy.CLAMP
    raise DvrenError.invalid_argument(f"unsupported oob policy: {value}")


def _default_k(width: int, height: int) -> tuple[float, ...]:
    return (1.0, 0.0, width * 0.5,
            0.0, 1.0, height * 0.5,
            0.0, 0.0, 1.0)


def _parse_plan(node: dict) -> PlanConfig:
    width = int(node["width"])
    height = int(node["height"])
    camera = CameraConfig(k=_default_k(width, height))
    if "camera" in node:
        cam = node["camera"]
        model = (CameraModel.ORTHOGRAPHIC
                 if cam.get("model", "pinhole") == "orthographic"
                 else CameraModel.PINHOLE)
        k = camera.k
        if "K" in cam:
            check(len(cam["K"]) == 9, "camera.K must have 9 elements")
            k = tuple(float(v) for v in cam["K"])
        c2w = (0.0,) * 12
        if "c2w" in cam:
            check(len(cam["c2w"]) == 12, "camera.c2w must have 12 elements")
            c2w = tuple(float(v) for v in cam["c2w"])
        camera = CameraConfig(model=model, k=k, c2w=c2w,
                              ortho_scale=float(cam.get("ortho_scale", 1.0)))

    roi = Roi()
    if "roi" in node:
        r = node["roi"]
        roi = Roi(x=int(r.get("x", 0)), y=int(r.get("y", 0)),
                  width=int(r.get("width", width)),
                  height=int(r.get("height", height)))

    return PlanConfig(
        width=width,
        height=height,
        t_near=float(node.get("t_near", 0.0)),
        t_far=float(node["t_far"]),
        seed=int(node.get("seed", 0)),
        camera=camera,
        roi=roi,
        sampling=SamplingConfig(
            dt=float(node["dt"]),
            max_steps=int(node["max_steps"]),
            mode=_parse_sampling_mode(node.get("sampling_mode", "fixed")),
        ),
    )


def _procedural_volume(kind: str, nx: int, ny: int, nz: int):
    """Built-in procedural volumes (extension beyond the reference schema, so
    example configs need not inline megabytes of voxel data)."""
    zs, ys, xs = np.meshgrid(
        np.linspace(0, 1, nz), np.linspace(0, 1, ny), np.linspace(0, 1, nx),
        indexing="ij")
    if kind == "gaussian_blob":
        r2 = (xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.45) ** 2
        sigma = 12.0 * np.exp(-r2 / 0.05)
        color = np.stack([xs, ys, 1.0 - zs], axis=-1)
    elif kind == "sdf_sphere_shell":
        r = np.sqrt((xs - 0.5) ** 2 + (ys - 0.5) ** 2 + (zs - 0.5) ** 2)
        shell = np.exp(-((r - 0.35) ** 2) / (2 * 0.02 ** 2))
        sigma = 25.0 * shell
        color = np.stack([0.9 * np.ones_like(xs), 0.6 + 0.4 * zs, 0.4 + 0.6 * ys],
                         axis=-1)
    else:
        raise DvrenError.invalid_argument(
            f"unknown procedural volume: {kind}")
    return sigma.astype(np.float32).reshape(-1), \
        color.astype(np.float32).reshape(-1)


def _parse_volume(node: dict) -> DenseGridConfig:
    dims = node["size"]
    check(len(dims) == 3, "volume.size must contain 3 integers")
    nx, ny, nz = (int(v) for v in dims)
    if "procedural" in node:
        sigma, color = _procedural_volume(node["procedural"], nx, ny, nz)
    else:
        sigma = np.asarray(node["density"], np.float32)
        if "color" in node:
            color = np.asarray(node["color"], np.float32)
        else:
            # Grayscale default from density (main.cpp:167-177).
            color = np.repeat(sigma, 3)
    bbox_min = tuple(float(v) for v in node.get("bbox_min", (0.0, 0.0, 0.0)))
    bbox_max = tuple(float(v) for v in node.get("bbox_max", (1.0, 1.0, 1.0)))
    check(len(bbox_min) == 3 and len(bbox_max) == 3,
          "bbox_min/bbox_max must have 3 elements")
    return DenseGridConfig(
        resolution=(nx, ny, nz),
        sigma=sigma,
        color=color,
        bbox_min=bbox_min,
        bbox_max=bbox_max,
        interp=_parse_interp(node.get("interp", "linear")),
        oob=_parse_oob(node.get("oob", "zero")),
    )


_REMOVED_OPTIONS = ("use_tiles", "use_occupancy", "tile_pitch")


def parse_config(root: dict) -> RenderConfig:
    config = RenderConfig()
    render_node = root["render"]
    config.plan = _parse_plan(render_node)
    if "options" in render_node:
        opt = render_node["options"]
        removed = sorted(set(opt) & set(_REMOVED_OPTIONS))
        if removed:
            raise DvrenError.invalid_argument(
                f"unsupported render option(s) {removed}: the tile path "
                "they configured was removed; the render route is chosen "
                "automatically")
        config.options = RenderOptions(
            use_fused_path=bool(opt.get("use_fused_path", True)),
            enable_graph=bool(opt.get("enable_graph", False)),
            capture_stats=bool(opt.get("capture_stats", True)),
            use_window=bool(opt.get("use_window", False)),
        )
    config.grid = _parse_volume(root["volume"])
    precision = root["volume"].get("table_precision", "float32")
    check(precision in ("float32", "bfloat16", "float16"),
          f"unsupported table_precision: {precision}")
    config.table_precision = precision
    if "output" in root:
        config.output_path = str(root["output"].get("path", "frame.ppm"))
    return config


def parse_config_file(path: str | os.PathLike) -> RenderConfig:
    if not os.path.exists(path):
        raise DvrenError.invalid_argument(f"config file not found: {path}")
    with open(path) as f:
        try:
            root = json.load(f)
        except json.JSONDecodeError as exc:
            raise DvrenError.invalid_argument(str(exc)) from exc
    try:
        return parse_config(root)
    except KeyError as exc:
        raise DvrenError.invalid_argument(
            f"missing config key: {exc}") from exc
