"""Per-ray fused march kernel (ops/march.py) in the Pallas interpreter
against the plain ``render`` pipeline: outputs, padding and block size,
the voxel table, and the routing decision."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dvren_tpu import (CameraModel, InterpMode, OobPolicy, Roi,
                       SamplingMode, SparseGridField)
from dvren_tpu.ops import march
from dvren_tpu.ops.raygen import generate_rays
from dvren_tpu.render.pipeline import plan_jitter_table, render
from tests import march_cases as mc

SCENARIOS = {
    "cubic_fixed": (dict(mode=SamplingMode.FIXED), dict()),
    "cubic_stratified": (dict(), dict()),
    "non_cubic": (dict(), dict(shape=(5, 9, 6))),
    "min_grid_2": (dict(), dict(shape=(2, 2, 2), scale=3.0)),
    "grid_2x3x16": (dict(), dict(shape=(2, 3, 16), scale=4.0)),
    "custom_bbox": (dict(), dict(bbox=((0.3, 0.2, -0.1), (0.8, 0.9, 0.7)))),
    "orthographic": (dict(model=CameraModel.ORTHOGRAPHIC, ortho_scale=1.3),
                     dict()),
    "roi": (dict(width=20, height=14, roi=Roi(x=3, y=2, width=11, height=9)),
            dict()),
    "rays_not_block_multiple": (dict(width=13, height=11), dict()),
    "thick_early_exit": (dict(), dict(scale=400.0)),
    "all_miss": (dict(c2w=(1, 0, 0, 5.0, 0, 1, 0, 5.0, 0, 0, 1, -1.0)),
                 dict()),
    "t_range_clip": (dict(t_near=0.35, t_far=1.93, dt=0.07, max_steps=32),
                     dict()),
    "max_steps_clip": (dict(dt=0.05, max_steps=20), dict()),
    "oblique_orbit": (dict(c2w=mc.ORBIT[0]), dict(blob=True)),
}


def _scene(name):
    plan_kw, field_kw = SCENARIOS[name]
    return mc.plan(**plan_kw), mc.field(**field_kw)


def _jitter(plan):
    jt = plan_jitter_table(plan)
    return None if jt is None else jnp.asarray(jt)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_march_matches_plain(name):
    plan, field = _scene(name)
    jit = _jitter(plan)
    got = march.render_march(plan, field, jitter=jit, interpret=True)
    want = render(plan, field, jitter=jit).planes
    mc.assert_planes_close(got, want)
    if name == "thick_early_exit":
        assert float(np.asarray(want.opacity).max()) > 0.999
    if name == "all_miss":
        assert float(np.abs(np.asarray(got.image)).max()) == 0.0
        np.testing.assert_array_equal(np.asarray(got.depth),
                                      np.float32(plan.t_far))


@pytest.mark.parametrize("block", [32, 64, 128])
def test_march_block_size_and_padding(block):
    """The ray count (13 x 11 = 143) is padded to the block; the padded
    tail never leaks into the real rays, whatever the block size."""
    plan, field = _scene("rays_not_block_multiple")
    jit = _jitter(plan)
    rays = generate_rays(plan)
    rad, trans, opac, depth = march.march_rays(plan, field, rays, jit,
                                               interpret=True, block=block)
    assert rad.shape == (143, 3) and trans.shape == (143,)
    ref = march.march_rays(plan, field, rays, jit, interpret=True, block=16)
    for a, b in zip((rad, trans, opac, depth), ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_march_in_graph_jitter_matches_table():
    """Without a jitter table the wrapper hashes (seed, ray, step) in-graph
    with ops.rng; it agrees with the host splitmix64 table to an ulp."""
    plan, field = _scene("cubic_stratified")
    a = march.render_march(plan, field, jitter=_jitter(plan), interpret=True)
    b = march.render_march(plan, field, jitter=None, interpret=True)
    mc.assert_planes_close(a, b, tol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_voxel_table_layout(dtype):
    field = mc.field(shape=(3, 4, 5)).with_packed_dtype(dtype)
    tab = np.asarray(march.voxel_table(field)).reshape(5, 4, 3, 4)
    cast = lambda x: np.asarray(  # noqa: E731
        jnp.asarray(x).astype(dtype).astype(jnp.float32))
    np.testing.assert_array_equal(tab[..., 0], cast(field.sigma))
    np.testing.assert_array_equal(tab[..., 1:], cast(field.color))


def test_march_bf16_table_matches_plain():
    plan, field = _scene("cubic_stratified")
    field = field.with_packed_dtype("bfloat16")
    jit = _jitter(plan)
    mc.assert_planes_close(
        march.render_march(plan, field, jitter=jit, interpret=True),
        render(plan, field, jitter=jit).planes)


def _grid(interp=InterpMode.LINEAR, oob=OobPolicy.ZERO, shape=(6, 6, 6)):
    f = mc.field(shape=shape)
    return f.__class__(sigma=f.sigma, color=f.color, bbox_min=f.bbox_min,
                       bbox_max=f.bbox_max, interp=interp, oob=oob)


ROUTES = {
    "dense_gpu": (lambda: _grid(), "gpu", True),
    "dense_cpu": (lambda: _grid(), "cpu", False),
    "dense_other_backend": (lambda: _grid(), "rocm", False),
    "nearest": (lambda: _grid(interp=InterpMode.NEAREST), "gpu", False),
    "clamp": (lambda: _grid(oob=OobPolicy.CLAMP), "gpu", False),
    "flat_grid": (lambda: _grid(shape=(6, 1, 6)), "gpu", False),
    "sparse": (lambda: SparseGridField.from_dense(_grid()), "gpu", False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_select_route(name):
    make, backend, want_kernel = ROUTES[name]
    route = march.select_route(make(), backend=backend)
    assert route.kernel is want_kernel
    assert route.note == ("march_kernel" if want_kernel else "plain_path")
    assert route.interpret is False


def test_select_route_hash_field_is_plain():
    from dvren_tpu import HashMLPConfig, HashMLPField
    f = HashMLPField.create(HashMLPConfig())
    assert not march.select_route(f, backend="gpu").kernel


def test_interpret_is_explicit_and_defaults_false():
    for fn in (march.select_route, march.march_rays, march.render_march):
        assert inspect.signature(fn).parameters["interpret"].default is False
    assert march.select_route(_grid(), backend="gpu",
                              interpret=True).interpret is True


def test_march_jit_and_camera_arguments_trace():
    """Camera arrays are traced arguments: one executable for many poses."""
    plan, field = mc.plan(width=8, height=8), mc.field(blob=True)
    fn = jax.jit(lambda c2w: march.render_march(
        plan, field, c2w=c2w, interpret=True).image)
    imgs = [fn(jnp.asarray(c, jnp.float32).reshape(3, 4))
            for c in mc.ORBIT[:2]]
    assert fn._cache_size() == 1
    assert float(jnp.abs(imgs[0] - imgs[1]).max()) > 1e-3


@pytest.mark.gpu
def test_march_compiled_on_gpu_matches_plain(gpu):
    """The kernel as compiled for the card (not interpreted) at a small
    shape; chip_smoke.py runs the same comparison at full width."""
    plan, field = _scene("oblique_orbit")
    jit = _jitter(plan)
    got = jax.jit(lambda f: march.render_march(plan, f, jitter=jit))(field)
    with jax.default_matmul_precision("highest"):
        want = render(plan, field, jitter=jit).planes
    mc.assert_planes_close(got, want, tol=1e-4, depth_tol=1e-3)


@pytest.mark.parametrize("mode", [SamplingMode.FIXED,
                                  SamplingMode.STRATIFIED])
def test_march_lowers_to_triton_for_cuda(mode):
    """The kernel lowers to a Triton custom call for the CUDA platform on a
    host without a card (only the Triton compile itself needs the GPU)."""
    plan, field = mc.plan(width=8, height=8, mode=mode), mc.field()
    fn = jax.jit(lambda f, j: march.render_march(plan, f, jitter=j).image)
    lowered = fn.trace(field, _jitter(plan)).lower(
        lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in lowered.as_text()


@pytest.mark.parametrize("argv", [["chip_smoke.py"],
                                  ["chip_smoke.py", "--multi"],
                                  ["bench.py"]])
def test_gpu_scripts_refuse_the_cpu(argv):
    """chip_smoke.py and bench.py measure the card: without a GPU they exit
    non-zero and print no result line."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, *argv], cwd=repo, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"metric"' not in proc.stdout
    assert "needs a GPU" in proc.stderr
