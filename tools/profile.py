"""Profiling wrapper: device facts + benchmark + per-stage timings.

The analogue of ``hotpath/scripts/profile.py:16-148`` (which wraps the
runner with an nvidia-smi hardware profile): captures the JAX device
profile, runs the benchmark (``bench.measure``, in this process: one JAX
process per card), collects the Renderer's per-stage timings for a
representative plan, and writes ``benchmark_results.json`` +
``profiling_summary.txt``. Without a GPU only the device facts and the
staged timings of the CPU are written; the benchmark is skipped.

Optionally captures a ``jax.profiler`` trace (``--trace DIR``) viewable in
TensorBoard/XProf (the reference has no tracing, SURVEY.md section 5).

Usage: python tools/profile.py [--trace DIR] [--skip-bench]
"""

from __future__ import annotations

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_profile() -> dict:
    import jax

    devices = jax.devices()
    d = devices[0]
    return {
        "platform": d.platform,
        "device_kind": getattr(d, "device_kind", "unknown"),
        "device_count": len(devices),
        "jax_version": jax.__version__,
        "default_backend": jax.default_backend(),
    }


def stage_timings() -> dict:
    """Per-stage ms through the staged Renderer path (RenderStats parity)."""
    import numpy as np
    from dvren_tpu import (
        Context, DenseGridConfig, DenseGridField, Plan, PlanConfig,
        Renderer, RenderOptions, SamplingConfig,
    )

    n = 32
    rng = np.random.default_rng(0)
    plan = Plan.create(PlanConfig(
        width=128, height=128, t_near=0.2, t_far=2.2,
        sampling=SamplingConfig(dt=0.03125, max_steps=64)))
    field = DenseGridField.create(DenseGridConfig(
        resolution=(n, n, n), sigma=rng.uniform(0, 5, n ** 3),
        color=rng.uniform(0, 1, 3 * n ** 3)))
    r = Renderer(Context.create(), plan,
                 RenderOptions(use_fused_path=False, capture_stats=True))
    r.forward(field)            # warm-up/compile
    result = r.forward(field)
    s = result.stats
    return {
        "total_ms": s.total_ms, "ray_ms": s.ray_ms,
        "sample_ms": s.sample_ms, "integrate_ms": s.integrate_ms,
        "compose_ms": s.compose_ms,
        "workspace": vars(r.workspace_info()),
    }


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--output-dir", default=REPO)
    parser.add_argument("--trace", default=None,
                        help="capture a jax.profiler trace into DIR")
    parser.add_argument("--skip-bench", action="store_true")
    args = parser.parse_args()

    results = {
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "hardware_profile": device_profile(),
    }

    if args.trace:
        import jax

        os.makedirs(args.trace, exist_ok=True)
        with jax.profiler.trace(args.trace):
            results["stage_timings"] = stage_timings()
        results["trace_dir"] = args.trace
    else:
        results["stage_timings"] = stage_timings()

    if not args.skip_bench and results["hardware_profile"]["platform"] \
            == "gpu":
        import bench

        bench.use_compile_cache()
        results["benchmark"] = bench.measure(bench.card_line())

    out_json = os.path.join(args.output_dir, "benchmark_results.json")
    with open(out_json, "w") as f:
        json.dump(results, f, indent=2)

    summary = os.path.join(args.output_dir, "profiling_summary.txt")
    with open(summary, "w") as f:
        hw = results["hardware_profile"]
        f.write(f"device: {hw['device_kind']} x{hw['device_count']} "
                f"({hw['platform']})\n")
        st = results.get("stage_timings", {})
        f.write(f"staged path ms: total={st.get('total_ms', 0):.3f} "
                f"ray={st.get('ray_ms', 0):.3f} "
                f"sample={st.get('sample_ms', 0):.3f} "
                f"integrate={st.get('integrate_ms', 0):.3f} "
                f"compose={st.get('compose_ms', 0):.3f}\n")
        b = results.get("benchmark")
        if b:
            f.write(f"bench: {b['value']} {b['unit']}, train "
                    f"{b['extra']['train_ms_per_step']} ms/step on "
                    f"{b['extra']['card']}\n")
    print(json.dumps({"written": [out_json, summary]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
