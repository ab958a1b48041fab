"""Grid-fit wall-clock benchmark: 64^3 multi-view Adam fit to target PSNR.

The BASELINE.json training-loop metric ("64^3 grid fit wall-clock to PSNR
35"). Renders V ground-truth views from a procedural volume, re-initializes
the grid, and fits sigma+color with Adam until the target PSNR (or the step
cap). Prints one JSON line.

Prints the card's name and power limit, then the JSON line. Exits
non-zero without a GPU: the wall clock only means something on the card.

Usage: python tools/fit_benchmark.py [--views 8] [--res 96] [--psnr 35]
"""

from __future__ import annotations

import argparse
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))
import json
import sys


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--views", type=int, default=8)
    parser.add_argument("--res", type=int, default=96)
    parser.add_argument("--grid", type=int, default=64)
    parser.add_argument("--psnr", type=float, default=35.0)
    parser.add_argument("--max-steps", type=int, default=2000)
    parser.add_argument("--lr", type=float, default=5e-2)
    parser.add_argument("--sync-every", type=int, default=32)
    parser.add_argument("--mode", default=None,
                        choices=(None, "windowed", "plain"),
                        help="fit path override (default: plain)")
    args = parser.parse_args()

    import numpy as np
    import jax

    import bench

    bench.use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"fit_benchmark needs a GPU; JAX found {dev.platform}",
              file=sys.stderr)
        return 2
    card = bench.card_line()
    print(f"card: {card}", flush=True)

    import jax.numpy as jnp

    from dvren_tpu.opt.fit import FitConfig, fit_dense_grid, render_views

    plan, truth, cams = bench.fit_scene(views=args.views, res=args.res,
                                        grid_n=args.grid)
    g, w, h = args.grid, args.res, args.res
    targets = np.asarray(render_views(plan, truth, cams))

    init = truth.with_params(
        jnp.full_like(truth.sigma, 0.5), jnp.full_like(truth.color, 0.5))
    result = fit_dense_grid(
        plan, init, cams, targets,
        FitConfig(learning_rate=args.lr, steps=args.max_steps,
                  target_psnr=args.psnr, log_every=100,
                  sync_every=args.sync_every),
        mode=args.mode)

    out = {
        "metric": "grid_fit_s_to_psnr",
        "value": round(result.wall_clock_s, 2),
        "unit": "s",
        "target_psnr": args.psnr,
        "reached": result.reached_target,
        "final_psnr": round(result.psnr_history[-1], 2),
        "steps": result.steps_run,
        # The first step includes the jit compile / executable cache load;
        # steady_step_ms is the training rate.
        "schedule_build_s": round(result.schedule_build_s, 2),
        "first_step_s": round(result.first_step_s, 2),
        "steady_step_ms": round(result.steady_step_ms, 1),
        "sync_every": args.sync_every,
        "mode": result.mode,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "config": f"{g}^3 grid, {args.views} views @ {w}x{h}",
    }
    print(json.dumps(out))
    return 0 if result.reached_target else 1


if __name__ == "__main__":
    sys.exit(main())
