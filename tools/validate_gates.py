"""CI gate validation over the manifest scoreboard.

The analogue of the reference's six-gate validator
(``hotpath/scripts/validate_gates.py:240-255``): consumes the JSON
scoreboard from ``tools/run_manifest.py`` (stdin or --scoreboard file) and
enforces:

  Contract     - ray/samp/img/fused structural cases all pass
  Gradient     - diff_* cases pass (adjoint parity + FD referees)
  Performance  - bench results (if present) meet locked thresholds
  Stability    - no case reports an internal error; early-stop case passes
  Determinism  - *_determinism cases pass
  Artifacts    - scoreboard well-formed and complete vs the manifest

Prints a gate summary JSON and exits non-zero on any gate failure.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GATE_CASES = {
    "contract": [
        "ray_basic", "ray_counts", "ray_oracle", "ray_roi", "ray_override",
        "samp_basic", "samp_dt_truncation", "samp_oob_zero", "samp_oob_clamp",
        "img_basic", "img_accumulate", "img_roi_background",
        "fused_equivalence", "forward_oracle",
        "march_forward_parity", "march_block_padding",
        "sparse_renderer_parity", "moving_camera_oracle",
    ],
    "gradient": [
        "diff_sigma_color", "diff_early_stop", "diff_fd_referee",
        "diff_grid_fd", "diff_camera_fd", "ray_camera_grads",
        "hash_mlp_grads", "multichip_dp_grads",
        "march_gradients", "march_camera_gradients",
        "sparse_brick_gradients",
    ],
    "stability": ["int_early_stop", "int_constant", "int_gaussian",
                  "march_early_termination"],
    "determinism": [
        "samp_stratified_determinism", "hash_mlp_determinism",
        "graph_determinism", "rng_splitmix_golden",
        "diff_determinism", "forward_determinism",
    ],
}


def load_thresholds(path: str) -> dict:
    values = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0]
            m = re.match(r"\s+(\w+):\s*([-\d.eE+]+)", line)
            if m:
                try:
                    values[m.group(1)] = float(m.group(2))
                except ValueError:
                    pass
    return values


def validate(scoreboard: dict, bench: dict | None,
             thresholds: dict) -> dict:
    status = {c["name"]: c["status"] for c in scoreboard.get("cases", [])}
    gates = {}

    for gate, names in GATE_CASES.items():
        missing = [n for n in names if n not in status]
        failed = [n for n in names if status.get(n) == "fail"]
        ok = not failed and not missing
        gates[gate] = {
            "pass": ok,
            "failed_cases": failed,
            "missing_cases": missing,
        }

    # Performance gate: compare bench result to locked thresholds. With no
    # bench data at all (fresh checkout on a CPU-only host) the gate is
    # SKIPPED, not failed - matching the reference validator, which stays
    # usable without device perf data (hotpath/scripts/validate_gates.py:
    # 240-255).
    min_fwd = thresholds.get("bench_min_fwd_mrays", 0.0)
    min_fb = thresholds.get("bench_min_fwdbwd_mrays", 0.0)
    if bench is None:
        gates["performance"] = {
            "pass": True,
            "skipped": "no bench results on this host (run bench.py on a "
                       "GPU and pass --bench)",
        }
    else:
        fwd = float(bench.get("value", 0.0))
        fb = float(bench.get("extra", {}).get("fwdbwd_Mrays_per_s", 0.0))
        gates["performance"] = {
            "pass": fwd >= min_fwd and fb >= min_fb,
            "fwd_mrays": fwd, "min_fwd": min_fwd,
            "fwdbwd_mrays": fb, "min_fwdbwd": min_fb,
        }

    # Artifacts gate: scoreboard shape + summary consistency.
    cases = scoreboard.get("cases", [])
    summary = scoreboard.get("summary", {})
    counted = {"pass": 0, "fail": 0, "skip": 0}
    for c in cases:
        if c.get("status") in counted:
            counted[c["status"]] += 1
    gates["artifacts"] = {
        "pass": bool(cases) and counted == {
            k: summary.get(k, -1) for k in counted},
    }

    all_pass = all(g["pass"] for g in gates.values())
    return {"gates": gates, "all_pass": all_pass}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--scoreboard", default="-",
                        help="scoreboard JSON file, '-' for stdin")
    parser.add_argument("--bench", default=None,
                        help="bench.py output JSON file (optional)")
    parser.add_argument("--thresholds",
                        default=os.path.join(REPO, "tests/thresholds.yaml"))
    args = parser.parse_args()

    if args.scoreboard == "-":
        scoreboard = json.load(sys.stdin)
    else:
        with open(args.scoreboard) as f:
            scoreboard = json.load(f)
    bench = None
    if args.bench:
        with open(args.bench) as f:
            bench = json.load(f)

    thresholds = load_thresholds(args.thresholds)
    report = validate(scoreboard, bench, thresholds)
    print(json.dumps(report))
    return 0 if report["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
