"""dvren_render CLI: JSON config in, PPM image out.

Parity with the reference CLI (``apps/dvren_render/main.cpp:314-370``):

    python -m dvren_tpu.cli <config.json> [output.ppm]

Prints the same summary lines (forward stats + workspace accounting) so
downstream tooling can scrape either implementation.
"""

from __future__ import annotations

import sys

from dvren_tpu.core.context import Context
from dvren_tpu.core.plan import Plan
from dvren_tpu.core.status import DvrenError
from dvren_tpu.fields.dense_grid import DenseGridField
from dvren_tpu.io.config import parse_config_file
from dvren_tpu.io.ppm import write_ppm
from dvren_tpu.render.renderer import Renderer


def render_to_file(ctx: Context, plan: Plan, field: DenseGridField,
                   options, output_path: str) -> int:
    renderer = Renderer(ctx, plan, options)
    result = renderer.forward(field)
    workspace = renderer.workspace_info()

    image = result.image.reshape(plan.height, plan.width, 3)
    write_ppm(output_path, image)

    print(f"Forward stats: rays={result.ray_count} "
          f"samples={result.sample_count} "
          f"total_ms={result.stats.total_ms:.4g}")
    print(f"Render path: {renderer.last_path}")
    print(f"Workspace bytes total={workspace.total_bytes()} "
          f"sample={workspace.sample_buffer_bytes} "
          f"integration={workspace.integration_buffer_bytes} "
          f"gradient={workspace.gradient_buffer_bytes} "
          f"scratch={workspace.workspace_buffer_bytes}")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 1 or len(argv) > 2:
        print("usage: python -m dvren_tpu.cli <config.json> [output.ppm]",
              file=sys.stderr)
        return 2
    try:
        config = parse_config_file(argv[0])
        output_path = argv[1] if len(argv) == 2 else config.output_path
        ctx = Context.create()
        plan = Plan.create(config.plan)
        field = DenseGridField.create(config.grid)
        if config.table_precision != "float32":
            field = field.with_packed_dtype(config.table_precision)
        return render_to_file(ctx, plan, field, config.options, output_path)
    except DvrenError as exc:
        print(f"error: {exc.status.to_string()}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
