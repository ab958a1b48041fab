from dvren_tpu.opt.fit import (
    FitConfig,
    FitResult,
    fit_dense_grid,
    mse,
    psnr,
    render_views,
)

__all__ = [
    "FitConfig",
    "FitResult",
    "fit_dense_grid",
    "mse",
    "psnr",
    "render_views",
]
