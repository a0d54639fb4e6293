"""Report helpers.  Plotting modules (``plots``, ``corner_plot``) need the
'plots' extra and are imported on their own, so the fit path runs without
matplotlib."""
from mcmc_spec_tpu.report.corner_stats import (  # noqa: F401
    bimodal_decompose,
    gauss,
    bimodal,
    quantile_title,
)
from mcmc_spec_tpu.report.composite import composite_full, band_mag_posteriors  # noqa: F401
