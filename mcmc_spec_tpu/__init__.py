"""mcmc_spec_tpu: a JAX framework for composite-spectrum MCMC fitting on GPUs.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
``kendallsullivan/mcmc_spec`` (reference: ``mft6.py``): inference of unresolved
binary/triple star parameters (component Teffs, extinction Av, radii, parallax)
by jointly fitting an observed spectrum, resolved contrast magnitudes, and
unresolved photometry against interpolated model-spectrum grids.

Design (accelerator-first, not a port):

* The model grid is packed into a device-resident ``f32[nT, nG, nwl]`` tensor
  (reference keeps a python dict of numpy arrays, ``mft6.py:255-385``).
* Everything downstream of grid pre-processing is *linear* in the grid spectra
  until the log/normalisation steps, so the grid is pre-projected once onto
  (a) the data wavelength grid and (b) per-filter integration weights.  A
  log-posterior evaluation is then a couple of bilinear gathers plus fused
  vector math over ~2k points  (reference re-globs the model directory and
  re-runs interp1d/trapz per evaluation, ``mft6.py:387-563,651-831``).
* Walkers are ``vmap``-ed within a device and ``shard_map``-ed over a
  ``jax.sharding.Mesh`` across devices; whole chains run inside ``lax.scan``
  (reference forks one OS process per walker, ``mft6.py:1744-1753``).
* Host dependencies in the hot loop (Bayestar dust-map query per step,
  ``mft6.py:1233-1239``) become precomputed device tensors.
"""

__version__ = "0.1.0"

from mcmc_spec_tpu.utils.config import FitConfig  # noqa: F401
