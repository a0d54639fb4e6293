"""Device-resident model-spectrum grid.

The reference reads BT-Settl / PHOENIX-HiRes ASCII spectra into a python dict
keyed ``'{teff}, {logg}'`` (``spec_interpolator``, ``mft6.py:255-385``) and
re-discovers the grid axes by globbing the model directory on *every*
evaluation (``get_spec``, ``mft6.py:399-436``).  Here the grid is a packed
``[nT, nG, nwl]`` tensor with static coordinate axes, built once (optionally
via the native C++ loader in ``mcmc_spec_tpu/runtime``) and shipped to device.

The hybrid-resolution contract (``mft6.py:366-383``) is preserved exactly:
every spectrum is resampled onto a uniform 0.2 A grid over
``[specmin, specmax)``, instrumentally broadened to the data resolution *only
inside the data window* ``[wmin, wmax]``, with native-resolution flanks spliced
back so broadband photometry integrates the unsmoothed spectrum.
"""
from __future__ import annotations

import dataclasses
import os
import re
from glob import glob

import numpy as np

from mcmc_spec_tpu.ops.broaden import instrumental_broaden

_BTSETTL_RE = re.compile(r"lte(?P<t>[\d.]+)-(?P<g>[\d.]+)-")


def btsettl_path(grid_dir: str, teff: float, logg: float) -> str:
    """Grid-point filename, BT-Settl convention (reference ``find_model``,
    mft6.py:246-253: ``lte{T/100:03d}-{logg}-0.0a+0.0.BT-Settl.spec.7.txt``)."""
    t = str(int(teff / 1e2)).zfill(3)
    return os.path.join(grid_dir, f"lte{t}-{logg}-0.0a+0.0.BT-Settl.spec.7.txt")


def hires_path(grid_dir: str, teff: float, logg: float, metal: float = 0.0) -> str:
    """PHOENIX HiRes convention (mft6.py:238-243)."""
    t = str(int(teff)).zfill(5)
    m = str(float(metal)).zfill(3)
    g = str(float(logg)).zfill(3)
    return os.path.join(
        grid_dir, f"lte{t}-{g}0-{m}.PHOENIX-ACES-AGSS-COND-2011-HiRes.fits.txt"
    )


@dataclasses.dataclass
class SpectralGrid:
    """A rectangular (Teff, logg) grid of model spectra on a shared wl axis."""

    temps: np.ndarray  # [nT] K, sorted
    loggs: np.ndarray  # [nG] dex, sorted
    wl: np.ndarray  # [nwl] Angstroms
    flux: np.ndarray  # [nT, nG, nwl]

    def __post_init__(self):
        self.temps = np.asarray(self.temps, dtype=np.float64)
        self.loggs = np.asarray(self.loggs, dtype=np.float64)
        self.wl = np.asarray(self.wl, dtype=np.float64)
        self.flux = np.asarray(self.flux, dtype=np.float64)
        assert self.flux.shape == (len(self.temps), len(self.loggs), len(self.wl))

    # ------------------------------------------------------------------ build
    @staticmethod
    def _hybrid_broaden(wl, flux, data_window, resolution):
        """Broaden inside the data window only, splice native flanks back."""
        wmin, wmax = min(data_window), max(data_window)
        mask = (wl >= wmin) & (wl <= wmax)
        if mask.sum() < 32:
            return flux
        _, brd = instrumental_broaden(wl[mask], flux[mask], resolution)
        out = flux.copy()
        out[mask] = brd
        return out

    @classmethod
    def from_spectra(
        cls,
        entries,  # iterable of (teff, logg, wl, flux) at native resolution
        specrange,
        data_window,
        resolution,
        step=0.2,
    ) -> "SpectralGrid":
        """Pack native-resolution spectra onto the common hybrid-res grid.

        Mirrors ``spec_interpolator``'s btsettl branch: uniform ``step`` A grid
        over ``specrange``, linear interp of each spectrum onto it, hybrid
        broadening over ``data_window``.
        """
        wl = np.arange(min(specrange), max(specrange), step)
        by_key = {}
        temps, loggs = set(), set()
        for teff, logg, swl, sflux in entries:
            swl = np.asarray(swl, dtype=np.float64)
            sflux = np.asarray(sflux, dtype=np.float64)
            order = np.argsort(swl)
            f = np.interp(wl, swl[order], sflux[order])
            f = cls._hybrid_broaden(wl, f, data_window, resolution)
            by_key[(float(teff), float(logg))] = f
            temps.add(float(teff))
            loggs.add(float(logg))
        temps = np.array(sorted(temps))
        loggs = np.array(sorted(loggs))
        flux = np.zeros((len(temps), len(loggs), len(wl)))
        for i, t in enumerate(temps):
            for j, g in enumerate(loggs):
                if (t, g) not in by_key:
                    raise ValueError(f"grid is not rectangular: missing (T={t}, logg={g})")
                flux[i, j] = by_key[(t, g)]
        return cls(temps=temps, loggs=loggs, wl=wl, flux=flux)

    @classmethod
    def from_btsettl_dir(
        cls,
        grid_dir: str,
        trange,
        lgrange,
        specrange,
        data_window,
        resolution,
        use_native: bool = True,
    ) -> "SpectralGrid":
        """Load a BT-Settl directory (``lte{T/100}-{logg}-0.0a+0.0...spec.7.txt``).

        File discovery and (T, logg) parsing as in ``mft6.py:323-340``; the
        windowed two-column ASCII read (``specrange +- 100 A``,
        ``mft6.py:353-357``) is delegated to the native C++ loader when built.
        """
        files = sorted(glob(os.path.join(grid_dir, "lte*")))
        lo = min(specrange) - 100.0
        hi = max(specrange) + 100.0

        def parse_key(path):
            m = _BTSETTL_RE.search(os.path.basename(path))
            if not m:
                return None
            return float(m.group("t")) * 1e2, float(m.group("g"))

        selected = []
        for path in files:
            key = parse_key(path)
            if key is None:
                continue
            t, g = key
            if min(trange) <= t <= max(trange) and min(lgrange) <= g <= max(lgrange):
                selected.append((t, g, path))
        if not selected:
            raise FileNotFoundError(f"no BT-Settl spectra in range under {grid_dir}")

        reader = None
        if use_native:
            from mcmc_spec_tpu.runtime import native_loader

            reader = native_loader.maybe_reader()

        def entries():
            for t, g, path in selected:
                if reader is not None:
                    swl, sflux = reader.read_two_columns(path, lo, hi)
                else:
                    swl, sflux = _read_two_columns_py(path, lo, hi)
                yield t, g, swl, sflux

        return cls.from_spectra(entries(), specrange, data_window, resolution)

    @classmethod
    def from_phoenix_hires_dir(
        cls,
        grid_dir: str,
        trange,
        lgrange,
        specrange,
        data_window,
        resolution,
        npix: int = 3,
    ) -> "SpectralGrid":
        """PHOENIX HiRes branch: shared wavelength file + per-resel decimation.

        Mirrors ``mft6.py:259-321``: flux files hold one value per line on the
        shared ``WAVE_PHOENIX...`` grid, windowed to ``specrange``, downsampled
        to ``npix`` pixels per resolution element, and divided by 1e8
        (erg/s/cm^2/cm -> per Angstrom, ``mft6.py:487-504``).
        """
        from mcmc_spec_tpu.ops.broaden import redres
        from mcmc_spec_tpu.runtime import native_loader

        # batch-threaded native reads; per-file throughput matches numpy's
        # fast single-column parser, the win is one thread per file on
        # multi-core hosts (the reference reads these serially, mft6.py:271)
        reader = native_loader.maybe_reader()
        if reader is not None and not getattr(reader, "_has_single", False):
            reader = None  # stale pre-built .so

        def load_column(path):
            if reader is not None:
                return reader.read_single_column(path)
            return np.loadtxt(path)

        wave_file = os.path.join(grid_dir, "WAVE_PHOENIX-ACES-AGSS-COND-2011.fits.txt")
        spwave = load_column(wave_file)
        idx = (spwave >= min(specrange)) & (spwave <= max(specrange))
        spwave = spwave[idx]

        pat = re.compile(r"lte(?P<t>\d{5})-(?P<g>[\d.]+)0?-")
        selected = []
        for path in sorted(glob(os.path.join(grid_dir, "lte*txt"))):
            m = pat.search(os.path.basename(path))
            if not m:
                continue
            t, g = float(m.group("t")), float(m.group("g"))
            if not (min(trange) <= t <= max(trange) and min(lgrange) <= g <= max(lgrange)):
                continue
            selected.append((t, g, path))

        if reader is not None and selected:
            fluxes = reader.read_many_single([p for _, _, p in selected])
        else:
            fluxes = [np.loadtxt(p) for _, _, p in selected]

        entries = []
        for (t, g, _path), raw in zip(selected, fluxes):
            sflux = raw[: len(idx)][idx] / 1e8
            wl, f = spwave, sflux
            res_element = np.mean(spwave) / resolution
            spacing = spwave[1] - spwave[0]
            if npix * spacing < res_element:
                factor = (res_element / spacing) / npix
                wl, f = redres(spwave, sflux, factor)
            entries.append((t, g, wl, f))
        if not entries:
            raise FileNotFoundError(f"no PHOENIX spectra in range under {grid_dir}")
        step = float(entries[0][2][1] - entries[0][2][0])
        return cls.from_spectra(entries, specrange, data_window, resolution, step=step)

    # ------------------------------------------------------------------- io
    def save_npz(self, path: str):
        np.savez_compressed(path, temps=self.temps, loggs=self.loggs, wl=self.wl, flux=self.flux)

    @classmethod
    def from_npz(cls, path: str) -> "SpectralGrid":
        z = np.load(path)
        return cls(temps=z["temps"], loggs=z["loggs"], wl=z["wl"], flux=z["flux"])

    # ------------------------------------------------------------- interp
    def interp_spectrum(self, teff: float, logg: float) -> np.ndarray:
        """Host-side bilinear spectrum at (teff, logg) — ``get_spec`` analogue.

        Pure numpy BY DESIGN (a numpy mirror of ``ops.interp``'s
        ``bilinear_bracket``/``bilinear_gather_blend`` semantics, pinned by
        tests/test_models.py): a jnp implementation re-uploads the ENTIRE
        flux cube per call, which once made the 100-draw ``all_spec``
        report loop most of a production fit's wall time (200 x tens-of-MB
        device transfers for a host-side plot).  Report paths call this in
        per-draw loops; it must never touch the device.
        """
        def bracket(axis_vals, q):
            axis_vals = np.asarray(axis_vals)
            i = int(np.clip(np.searchsorted(axis_vals, q, side="right") - 1,
                            0, axis_vals.shape[0] - 2))
            lo, hi = axis_vals[i], axis_vals[i + 1]
            return i, (q - lo) / (hi - lo)

        ti, tw = bracket(self.temps, teff)
        gi, gw = bracket(self.loggs, logg)
        flux = np.asarray(self.flux)
        f0 = flux[ti, gi] * (1.0 - gw) + flux[ti, gi + 1] * gw
        f1 = flux[ti + 1, gi] * (1.0 - gw) + flux[ti + 1, gi + 1] * gw
        return f0 * (1.0 - tw) + f1 * tw


def _read_two_columns_py(path: str, lo: float, hi: float):
    """Pure-python windowed two-column ASCII read (native-loader fallback)."""
    wls, fluxes = [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            try:
                w = float(parts[0])
            except ValueError:
                continue
            if lo <= w <= hi:
                wls.append(w)
                fluxes.append(float(parts[1]))
    return np.asarray(wls), np.asarray(fluxes)
