"""Device-mesh helpers for multi-chip scaling.

The reference's only parallelism is one OS process per optimizer walker
(``mp.Pool(15)``, ``mft6.py:1744-1753``) and emcee's thread pool; inter-stage
communication is the filesystem (SURVEY.md section 2, parallelism table).
Here the scaling axes are:

* ``walkers`` — the ensemble axis, sharded across chips (pure data parallel;
  the only cross-device communication the stretch move needs is an
  ``all_gather`` of the complement half's coordinates, a few KB).
* ``targets`` — independent KOI systems batched in the same jitted program
  (fleet mode), also data-parallel.

Meshes are built over whatever devices exist — the GPUs of one host, or the
8-device virtual CPU mesh used by the test suite.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def parse_wxs(mesh) -> tuple[int, int] | None:
    """Parse a ``"WxS"`` 2-D mesh string into ``(walkers, spec)`` counts.

    Returns ``None`` when ``mesh`` is not WxS-shaped at all (not a string,
    or not digits-and-'x'), so callers can fall through to the other mesh
    spellings (``"auto"``, a :class:`Mesh`, falsy).  Raises ``ValueError``
    with a usable message for WxS-shaped but malformed strings (``"0x2"``,
    ``"4x"``, ``"2x2x2"``) instead of letting them crash downstream as
    ``ZeroDivisionError`` / ``int()`` tracebacks.  The single parser behind
    ``cli.py --mesh``, ``pipeline.resolve_mesh``, and the fleet-mode
    rejection — validation and parsing cannot disagree.
    """
    if not (isinstance(mesh, str) and "x" in mesh and mesh.replace("x", "").isdigit()):
        return None
    parts = mesh.split("x")
    if len(parts) != 2 or not all(p.isdigit() for p in parts):
        raise ValueError(
            f"mesh must be WxS with two positive integers (e.g. 4x2), got {mesh!r}"
        )
    w, s = int(parts[0]), int(parts[1])
    if w < 1 or s < 1:
        raise ValueError(
            f"mesh {mesh!r}: both walker and spec counts must be >= 1"
        )
    return w, s


def make_mesh(n_devices: int | None = None, axis_names=("walkers",), devices=None) -> Mesh:
    """1-D (or reshaped N-D) mesh over the first ``n_devices`` devices.

    ``devices`` defaults to the default backend's; asking for more than
    there are raises (a caller that wants virtual CPU devices passes
    ``jax.devices("cpu")`` itself).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if len(devices) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devices)}")
    devices = np.asarray(devices[:n_devices])
    if len(axis_names) == 1:
        return Mesh(devices, axis_names)
    # split the device count as evenly as possible across the leading axis
    lead = 1
    for cand in range(int(np.sqrt(n_devices)), 0, -1):
        if n_devices % cand == 0:
            lead = cand
            break
    return Mesh(devices.reshape(lead, n_devices // lead), axis_names)


def walker_sharding(mesh: Mesh, axis: str = "walkers") -> NamedSharding:
    """Sharding that splits the leading (walker) axis across the mesh."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
