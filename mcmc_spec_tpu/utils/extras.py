"""Clear failures for the optional extras (``pyproject.toml``).

The fit needs only jax, numpy and scipy; plots and the population analysis
need packages a deployment may lack.  Entry points check before any compute,
so a missing package stops the run at once with a message instead of a
traceback after the fit.
"""
from __future__ import annotations

import importlib.util


def require(module: str, extra: str, hint: str = "") -> None:
    """Raise SystemExit naming the extra when ``module`` is not installed."""
    if importlib.util.find_spec(module) is None:
        more = f" ({hint})" if hint else ""
        raise SystemExit(
            f"{module} is not installed: install the '{extra}' extra "
            f"(pip install .[{extra}]){more}")
