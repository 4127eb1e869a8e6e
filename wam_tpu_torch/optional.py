"""Optional dependencies: PIL, matplotlib and h5py are imported inside the
functions that use them, so ``import wam_tpu_torch`` needs none of them."""

from __future__ import annotations

import importlib

__all__ = ["require"]


def require(module: str, what: str):
    """Import ``module`` for ``what``, or raise an ImportError that names the
    missing package."""
    try:
        return importlib.import_module(module)
    except ImportError as err:
        package = module.split(".")[0]
        raise ImportError(f"{what} needs {package}, which is not installed") from err
