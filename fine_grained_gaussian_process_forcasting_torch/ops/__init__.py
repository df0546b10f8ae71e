"""Attention ops and their kernels (counterpart of the JAX package's ``ops/``).

The FEDformer stack's ops are exported here as JAX's ``ops/__init__.py``
exports them, but loaded on first use (PEP 562), so the entry points do not
load them.  ``full_attention`` is not among them: the name is its module's,
which the package attribute becomes once the module is imported; import it
from ``ops.full_attention``.
"""

import importlib

_LAZY = {
    "MyLayerNorm": "decomposition",
    "SeriesDecompMulti": "decomposition",
    "moving_avg": "decomposition",
    "series_decomp": "decomposition",
    "MultiWaveletCross": "wavelet",
    "MultiWaveletTransform": "wavelet",
    "filter_bank": "wavelet_filters",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
