"""Models (counterpart of the JAX package's ``models/``).

The FEDformer stack and the baselines beyond the harness's are exported
here as JAX's ``models/__init__.py`` exports FEDformer, but loaded on first
use (PEP 562), so the serving and training entry points, which import
``models.transformer`` and the rest, do not load them.
"""

import importlib

_LAZY = {
    "FEDformer": "fedformer",
    "FEDformerConfig": "fedformer",
    "DenoiseVAE": "denoise_vae",
    "InformerEncoder": "informer_stack",
    "InformerDecoderLayer": "informer_stack",
    "normal_kl": "losses",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
