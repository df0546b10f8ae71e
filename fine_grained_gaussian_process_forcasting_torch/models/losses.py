"""Loss utilities (counterpart of the JAX package's ``models/losses.py``)."""

from __future__ import annotations

import torch


def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL( N(mean1, e^logvar1) || N(mean2, e^logvar2) ), elementwise."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))
