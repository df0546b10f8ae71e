"""Which implementation each attention call of the port takes, by device,
head dim and flag: ``basic_attention_route`` (the ``basic`` attention) and
``conv_attention_route`` (the conv family's final softmax).  A
``torch.device("cuda")`` needs no card to be named."""

import pytest
import torch

from fine_grained_gaussian_process_forcasting_torch.models.transformer import (
    basic_attention_route,
)
from fine_grained_gaussian_process_forcasting_torch.ops.conv_attention import (
    conv_attention_route,
)

D_KS = [4, 63, 64, 72, 127, 128, 256]
FLAGS = {"auto": None, "true": True, "false": False}


def _basic_expected(d_k, flag, is_self):
    """The route the ROADMAP's table gives: auto takes head-folded below 64
    (self and cross), flash for self-attention at 64 <= d_k < 128, else
    plain; True the kernel of that d_k (flash at every d_k >= 64); False
    plain."""
    if flag is False:
        return "plain"
    if flag is None and not (d_k < 128 and (is_self or d_k < 64)):
        return "plain"
    return "flash" if d_k >= 64 else "head_folded"


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("d_k", D_KS)
def test_basic_attention_route_table(d_k, flag):
    cuda = torch.device("cuda")
    for is_self in (True, False):
        got = basic_attention_route(cuda, d_k, is_self, FLAGS[flag])
        assert got == _basic_expected(d_k, FLAGS[flag], is_self), is_self
        # the CPU always takes the plain path
        assert basic_attention_route(torch.device("cpu"), d_k, is_self,
                                     FLAGS[flag]) == "plain"


@pytest.mark.parametrize("flag", list(FLAGS))
@pytest.mark.parametrize("d_k", D_KS)
def test_conv_attention_route_table(d_k, flag):
    """Only an explicit True takes a kernel (``bool(None)`` is False in
    JAX): head-folded up to d_k 63, flash above; never the plain op."""
    use_kernel = bool(FLAGS[flag])
    want = ("plain" if not use_kernel
            else "head_folded" if d_k <= 63 else "flash")
    assert conv_attention_route(d_k, use_kernel) == want
