"""The NVIDIA H100 SXM's published peaks (data sheet, dense, at 700 W).

A card set below 700 W runs below them: every run prints its card's
``power.limit`` beside the shares computed against these.
"""

PEAK_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores (TF32 off)
PEAK_BF16 = 989e12  # FLOP/s, bfloat16 on the tensor cores
# FLOP/s, float32 products on the tensor cores to float32's precision: each
# as six bfloat16 part products (or three TF32 ones at half bfloat16's rate)
PEAK_FP32_SPLIT = PEAK_BF16 / 6
PEAK_BYTES = 3.35e12  # bytes/s, HBM3
# exponentials on the special-function units: 16 an SM a clock, 132 SMs,
# at the 1.98 GHz boost clock (an assumed clock: the card may run lower)
PEAK_EXP = 16 * 132 * 1.98e9


def peak_flops(dtype: str) -> float:
    """The peak of a configuration's compute dtype."""
    return PEAK_BF16 if dtype == "bfloat16" else PEAK_FP32
