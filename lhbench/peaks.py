"""Peaks of the card, for roofline shares.

NVIDIA H100 SXM (the data sheet; dense rates at the 700 W limit): 132 SMs,
HBM3 at 3.35 TB/s, a boost clock of 1,980 MHz.  An SM issues 64 int32
multiply-adds a clock (its four partitions' 16 INT32 lanes each), so the
int32 multiply-add peak is 64 x 132 x the SM clock sampled beside the
window.
"""

SMS = 132
INT32_MAC_PER_SM_PER_CLOCK = 64
HBM_BYTES_PER_S = 3.35e12
#: Used only where the card's clock could not be read beside the window.
BOOST_CLOCK_MHZ = 1980.0


def int32_macs_per_s(sm_clock_mhz: float) -> float:
    return INT32_MAC_PER_SM_PER_CLOCK * SMS * sm_clock_mhz * 1e6
