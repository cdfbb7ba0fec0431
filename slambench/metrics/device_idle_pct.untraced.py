"""device_idle_pct.untraced: the share of the untraced window in which the
card ran none of the frames' work: 100 x (1 - the busy time of one pair of
CUDA timing events a frame, from before its upload's copy to after its
retire ring's copy, summed over the window's flights / the window's wall
time) (harness/flights.py). None on the CPU."""

from harness.flights import device_idle_pct


def read(ctx):
    return device_idle_pct(ctx)
