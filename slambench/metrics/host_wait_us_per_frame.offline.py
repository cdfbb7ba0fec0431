"""host_wait_us_per_frame.offline: the program's span rgbid.wait, summed over the
untraced window's flights (harness/flights.py), per frame of the window:
the flight's one read in SlamSystem._drain (ProcessFrame.read): the host blocked on the
card, and the copy back."""

from harness.flights import span_us_per_frame


def read(ctx):
    return span_us_per_frame(ctx, "wait")
