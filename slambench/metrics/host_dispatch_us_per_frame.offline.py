"""host_dispatch_us_per_frame.offline: the program's span rgbid.dispatch, summed over the
untraced window's flights (harness/flights.py), per frame of the window:
SlamSystem._dispatch -> ProcessFrame.__call__: the graph's input copies, its replay,
the counters, the retire ring's copy, the result's clone."""

from harness.flights import span_us_per_frame


def read(ctx):
    return span_us_per_frame(ctx, "dispatch")
