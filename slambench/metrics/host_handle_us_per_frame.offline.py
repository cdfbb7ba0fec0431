"""host_handle_us_per_frame.offline: the program's span rgbid.handle, summed over the
untraced window's flights (harness/flights.py), per frame of the window:
SlamSystem._handle, each frame: unpacking, pose algebra, the records."""

from harness.flights import span_us_per_frame


def read(ctx):
    return span_us_per_frame(ctx, "handle")
