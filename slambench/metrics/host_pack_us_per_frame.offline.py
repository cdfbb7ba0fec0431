"""host_pack_us_per_frame.offline: the program's span rgbid.pack, summed over the
untraced window's flights (harness/flights.py), per frame of the window:
pack_frame (tracking/step.py): the gray and depth codec in host numpy."""

from harness.flights import span_us_per_frame


def read(ctx):
    return span_us_per_frame(ctx, "pack")
