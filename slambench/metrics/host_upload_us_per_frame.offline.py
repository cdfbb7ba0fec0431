"""host_upload_us_per_frame.offline: the program's span rgbid.upload, summed over the
untraced window's flights (harness/flights.py), per frame of the window:
SlamSystem._upload: from_numpy, pin_memory, the host-to-device copy's enqueue."""

from harness.flights import span_us_per_frame


def read(ctx):
    return span_us_per_frame(ctx, "upload")
