"""Independent numpy CPU reference implementations: the port's copies of
``rgbid_tpu/reference_cpu/`` (numpy only).

``odometry`` (the forward-compositional tracker and its preprocessing,
which ``SlamSystem._try_relocalize`` uses), ``se3_np`` (host-side SE(3)
helpers) and ``fusion`` (the fusion oracle). They favour clarity over
speed and never run on the per-frame path's device work.
"""

from . import fusion, odometry, se3_np  # noqa: F401
