"""Device compute ops: image planes, warping and sampling, the Gauss-Newton
evaluations (plain PyTorch), and the wrappers of the hand CUDA kernels
(``kernels.py``, built by ``_build.py`` at first launch)."""

from . import gauss_newton, image, warp  # noqa: F401
