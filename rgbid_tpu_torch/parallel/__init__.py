"""Several ranks on ``torch.distributed``: the JAX package's multi-chip axes.

Counterpart of ``rgbid_tpu/parallel/__init__.py``. The same two axes:

* **Pairs of the relocalization scorer** (``reloc.py``): each rank scores
  its share of the candidate pairs with its own ``RelocScorer``; the
  results are gathered in pair order.
* **Keyframe rows inside the tracker** (``tracker_spmd.py``): each rank
  holds a row band of every keyframe level and the whole current frame;
  every IRLS iteration all-reduces its ~49 floats of normal-equation
  statistics and every rank solves the same 6x6 system
  (``tracking/tracker.py``, ``ops/kernels.py::irls_solve_step``).
  ``spmd.py`` (``SpmdTracker``) is the JAX package's single-level IC form
  of the same axis: the Student-t scale's sums are all-reduced before any
  pixel is weighted, then the normal equations, then the same solve.

The JAX package runs these in one process over a ``jax.sharding.Mesh``;
here each rank is a process (``launch.py::run_ranks``), the mesh is a 1-D
``DeviceMesh`` over the process group (``mesh.py``), gloo carries the
collectives on the CPU and for ranks that share one card, NCCL for one
rank per card.
"""

from .mesh import make_mesh  # noqa: F401
from .reloc import shard_reloc_batch  # noqa: F401
from .spmd import SpmdTracker  # noqa: F401
from .tracker_spmd import ShardedTracker  # noqa: F401
