"""Run a function on several ranks: the port's counterpart of the JAX
package's in-process device mesh.

    results = run_ranks(fn, 4, "gloo", "cpu", *args)

``fn(rank, world_size, device, *args)`` runs in ``world_size`` processes
started with the ``spawn`` method (a process that has touched CUDA must not
fork), each with the default process group initialised through a
``FileStore`` in a fresh temporary directory (no port to collide on), one
CPU thread (``torch.set_num_threads(1)``), and ``device``: "cpu", a card
("cuda:0": every rank on that card, as gloo allows), or "cuda" (rank r on
card r, as NCCL needs). It returns the ranks' return values in rank order,
their tensors moved to the CPU. If a rank raises, the others are ended and
the rank's exception is raised in the caller, its traceback in the
message (as a ``RankError`` if the exception does not pickle). ``fn``
must be a module-level function of a module the ranks can import without
side effects.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# A collective that waits longer than this fails the rank (a peer died).
COLLECTIVE_TIMEOUT_S = 600


class RankError(RuntimeError):
    """A rank raised; the message holds its traceback."""


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _rank_device(device: str, rank: int) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank)
    return dev


def _record_error(out_path: str, e: BaseException) -> None:
    try:
        exc = pickle.loads(pickle.dumps(e))
    except Exception:
        exc = None
    with open(out_path, "wb") as f:
        pickle.dump(("error", (exc, traceback.format_exc())), f)


def _worker(rank, fn, world_size, backend, device, work, args):
    out_path = os.path.join(work, f"rank{rank}.pkl")
    try:
        torch.set_num_threads(1)
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(work, "store"), world_size)
        # NCCL binds the rank's card at once (gloo takes the tensor's device).
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
                                device_id=dev if backend == "nccl" else None)
    except BaseException as e:
        _record_error(out_path, e)
        raise
    try:
        # The error is on file before this rank leaves the group, which
        # is what makes its peers fail: the first file names the cause.
        result = _to_cpu(fn(rank, world_size, dev, *args))
    except BaseException as e:
        _record_error(out_path, e)
        raise
    finally:
        dist.destroy_process_group()
    with open(out_path, "wb") as f:
        pickle.dump(("ok", result), f)


def run_ranks(fn, world_size: int, backend: str, device: str, *args):
    """Results of ``fn`` on each rank, in rank order (see the module
    docstring)."""
    work = tempfile.mkdtemp(prefix="rgbid_ranks_")
    try:
        try:
            mp.start_processes(_worker, args=(fn, world_size, backend, device, work, args),
                               nprocs=world_size, join=True, start_method="spawn")
        except Exception as e:
            # The rank that failed first wrote its file first; the others may
            # only have lost their peer.
            failed = []
            for r in range(world_size):
                p = os.path.join(work, f"rank{r}.pkl")
                if os.path.exists(p):
                    with open(p, "rb") as f:
                        status, payload = pickle.load(f)
                    if status == "error":
                        failed.append((os.stat(p).st_mtime_ns, r, payload))
            if failed:
                _, r, (exc, tb) = min(failed, key=lambda x: x[:2])
                if exc is None:
                    raise RankError(f"rank {r}:\n{tb}") from e
                exc.add_note(f"raised on rank {r} of {world_size}:\n{tb}")
                raise exc from e
            raise RankError(str(e)) from e
        results = []
        for r in range(world_size):
            with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
                status, payload = pickle.load(f)
            results.append(payload)
        return results
    finally:
        shutil.rmtree(work, ignore_errors=True)
