"""Full-state snapshot / resume, in the JAX package's npz format v3.

The port's counterpart of ``rgbid_tpu/utils/snapshot.py``. ``save`` writes
the active device keyframe, the host keyframe records (poses, images,
clouds, reloc planes, descriptors), the odometry and loop edges, the
motion model, the trajectory and the configuration into one ``.npz``;
``restore`` builds a ``SlamSystem`` that goes on tracking. The layout and
keys are the JAX package's, so one file moves between the packages in
either direction:

- ``meta_json``: version, config, config hash, intrinsics, frame count,
  per-frame records, keyframe count, odometry and loop edge ids;
- ``T_ck``, ``delta``, ``lost_count`` (float32) and ``cons_excluded``
  (the consensus streaks; a host array in the port);
- ``traj_t``, ``traj_T``; ``edge_<i>_T`` / ``_info``; ``ledge_<i>_T`` /
  ``_info``; ``kf_<id>_T_wk``, ``_ts``, ``_rgb``, ``_cloud``, ``_desc``,
  ``_kpts``, ``_rp_<plane>``;
- ``kfstate_<i>``: the active ``DeviceKeyframe`` as the leaves of the JAX
  package's pytree in its flatten order (``KF_STATE_FIELDS``): per level
  intensity, xi, mask, jac, then var, fused_count (an int32 scalar), hits,
  mask_full. The JAX package stores its bfloat16 leaves (the template
  Jacobians) as float32; the port holds those planes as float32 already
  rounded to bfloat16 values, so a round trip is exact either way.

As in the JAX package, the format does not carry the lost-frame count,
the relocalized flag or the episode flag of the interval since the last
switch (``_lost_count``, ``_relocalized``, ``_episode_since_switch``): a
run saved while lost or inside a consensus episode resumes with them
cleared.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, List

import numpy as np
import torch

if TYPE_CHECKING:
    from ..system import SlamSystem

FORMAT_VERSION = 3

# The fields of one template level, then of the keyframe, in the flatten
# order of the JAX package's DeviceKeyframe pytree (NamedTuples flatten
# field by field, depth first).
LEVEL_FIELDS = ("intensity", "xi", "mask", "jac")
KF_STATE_FIELDS = ("var", "fused_count", "hits", "mask_full")


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()


def kf_state_leaves(state) -> List[np.ndarray]:
    """The port's DeviceKeyframe as the JAX pytree's leaves (numpy)."""
    leaves = []
    for level in state.levels:
        leaves += [_numpy(getattr(level, f)) for f in LEVEL_FIELDS]
    return leaves + [_numpy(state.var), _numpy(state.fused_count).astype(np.int32),
                     _numpy(state.hits), _numpy(state.mask_full)]


def kf_state_from_leaves(leaves, device):
    """Leaves in the JAX pytree's order -> the port's DeviceKeyframe."""
    from ..mapping.keyframe import DeviceKeyframe
    from ..tracking.frames import KeyframeLevel

    def dev(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    n = len(LEVEL_FIELDS)
    n_levels, rest = divmod(len(leaves) - len(KF_STATE_FIELDS), n)
    if rest or n_levels < 1:
        raise ValueError(f"{len(leaves)} keyframe-state leaves do not make whole levels")
    levels = tuple(KeyframeLevel(*(dev(x) for x in leaves[n * l:n * (l + 1)]))
                   for l in range(n_levels))
    var, count, hits, mask_full = leaves[n * n_levels:]
    fused = torch.from_numpy(np.asarray(count, np.int32).reshape(())).to(device)
    return DeviceKeyframe(levels=levels, var=dev(var), fused_count=fused,
                          hits=dev(hits), mask_full=dev(mask_full))


def _json_default(x):
    """numpy scalars and arrays in the per-frame records as JSON values."""
    if isinstance(x, (np.generic, np.ndarray)):
        return x.tolist()
    raise TypeError(f"{type(x).__name__} is not JSON serializable")


def save(system: "SlamSystem", path: str) -> None:
    arrays = {}
    meta = {
        "version": FORMAT_VERSION,
        "config": system.config.to_dict(),
        "config_hash": system.config.config_hash(),
        "intrinsics": list(system.intr),
        "frame_count": system._frame_count,
        "stats": system.stats,
        "n_keyframes": len(system.manager.keyframes),
        "edges": [
            {"from_id": e.from_id, "to_id": e.to_id, "episode": e.episode}
            for e in system.manager.edges
        ],
    }
    # Accepted loop edges: without them a resumed run would drop every
    # loop constraint found before the snapshot from later optimizations.
    loop_edges = list(system.backend._loop_edges) if system.backend is not None else []
    meta["loop_edges"] = [{"from_id": e["from_id"], "to_id": e["to_id"]} for e in loop_edges]
    for i, e in enumerate(loop_edges):
        arrays[f"ledge_{i}_T"] = np.asarray(e["T_rel"])
        arrays[f"ledge_{i}_info"] = np.asarray(e["information"])
    # The motion model (a bit-exact resume of the constant-velocity model).
    if system._motion is not None:
        arrays["T_ck"] = _numpy(system._motion.T_ck)
        arrays["delta"] = _numpy(system._motion.delta)
        arrays["lost_count"] = _numpy(system._motion.lost_count)
        if system._motion.cons_excluded is not None:
            arrays["cons_excluded"] = _numpy(system._motion.cons_excluded)
    arrays["traj_t"] = np.asarray([t for t, _ in system._trajectory])
    arrays["traj_T"] = (np.stack([T for _, T in system._trajectory]) if system._trajectory
                        else np.zeros((0, 4, 4)))
    for i, e in enumerate(system.manager.edges):
        arrays[f"edge_{i}_T"] = e.T_rel
        arrays[f"edge_{i}_info"] = e.information
    for kf in system.manager.keyframes:
        p = f"kf_{kf.kf_id}_"
        arrays[p + "T_wk"] = kf.T_wk
        arrays[p + "ts"] = np.asarray(kf.timestamp)
        if kf.rgb is not None:
            arrays[p + "rgb"] = kf.rgb
        if kf.cloud is not None:
            arrays[p + "cloud"] = kf.cloud
        if kf.descriptors is not None:
            arrays[p + "desc"] = kf.descriptors
            arrays[p + "kpts"] = kf.keypoints
        if kf.reloc_planes is not None:
            for k, v in kf.reloc_planes.items():
                arrays[p + "rp_" + k] = v
    if system._kf_state is not None:
        leaves = kf_state_leaves(system._kf_state)
        meta["kf_state_n_leaves"] = len(leaves)
        for i, leaf in enumerate(leaves):
            arrays[f"kfstate_{i}"] = leaf
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta, default=_json_default).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def restore(path: str, config=None, device="cuda") -> "SlamSystem":
    """A ``SlamSystem`` on ``device`` in the state ``path`` holds, under
    ``config`` (default: the configuration the file holds). With a back end
    the loop edges go back into the optimizer's input, every keyframe's
    descriptors back into the BoW database, and those keyframes are marked
    processed, so that keyframes from before the snapshot stay matchable."""
    from ..core.camera import Intrinsics
    from ..core.config import SlamConfig
    from ..mapping.keyframe import Keyframe, retire_shapes
    from ..mapping.manager import OdometryEdge
    from ..system import SlamSystem
    from ..tracking.step import MotionState

    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["meta_json"].tobytes()).decode())
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"snapshot version {meta['version']} != {FORMAT_VERSION}")
    intr = Intrinsics(*meta["intrinsics"])
    cfg = config or SlamConfig.from_json(json.dumps(meta["config"]))
    system = SlamSystem(intr, cfg, device=device)
    dev = system.device

    def t32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(dev)

    system._frame_count = meta["frame_count"]
    system.stats = meta["stats"]
    if "T_ck" in z:
        bins = cfg.tracking.consensus_bins
        system._motion = MotionState(
            T_ck=t32(z["T_ck"]),
            delta=t32(z["delta"]),
            lost_count=t32(z["lost_count"]).reshape(()),
            cons_excluded=t32(z["cons_excluded"] if "cons_excluded" in z
                              else np.zeros((bins,), np.float32)),
        )
    system._trajectory = [(float(t), T) for t, T in zip(z["traj_t"], z["traj_T"])]
    for i in range(meta["n_keyframes"]):
        p = f"kf_{i}_"
        kf = Keyframe(i, float(z[p + "ts"]), z[p + "T_wk"], z[p + "rgb"] if p + "rgb" in z else None)
        if p + "cloud" in z:
            kf.cloud = z[p + "cloud"]
        if p + "desc" in z:
            kf.descriptors = z[p + "desc"]
            kf.keypoints = z[p + "kpts"]
        rp = {k[len(p + "rp_"):]: z[k] for k in z.files if k.startswith(p + "rp_")}
        if rp:
            kf.reloc_planes = rp
        system.manager.keyframes.append(kf)
    for i, e in enumerate(meta["edges"]):
        system.manager.edges.append(
            OdometryEdge(e["from_id"], e["to_id"], z[f"edge_{i}_T"], z[f"edge_{i}_info"],
                         e.get("episode", False)))
    if system.backend is not None:
        for i, e in enumerate(meta.get("loop_edges", [])):
            system.backend._loop_edges.append({
                "from_id": e["from_id"],
                "to_id": e["to_id"],
                "T_rel": z[f"ledge_{i}_T"],
                "information": z[f"ledge_{i}_info"],
            })
        lc = system.backend.loop_closer
        for kf in system.manager.keyframes:
            if kf.descriptors is not None and len(kf.descriptors) > 0:
                with lc.db_lock:
                    lc.db.insert(kf.kf_id, kf.descriptors)
                    kf.bow = dict(lc.db.entries.get(kf.kf_id, {}))
                system.backend._processed.add(kf.kf_id)
    if "kf_state_n_leaves" in meta:
        leaves = [z[f"kfstate_{i}"] for i in range(meta["kf_state_n_leaves"])]
        system._kf_state = kf_state_from_leaves(leaves, dev)
        system.manager.set_shapes(retire_shapes(system._kf_state, system.manager.reloc_level,
                                                system.manager.cloud_stride))
    return system
