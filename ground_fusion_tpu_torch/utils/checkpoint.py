"""Checkpoint / resume for the estimator core and the pose graph.

The reference checkpoints only the pose graph (keyframes + BRIEF descriptors +
loop edges, ``pose_graph.cpp:1062-1267`` save/load on keypress, config
``load_previous_pose_graph``); the VIO window state dies with the process.
Here BOTH are serializable npz archives: the window ``EstimatorCore`` (so a
restart resumes from the checkpoint rather than re-initializing cold) and the
keyframe graph.

The files use the JAX package's key scheme, so either package loads what the
other wrote: a core leaf is stored under its dotted field path
(``state.poses``, ``tracks.obs_valid``), an absent table (``None``) as an
empty array under ``<path>.__none__``, and the graph's keyframe fields as
``kf<k>.<field>``. Archives are plain arrays, loaded with
``allow_pickle=False``."""

from __future__ import annotations

import numpy as np
import torch


def _flatten(tree, prefix, out):
    if hasattr(tree, "_fields"):                     # NamedTuple
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{prefix}{name}.", out)
    elif tree is None:
        out[prefix + "__none__"] = np.zeros(0)
    else:
        out[prefix[:-1]] = tree.detach().cpu().numpy()


def core_to_arrays(core, prefix: str = "") -> dict:
    """A core (any NamedTuple tree of tensors, ``None`` for an absent
    table) → ``{dotted path: numpy array}`` in the archive's key scheme."""
    out: dict = {}
    _flatten(core, prefix, out)
    return out


def core_from_arrays(data, template, prefix: str = ""):
    """Rebuild a core with ``template``'s structure, taking each leaf's
    dtype and device from the template's leaf. ``data`` maps dotted paths
    (after ``prefix``) to arrays."""
    def rebuild(tmpl, path):
        if hasattr(tmpl, "_fields"):
            return type(tmpl)(*[rebuild(getattr(tmpl, n), f"{path}{n}.") for n in tmpl._fields])
        if tmpl is None:
            return None
        return torch.as_tensor(np.array(data[prefix + path[:-1]])).to(
            dtype=tmpl.dtype, device=tmpl.device)

    return rebuild(template, "")


def save_core(path: str, core) -> None:
    np.savez_compressed(path, **core_to_arrays(core))


def load_core(path: str, template):
    """Rebuild a core with the template's structure, dtypes and device."""
    with np.load(path, allow_pickle=False) as data:
        return core_from_arrays(data, template)


def save_pose_graph(path: str, pg) -> None:
    """Keyframe DB + loop edges + drift (pose_graph.cpp:1062-1126 analog)."""
    out = {
        "n_kf": np.int64(len(pg.kfs)),
        "r_drift": np.asarray(pg.r_drift, np.float64),
        "t_drift": np.asarray(pg.t_drift, np.float64),
        "earliest_loop": np.int64(pg.earliest_loop if pg.earliest_loop is not None else -1),
        "loop_edges_i": np.asarray([e[0] for e in pg.loop_edges], np.int64),
        "loop_edges_j": np.asarray([e[1] for e in pg.loop_edges], np.int64),
        "loop_edges_t": (np.stack([np.asarray(e[2]) for e in pg.loop_edges])
                         if pg.loop_edges else np.zeros((0, 3))),
        "loop_edges_yaw": np.asarray([e[3] for e in pg.loop_edges], np.float64),
        "loop_edges_q": (np.stack([np.asarray(e[4]) if len(e) > 4 else np.array([1.0, 0, 0, 0])
                                   for e in pg.loop_edges])
                         if pg.loop_edges else np.zeros((0, 4))),
    }
    for k, kf in enumerate(pg.kfs):
        for field in kf._fields:
            v = getattr(kf, field)
            if v is None:           # vio_pose unset → fall back to pose
                v = kf.pose
            out[f"kf{k}.{field}"] = np.asarray(v)
    np.savez_compressed(path, **out)


def load_pose_graph(path: str, pg) -> None:
    """Restore into an existing ``PoseGraph``, re-registering every keyframe
    in its database under the keyframe's original index so loop detection
    continues across sessions (pose_graph.cpp:1127-1267
    ``load_previous_pose_graph``). The database tables stay on the graph's
    device. ``index`` comes back an ``int``, ``t`` a ``float``; the arrays
    keep the dtypes they were saved in (``kp_ok`` bool, ``desc`` the
    writer's unsigned words)."""
    from ..global_layers.bow import bow_histogram, words_of
    from ..global_layers.pose_graph import Keyframe

    with np.load(path, allow_pickle=False) as data:
        data = {k: data[k] for k in data.files}
    pg.kfs = []
    for k in range(int(data["n_kf"])):
        fields = {}
        for field in Keyframe._fields:
            key = f"kf{k}.{field}"
            if key not in data:
                continue            # fields added after the save: use default
            v = data[key]
            if field == "index":
                v = int(v)
            elif field == "t":
                v = float(v)
            fields[field] = v
        kf = Keyframe(**fields)
        pg.kfs.append(kf)
        if pg.vocab is not None:
            hist = pg.db.bow_vector(kf.desc, kf.kp_ok)
        else:
            hist = bow_histogram(words_of(pg._upload_desc(kf.desc),
                                          torch.as_tensor(kf.kp_ok, device=pg.device), pg.sel))
        pg.db.add(hist, kf_index=kf.index)
    pg.r_drift = data["r_drift"]
    pg.t_drift = data["t_drift"]
    el = int(data["earliest_loop"])
    pg.earliest_loop = el if el >= 0 else None
    q = data["loop_edges_q"] if "loop_edges_q" in data else \
        np.tile(np.array([1.0, 0, 0, 0]), (len(data["loop_edges_i"]), 1))
    pg.loop_edges = [
        (int(i), int(j), t, float(y), qq)
        for i, j, t, y, qq in zip(data["loop_edges_i"], data["loop_edges_j"],
                                  data["loop_edges_t"], data["loop_edges_yaw"], q)
    ]
