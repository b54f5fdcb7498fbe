"""State carried across from the JAX package.

`state_from_jax` turns the JAX package's tracking state, handed over as
numpy arrays (np.asarray of its jax arrays) and its config objects, into
the port's tensors and config objects on a given device, so both packages
can compute on the same local map. `map_store_from_jax` copies a JAX
MapStore (host numpy state) into the port's, so both trackers can start
from one map. `ba_problem_from_jax` and `pose_graph_problem_from_jax`
hand a JAX solver's problem to the port's solver. Nothing here imports
jax: objects are read by field name.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .geometry.camera import PinholeCamera
from .utils.config import OrbConfig, SlamConfig


class TrackingState(NamedTuple):
    Tcw: torch.Tensor        # (4, 4) float32 world -> camera pose
    packed: torch.Tensor     # (P, 8) float32 [pos(3), normal(3), min_d, max_d]
    mp_desc: torch.Tensor    # (P, 8) int32 bit-view of the uint32 descriptors
    mp_valid: torch.Tensor   # (P,) bool
    orb: OrbConfig
    cam: PinholeCamera


def desc_to_torch(desc, device="cuda"):
    """(..., 8) uint32 descriptor words -> int32 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(desc, dtype=np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def desc_to_numpy(desc):
    """int32 descriptor tensor -> (..., 8) uint32 numpy array, same bits."""
    return desc.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def config_from_jax(orb, cam):
    """The JAX package's OrbConfig / PinholeCamera -> the port's, field by field."""
    orb_t = OrbConfig(**{f: getattr(orb, f) for f in OrbConfig.__dataclass_fields__})
    cam_t = PinholeCamera(**{f: getattr(cam, f) for f in PinholeCamera._fields})
    return orb_t, cam_t


def state_from_jax(Tcw, packed, mp_desc, mp_valid, orb, cam, device="cuda") -> TrackingState:
    """Numpy arrays of the JAX package's pose and local-map pad (as
    frontend/device_map.py packs it) plus its configs -> TrackingState."""
    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    packed = f32(packed)
    if packed.dim() != 2 or packed.shape[1] != 8:
        raise ValueError(f"packed local map must be (P, 8), got {tuple(packed.shape)}")
    orb_t, cam_t = config_from_jax(orb, cam)
    return TrackingState(
        Tcw=f32(Tcw), packed=packed, mp_desc=desc_to_torch(mp_desc, device),
        mp_valid=torch.from_numpy(np.array(mp_valid, dtype=bool)).to(device),
        orb=orb_t, cam=cam_t)


def slam_config_from_jax(cfg) -> SlamConfig:
    """The JAX package's SlamConfig -> the port's, field by field."""
    orb, cam = config_from_jax(cfg.orb, cfg.camera)
    fields = {f: getattr(cfg, f) for f in SlamConfig.__dataclass_fields__}
    return SlamConfig(**{**fields, "orb": orb, "camera": cam})


def map_store_from_jax(ms):
    """A JAX MapStore -> the port's MapStore holding copies of all its
    state: every array, counter, free list and loop edge."""
    from .state.map_store import MapStore   # state/ imports this module
    out = MapStore(slam_config_from_jax(ms.config))
    for name, v in vars(ms).items():
        if name == "config":
            continue
        if isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, (list, set, dict)):
            v = type(v)(v)
        setattr(out, name, v)
    return out


def vocabulary_from_jax(voc, device="cuda"):
    """A JAX BinaryVocabulary or TreeVocabulary -> the port's, holding
    copies of its arrays."""
    from .place.vocabulary import BinaryVocabulary
    from .place.vocabulary_tree import TreeVocabulary
    if hasattr(voc, "node_desc"):
        return TreeVocabulary(voc.k, voc.L, voc.node_desc.copy(), voc.node_children.copy(),
                              voc.node_parent.copy(), voc.node_word.copy(),
                              voc.word_weight.copy(), voc.word_node.copy())
    return BinaryVocabulary(voc.words.copy(), voc.idf.copy(), device)


def kf_database_from_jax(db, voc):
    """A JAX KeyFrameDatabase -> the port's over `voc` (the port's
    vocabulary), holding copies of its bags and inverted index."""
    from .place.kf_database import KeyFrameDatabase
    out = KeyFrameDatabase(voc, db.KF_CAP, db.W_CAP)
    for name in ("kf_words", "kf_weights", "kf_n_words", "active"):
        setattr(out, name, getattr(db, name).copy())
    out.inv = {w: list(lst) for w, lst in db.inv.items()}
    return out


def ba_problem_from_jax(prob, device="cuda"):
    """A JAX BAProblem (its fields as arrays) -> the port's on `device`."""
    from .optim.local_ba import BAProblem
    return BAProblem(**{f: torch.from_numpy(np.array(getattr(prob, f))).to(device)
                        for f in BAProblem._fields})


def pose_graph_problem_from_jax(prob):
    """A JAX PoseGraphProblem -> the port's, as numpy arrays (the port's
    optimize_pose_graph prepares a problem on the host)."""
    from .optim.pose_graph import PoseGraphProblem
    return PoseGraphProblem(**{f: np.array(getattr(prob, f)) for f in PoseGraphProblem._fields})
