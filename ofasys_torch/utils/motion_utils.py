"""Motion/BVH math, numpy on the host (counterpart of
ofasys_tpu/utils/motion_utils.py, the same operations in the same order, so
the features are bit for bit the same).

BVH mocap files <-> continuous 6D-rotation features (Zhou et al.'s
continuous rotation representation): parse hierarchy + frames, euler ->
rotation matrices -> 6D features (+ root translation), inverse path with
Gram-Schmidt orthonormalization, and forward kinematics for joint positions.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

import numpy as np


# ------------------------------------------------------------- rotations
def euler_to_rotmat(angles_deg: np.ndarray, order: str) -> np.ndarray:
    """(..., 3) euler degrees with channel order like 'ZXY' -> (..., 3, 3)."""
    a = np.deg2rad(angles_deg)
    out = np.broadcast_to(np.eye(3), a.shape[:-1] + (3, 3)).copy()
    axes = {"X": 0, "Y": 1, "Z": 2}
    for i, ch in enumerate(order):
        ax = axes[ch]
        c, s = np.cos(a[..., i]), np.sin(a[..., i])
        R = np.zeros(a.shape[:-1] + (3, 3))
        if ax == 0:
            R[..., 0, 0] = 1; R[..., 1, 1] = c; R[..., 1, 2] = -s; R[..., 2, 1] = s; R[..., 2, 2] = c
        elif ax == 1:
            R[..., 1, 1] = 1; R[..., 0, 0] = c; R[..., 0, 2] = s; R[..., 2, 0] = -s; R[..., 2, 2] = c
        else:
            R[..., 2, 2] = 1; R[..., 0, 0] = c; R[..., 0, 1] = -s; R[..., 1, 0] = s; R[..., 1, 1] = c
        out = out @ R
    return out


def rotmat_to_euler(R: np.ndarray, order: str = "ZXY") -> np.ndarray:
    """(..., 3, 3) -> (..., 3) euler degrees in the given intrinsic order.
    Implemented for the common BVH orders via per-order closed forms."""
    if order == "ZXY":
        x = np.arcsin(np.clip(R[..., 2, 1], -1, 1))
        z = np.arctan2(-R[..., 0, 1], R[..., 1, 1])
        y = np.arctan2(-R[..., 2, 0], R[..., 2, 2])
        ang = np.stack([z, x, y], axis=-1)
    elif order == "ZYX":
        y = np.arcsin(np.clip(-R[..., 2, 0], -1, 1))
        z = np.arctan2(R[..., 1, 0], R[..., 0, 0])
        x = np.arctan2(R[..., 2, 1], R[..., 2, 2])
        ang = np.stack([z, y, x], axis=-1)
    elif order == "XYZ":
        y = np.arcsin(np.clip(R[..., 0, 2], -1, 1))
        x = np.arctan2(-R[..., 1, 2], R[..., 2, 2])
        z = np.arctan2(-R[..., 0, 1], R[..., 0, 0])
        ang = np.stack([x, y, z], axis=-1)
    else:
        raise ValueError(f"unsupported euler order {order!r}")
    return np.rad2deg(ang)


def rotmat_to_rot6d(R: np.ndarray) -> np.ndarray:
    """(..., 3, 3) -> (..., 6): first two COLUMNS of R."""
    return np.concatenate([R[..., :, 0], R[..., :, 1]], axis=-1)


def rot6d_to_rotmat(d6: np.ndarray) -> np.ndarray:
    """(..., 6) -> (..., 3, 3) via Gram-Schmidt (always a valid rotation)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / np.maximum(np.linalg.norm(a1, axis=-1, keepdims=True), 1e-8)
    a2p = a2 - (b1 * a2).sum(-1, keepdims=True) * b1
    b2 = a2p / np.maximum(np.linalg.norm(a2p, axis=-1, keepdims=True), 1e-8)
    b3 = np.cross(b1, b2)
    return np.stack([b1, b2, b3], axis=-1)


# ------------------------------------------------------------------- BVH
@dataclasses.dataclass
class BvhJoint:
    name: str
    offset: np.ndarray
    channels: List[str]
    parent: int            # -1 for root
    children: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BvhHeader:
    joints: List[BvhJoint]
    frame_time: float = 1.0 / 30.0

    @property
    def num_joints(self):
        return len(self.joints)

    def rot_order(self, j: int) -> str:
        return "".join(c[0].upper() for c in self.joints[j].channels if c.lower().endswith("rotation"))


def parse_bvh(text: str) -> Tuple[BvhHeader, np.ndarray]:
    """BVH text -> (header, frames (T, total_channels))."""
    toks = text.replace("{", " { ").replace("}", " } ").split()
    i = 0
    joints: List[BvhJoint] = []
    stack: List[int] = []

    def expect(t):
        nonlocal i
        assert toks[i].upper() == t, (toks[i], t)
        i += 1

    expect("HIERARCHY")
    while toks[i].upper() != "MOTION":
        tk = toks[i].upper()
        if tk in ("ROOT", "JOINT"):
            name = toks[i + 1]
            i += 2
            expect("{")
            joints.append(BvhJoint(name, np.zeros(3), [], stack[-1] if stack else -1))
            if stack:
                joints[stack[-1]].children.append(len(joints) - 1)
            stack.append(len(joints) - 1)
        elif tk == "OFFSET":
            joints[stack[-1]].offset = np.asarray([float(toks[i + 1]), float(toks[i + 2]), float(toks[i + 3])])
            i += 4
        elif tk == "CHANNELS":
            n = int(toks[i + 1])
            joints[stack[-1]].channels = toks[i + 2:i + 2 + n]
            i += 2 + n
        elif tk == "END":
            # End Site block: skip entirely
            i += 2
            expect("{")
            depth = 1
            while depth:
                if toks[i] == "{":
                    depth += 1
                elif toks[i] == "}":
                    depth -= 1
                i += 1
        elif tk == "}":
            stack.pop()
            i += 1
        else:
            i += 1
    expect("MOTION")
    assert toks[i].upper() == "FRAMES:" or toks[i].upper() == "FRAMES"
    i += 1 if toks[i].upper() == "FRAMES:" else 2
    n_frames = int(toks[i]); i += 1
    # "Frame Time: x"
    while not re.match(r"^[-\d.]+$", toks[i]):
        i += 1
    frame_time = float(toks[i]); i += 1
    vals = np.asarray([float(t) for t in toks[i:]], np.float64)
    total_ch = sum(len(j.channels) for j in joints)
    frames = vals[: n_frames * total_ch].reshape(n_frames, total_ch)
    return BvhHeader(joints, frame_time), frames


def bvh_to_features(header: BvhHeader, frames: np.ndarray) -> np.ndarray:
    """(T, channels) -> (T, 3 + J*6): root translation + per-joint rot6d."""
    T = frames.shape[0]
    feats = [np.zeros((T, 3))]
    rots = []
    c = 0
    for j, joint in enumerate(header.joints):
        n = len(joint.channels)
        block = frames[:, c:c + n]
        pos_idx = [k for k, ch in enumerate(joint.channels) if ch.lower().endswith("position")]
        rot_idx = [k for k, ch in enumerate(joint.channels) if ch.lower().endswith("rotation")]
        if j == 0 and len(pos_idx) == 3:
            feats[0] = block[:, pos_idx]
        order = header.rot_order(j)
        R = euler_to_rotmat(block[:, rot_idx], order) if rot_idx else \
            np.broadcast_to(np.eye(3), (T, 3, 3))
        rots.append(rotmat_to_rot6d(R))
        c += n
    return np.concatenate(feats + rots, axis=-1).astype(np.float32)


def features_to_bvh(header: BvhHeader, feats: np.ndarray) -> np.ndarray:
    """(T, 3 + J*6) -> (T, channels) frame array for save_bvh."""
    T = feats.shape[0]
    root_pos = feats[:, :3]
    out_cols = []
    for j, joint in enumerate(header.joints):
        d6 = feats[:, 3 + j * 6: 3 + (j + 1) * 6]
        R = rot6d_to_rotmat(d6)
        order = header.rot_order(j) or "ZXY"
        eul = rotmat_to_euler(R, order)
        cols = []
        ei = 0
        for ch in joint.channels:
            if ch.lower().endswith("position"):
                axis = {"x": 0, "y": 1, "z": 2}[ch[0].lower()]
                cols.append(root_pos[:, axis] if j == 0 else np.zeros(T))
            else:
                cols.append(eul[:, ei]); ei += 1
        if cols:
            out_cols.append(np.stack(cols, axis=1))
    return np.concatenate(out_cols, axis=1)


def save_bvh(header: BvhHeader, frames: np.ndarray) -> str:
    """Serialize header+frames back to BVH text."""
    lines: List[str] = ["HIERARCHY"]

    def emit(j: int, indent: int):
        joint = header.joints[j]
        pad = "  " * indent
        kw = "ROOT" if joint.parent == -1 else "JOINT"
        lines.append(f"{pad}{kw} {joint.name}")
        lines.append(pad + "{")
        lines.append(f"{pad}  OFFSET {joint.offset[0]:.6f} {joint.offset[1]:.6f} {joint.offset[2]:.6f}")
        if joint.channels:
            lines.append(f"{pad}  CHANNELS {len(joint.channels)} " + " ".join(joint.channels))
        for c in joint.children:
            emit(c, indent + 1)
        if not joint.children:
            lines.append(f"{pad}  End Site")
            lines.append(pad + "  {")
            lines.append(f"{pad}    OFFSET 0.000000 0.000000 0.000000")
            lines.append(pad + "  }")
        lines.append(pad + "}")

    emit(0, 0)
    lines.append("MOTION")
    lines.append(f"Frames: {frames.shape[0]}")
    lines.append(f"Frame Time: {header.frame_time:.6f}")
    for row in frames:
        lines.append(" ".join(f"{v:.6f}" for v in row))
    return "\n".join(lines)


def forward_kinematics(header: BvhHeader, feats: np.ndarray) -> np.ndarray:
    """(T, 3+J*6) -> joint world positions (T, J, 3)."""
    T = feats.shape[0]
    J = header.num_joints
    pos = np.zeros((T, J, 3))
    world_R = np.zeros((T, J, 3, 3))
    for j, joint in enumerate(header.joints):
        R = rot6d_to_rotmat(feats[:, 3 + j * 6: 3 + (j + 1) * 6])
        if joint.parent == -1:
            world_R[:, j] = R
            pos[:, j] = feats[:, :3]
        else:
            p = joint.parent
            world_R[:, j] = world_R[:, p] @ R
            pos[:, j] = pos[:, p] + (world_R[:, p] @ joint.offset)
    return pos
