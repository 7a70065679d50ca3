"""Robot model specification: a JAX-pytree kinematic tree.

Replaces the reference's Pinocchio-URDF path
(``/root/reference/mpc_controller/utils/dynamics.py:19-23`` loads a URDF and a
CasADi symbolic twin).  Here a robot is a plain dataclass of arrays; the same
spec drives the JAX dynamics (``models/``), the generated MuJoCo MJCF
(``robots/mjcf.py``) used as CPU oracle/plant, and the OCP dimensions.

Conventions (match the reference's Euler-chart model):
- The floating base is modeled as 6 explicit DOFs: Px, Py, Pz prismatic along
  the world axes, then Rz (yaw), Ry (pitch), Rx (roll) revolute — so
  ``q[:6] = [x, y, z, yaw, pitch, roll]`` and ``v = dq/dt`` with world-frame
  linear velocity and ZYX Euler-angle rates, exactly the state chart the
  reference solver uses (``mpc_controller/utils/dynamics.py:52-71``).
- Joint order: base(6), then FL(hip,thigh,calf), FR, RL, RR.
- Each DOF owns a "body": DOFs 0..4 carry massless dummy bodies, DOF 5 carries
  the trunk inertia, DOFs 6.. carry the leg links.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Joint types
PRISMATIC = 0
REVOLUTE = 1

FEET_ORDER = ("FL", "FR", "RL", "RR")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RobotSpec:
    """Kinematic-tree robot model as a pytree of arrays.

    Array fields are leaves (traced under jit); metadata fields are static.
    """

    # --- static metadata ---
    name: str = dataclasses.field(metadata=dict(static=True))
    nv: int = dataclasses.field(metadata=dict(static=True))           # total DOFs (18)
    nu: int = dataclasses.field(metadata=dict(static=True))           # actuated DOFs (12)
    parent: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    jtype: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    foot_body: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    feet_frame_names: Tuple[str, ...] = dataclasses.field(metadata=dict(static=True))

    # --- array leaves ---
    joint_axis: jax.Array      # (nv, 3) joint axis in the joint frame
    joint_pos: jax.Array       # (nv, 3) joint origin offset in parent body frame
    mass: jax.Array            # (nv,)   per-body mass
    com: jax.Array             # (nv, 3) body CoM in body frame
    inertia: jax.Array         # (nv, 3, 3) rotational inertia about the CoM, body frame
    foot_offset: jax.Array     # (4, 3)  foot point in its body frame
    foot_radius: jax.Array     # ()      foot sphere radius (for MJCF + ground contact)
    torque_limit: jax.Array    # (nu,)   actuation limits
    q_home: jax.Array          # (nv,)   nominal standing configuration
    joint_limits: jax.Array    # (nu, 2) lower/upper actuated-joint limits [rad]

    @property
    def n_foot(self) -> int:
        return len(self.foot_body)

    @property
    def ancestor_mask(self) -> np.ndarray:
        """(nv, nv) static bool: ancestor_mask[i, j] == True iff DOF j is on the
        path from the world to body i (inclusive)."""
        nvt = self.nv
        mask = np.zeros((nvt, nvt), dtype=bool)
        for i in range(nvt):
            k = i
            while k >= 0:
                mask[i, k] = True
                k = self.parent[k]
        return mask

    def total_mass(self) -> jax.Array:
        return jnp.sum(self.mass)


def _base_dofs():
    """The 6 floating-base DOFs: world-frame prismatic x/y/z then ZYX Euler."""
    parent = [-1, 0, 1, 2, 3, 4]
    jtype = [PRISMATIC, PRISMATIC, PRISMATIC, REVOLUTE, REVOLUTE, REVOLUTE]
    axis = [
        [1, 0, 0], [0, 1, 0], [0, 0, 1],   # Px, Py, Pz
        [0, 0, 1], [0, 1, 0], [1, 0, 0],   # Rz (yaw), Ry (pitch), Rx (roll)
    ]
    pos = [[0, 0, 0]] * 6
    return parent, jtype, axis, pos


def build_quadruped_spec(
    name: str,
    trunk_mass: float,
    trunk_com,
    trunk_inertia,
    hip_xy,                  # (4, 2) hip joint x/y offsets from trunk
    thigh_y: float,          # lateral hip->thigh offset magnitude (left +, right -)
    thigh_len: float,        # thigh (upper-leg) length (thigh->calf joint, -z)
    calf_len: float,         # calf (lower-leg) length (calf->foot, -z)
    hip_mass: float, hip_com, hip_inertia,
    thigh_mass: float, thigh_com, thigh_inertia,
    calf_mass: float, calf_com, calf_inertia,
    foot_radius: float,
    torque_limit,            # (3,) per-leg-joint [hip, thigh, calf]
    q_home_joints,           # (3,) per-leg [hip, thigh, calf] nominal angles
    joint_limits,            # (3, 2) per-leg-joint [lo, hi]
    base_height_home: float,
    dtype=jnp.float32,
) -> RobotSpec:
    """Assemble a 4-legged RobotSpec from per-leg link parameters.

    Left/right legs mirror in y: joint origins flip the y-offset sign; link
    CoM y-offsets flip sign as well (inertias kept diagonal-dominant so the
    mirror approximation only flips products of inertia, which we zero).
    """
    parent, jtype, axis, pos = _base_dofs()
    mass = [0.0] * 5 + [trunk_mass]
    com = [[0, 0, 0]] * 5 + [list(trunk_com)]
    inertia = [np.zeros((3, 3))] * 5 + [np.asarray(trunk_inertia, dtype=np.float64)]

    foot_body = []
    signs_y = {"FL": 1.0, "FR": -1.0, "RL": 1.0, "RR": -1.0}
    for i_leg, leg in enumerate(FEET_ORDER):
        sy = signs_y[leg]
        base_idx = 5  # trunk body index
        hip_idx = len(parent)
        # hip (abduction, axis x)
        parent.append(base_idx)
        jtype.append(REVOLUTE)
        axis.append([1, 0, 0])
        pos.append([hip_xy[i_leg][0], hip_xy[i_leg][1], 0.0])
        mass.append(hip_mass)
        c = np.asarray(hip_com, dtype=np.float64).copy()
        # hip com mirrors in y for right legs and in x for rear legs
        sx = 1.0 if leg in ("FL", "FR") else -1.0
        c[0] *= sx
        c[1] *= sy
        com.append(list(c))
        inertia.append(np.diag(np.diag(np.asarray(hip_inertia, dtype=np.float64))))
        # thigh (hip pitch, axis y)
        parent.append(hip_idx)
        jtype.append(REVOLUTE)
        axis.append([0, 1, 0])
        pos.append([0.0, sy * thigh_y, 0.0])
        mass.append(thigh_mass)
        c = np.asarray(thigh_com, dtype=np.float64).copy()
        c[1] *= sy
        com.append(list(c))
        inertia.append(np.diag(np.diag(np.asarray(thigh_inertia, dtype=np.float64))))
        # calf (knee pitch, axis y)
        parent.append(hip_idx + 1)
        jtype.append(REVOLUTE)
        axis.append([0, 1, 0])
        pos.append([0.0, 0.0, -thigh_len])
        mass.append(calf_mass)
        com.append(list(np.asarray(calf_com, dtype=np.float64)))
        inertia.append(np.diag(np.diag(np.asarray(calf_inertia, dtype=np.float64))))
        foot_body.append(hip_idx + 2)

    nvt = len(parent)
    nu = nvt - 6
    q_home = np.zeros(nvt)
    q_home[2] = base_height_home
    for i_leg in range(4):
        q_home[6 + 3 * i_leg: 9 + 3 * i_leg] = q_home_joints
        # mirror hip abduction for right legs
        if FEET_ORDER[i_leg] in ("FR", "RR"):
            q_home[6 + 3 * i_leg] *= -1.0

    # numpy leaves on purpose: they embed as constants at trace time and
    # avoid eager device dispatches.
    npd = np.dtype(jnp.dtype(dtype).name)
    return RobotSpec(
        name=name,
        nv=nvt,
        nu=nu,
        parent=tuple(parent),
        jtype=tuple(jtype),
        foot_body=tuple(foot_body),
        feet_frame_names=tuple(f"{leg}_foot" for leg in FEET_ORDER),
        joint_axis=np.asarray(axis, dtype=npd),
        joint_pos=np.asarray(pos, dtype=npd),
        mass=np.asarray(mass, dtype=npd),
        com=np.asarray(com, dtype=npd),
        inertia=np.asarray(np.stack(inertia), dtype=npd),
        foot_offset=np.asarray([[0.0, 0.0, -calf_len]] * 4, dtype=npd),
        foot_radius=np.asarray(foot_radius, dtype=npd),
        torque_limit=np.asarray(list(torque_limit) * 4, dtype=npd),
        q_home=np.asarray(q_home, dtype=npd),
        joint_limits=np.asarray(list(joint_limits) * 4, dtype=npd),
    )
