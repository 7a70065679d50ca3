"""iterative_learning_nmpc_tpu — quadruped NMPC + iterative imitation learning in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the reference
Atarilab/iterative_learning_NMPC stack (acados/HPIPM/Pinocchio/CasADi/torch),
re-designed for batched accelerator execution (the production target is an
NVIDIA GPU; every test runs on the CPU):

- ``robots``   : robot model catalog (Go2, Solo12) + MJCF generation for the
                 CPU MuJoCo oracle/plant.
- ``models``   : pure-JAX rigid-body dynamics (FK, RNEA, CRBA, centroidal
                 momentum, frame Jacobians) in the Euler-chart the reference
                 uses (base = 6 explicit DOFs, q ∈ R^18, v = dq/dt).
- ``ocp``      : declarative optimal-control problem: stage residuals (costs +
                 penalty constraints), contact activity as masks (static shapes).
- ``solver``   : GN-SQP/RTI trajectory optimizer: vmapped linearization,
                 Riccati backward sweep, parallel line search. Replaces
                 acados+HPIPM+BLASFEO.
- ``ops``      : Pallas-Triton GPU kernel for the batched Riccati sweep +
                 rollout.
- ``gait``     : cyclic gait machines, Raibert / custom / acyclic footstep
                 planners.
- ``mpc``      : closed-loop MPC controller (async replanning, interpolation,
                 delay compensation, RNEA feed-forward + joint PD).
- ``sim``      : CPU MuJoCo co-sim harness (oracle) + batched on-device JAX
                 soft-contact simulator for large-scale datagen.
- ``learning`` : dataset layer, JAX policy MLP, BC training, policy / combined
                 (SafeDAgger) controllers, data-collection and DAgger loops.
- ``parallel`` : device-mesh sharding of batched solves / training (jit
                 shardings, shard_map, collectives).
"""

__version__ = "0.1.0"

import jax as _jax

# The NMPC numerics (Riccati recursions on 36x36 blocks, RNEA chains) need
# true fp32 accumulation: "highest" keeps fp32 matmuls out of TF32/bf16
# everywhere (the 1e-3 CPU parity gate depends on it).
_jax.config.update("jax_default_matmul_precision", "highest")
