"""Online multi-implicit-submap neural RGB-D SLAM in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of MIPSFusion
(yjtang249/MIPSFusion, SIGGRAPH Asia 2023): multi-implicit-submap neural
SLAM with hybrid (gradient + particle-swarm) tracking, submap lifecycle
management, loop closure with pose-graph optimization, and joint
marching-cubes mesh extraction. Its accelerator is an NVIDIA GPU
(``python chip_smoke.py``); the tests run it on the CPU.

Design stance:
  * The per-submap scene representation (multiscale triplane + CP lines
    or a hash grid, and a tiny MLP with a classification SDF head) is a
    pure-functional pytree; the whole sample->encode->decode->render->
    loss path is one jitted function differentiated with jax.grad.
  * All state lives in fixed-capacity device arrays with validity masks
    (no dynamic shapes, no retraces on the per-frame hot path).
  * Submaps are a stacked leading parameter axis [M, ...]; the
    reference's two-process shared-memory model handoff protocol
    becomes an index update.
  * Tracking (particle swarm + gradient descent) and bundle adjustment
    run as single jitted calls containing their full iteration loops
    (lax.fori_loop / lax.scan).
"""

__version__ = "0.1.0"
