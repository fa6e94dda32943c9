"""Two-way coupling between the fluid world and rigid-body dynamics.

Port of ``salva_tpu.coupling``. The reference couples salva to the
external rapier engine through the ``CouplingManager`` trait
(``src/coupling/coupling_manager.rs``) and ships a rapier implementation
(``src/integrations/rapier/fluids_pipeline.rs``). The same layering:

- ``base``: the coupling protocol the ``LiquidWorld`` step calls;
- ``rigid_body``: a minimal rigid-body engine playing rapier's role
  (bodies + SDF colliders + symplectic integration + impulses), on the
  host;
- ``collider_coupling``: ``ColliderSampling`` / ``ColliderCouplingSet`` —
  boundary resampling from collider poses and force transmission (the
  host path);
- ``device_pipeline``: the same coupled substep with the bodies on the
  world's device (the path a CUDA world takes by default);
- ``pipeline``: ``FluidsPipeline`` — the one-call-per-frame entry point.
"""

from .base import CouplingManager, NoOpCoupling
from .collider_coupling import ColliderCouplingSet, ColliderSampling
from .pipeline import FluidsPipeline
from .rigid_body import RigidBody, RigidBodyWorld

__all__ = [
    "CouplingManager",
    "NoOpCoupling",
    "ColliderSampling",
    "ColliderCouplingSet",
    "FluidsPipeline",
    "RigidBody",
    "RigidBodyWorld",
]
