"""`FluidsPipeline`: the coupled simulation entry point.

Port of ``salva_tpu.coupling.pipeline`` (the reference's
``src/integrations/rapier/fluids_pipeline.rs:26-61``): a ``LiquidWorld``
(DFSPH by default, ``:34-41``) plus a ``ColliderCouplingSet``. One
``step`` advances rigid bodies and fluids with two-way coupling, as the
testbed/harness plugins drive it each frame (``harness_plugin.rs:59-70``).

``device=None`` means the card, as for ``LiquidWorld``: it raises without
one, and CPU callers pass ``device="cpu"``. ``device_coupling=None``
takes the device coupling path (``device_pipeline``: bodies, contacts and
resampling on the card, no host sync a substep) on a CUDA world and the
host path (``rigid_body`` + ``collider_coupling``) on a CPU world;
``True`` / ``False`` force either path on either device. Nothing falls
back from one path to the other.
"""

from __future__ import annotations

from typing import Optional

from ..config import DFSPHConfig, NeighborConfig
from ..world import LiquidWorld
from .collider_coupling import ColliderCouplingSet
from .rigid_body import RigidBodyWorld


class FluidsPipeline:
    def __init__(
        self,
        particle_radius: float,
        smoothing_factor: float = 2.0,
        dim: int = 3,
        solver=None,
        neighbors: Optional[NeighborConfig] = None,
        domain=None,
        layout: str = "auto",
        device_coupling: Optional[bool] = None,
        fit_grid: bool = True,
        device=None,
    ):
        self.liquid_world = LiquidWorld(
            solver=solver if solver is not None else DFSPHConfig(),
            particle_radius=particle_radius,
            smoothing_factor=smoothing_factor,
            dim=dim,
            neighbors=neighbors,
            domain=domain,
            layout=layout,
            fit_grid=fit_grid,
            device=device,
        )
        self.bodies = RigidBodyWorld(dim)
        self.coupling = ColliderCouplingSet(self.bodies)
        self._device_request = device_coupling
        self._device = None

    @property
    def device_coupling(self) -> bool:
        """Whether steps take the device coupling path (module note)."""
        use = self._device_request
        if use is None:
            use = self.liquid_world.device.type == "cuda"
        return bool(use)

    def _maybe_device(self):
        if self._device is not None:
            return self._device
        if self.device_coupling:
            from .device_pipeline import DeviceColliderCoupling

            self._device = DeviceColliderCoupling(
                self.coupling, self.liquid_world
            )
        else:
            self._device = False
            self.coupling.presample(self.liquid_world)
        return self._device

    def step(self, gravity, dt: float):
        """Advance bodies then fluids-with-coupling
        (`fluids_pipeline.rs:48-61`; body integration is rapier's job in the
        reference, done by the testbed around the fluid step)."""
        dev = self._maybe_device()
        if dev:
            # Body integration happens inside the device coupling's
            # pre-substep hook.
            dev.set_gravity(gravity)
            self.liquid_world.step_with_coupling(dt, gravity, dev)
        else:
            self.bodies.step(dt, gravity)
            self.liquid_world.step_with_coupling(dt, gravity, self.coupling)

    def sync_bodies(self):
        """Bring host RigidBody poses up to date with the device state
        (no-op on the host path)."""
        if self._device:
            self._device.sync_to_host()
        return self.bodies
