"""The coupling protocol.

Mirrors the reference's ``CouplingManager`` trait
(``src/coupling/coupling_manager.rs:9-28``): the world calls
``update_boundaries`` at the start of every substep (so boundary particles
track their rigid bodies) and ``transmit_forces`` at the end (so fluid
pressure feeds back as impulses). The no-op impl corresponds to the
reference's ``impl CouplingManager for ()`` (``:30-43``), which makes
``step`` equivalent to ``step_with_coupling(..., None)``.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable


@runtime_checkable
class CouplingManager(Protocol):
    def update_boundaries(self, world, dt: float) -> None:
        """Resample coupled boundary particles from current body poses and
        (optionally) depenetrate fluid particles."""
        ...

    def transmit_forces(self, world, dt: float) -> None:
        """Apply accumulated boundary forces back to the rigid bodies."""
        ...


class NoOpCoupling:
    """Explicit no-op coupling (`coupling_manager.rs:30-43`)."""

    def update_boundaries(self, world, dt: float) -> None:
        pass

    def transmit_forces(self, world, dt: float) -> None:
        pass
