"""Substep / CFL regulation.

Mirrors ``src/timestep_manager.rs``: CFL coefficient 0.4, 1..10 substeps,
CFL substep formula ``2 * radius / max|v + a t| * cfl`` (`:36-46`).
The reference's ``compute_substep`` currently short-circuits to the full
step size (`:87-94`), so ``adaptive=False`` (the default, faithful mode)
runs exactly one substep per step. ``adaptive=True`` enables the CFL
formula the reference left disabled.
"""

from __future__ import annotations


class TimestepManager:
    def __init__(
        self,
        particle_radius: float,
        cfl_coeff: float = 0.4,
        min_num_substeps: int = 1,
        max_num_substeps: int = 10,
        adaptive: bool = False,
    ):
        self.cfl_coeff = cfl_coeff
        self.min_num_substeps = min_num_substeps
        self.max_num_substeps = max_num_substeps
        self.particle_radius = particle_radius
        self.adaptive = adaptive
        self.dt = 0.0
        self.inv_dt = 0.0
        self.total_step_size = 0.0
        self.remaining_time = 0.0

    def reset(self, total_step_size: float):
        self.total_step_size = total_step_size
        self.remaining_time = total_step_size

    def is_done(self) -> bool:
        return self.remaining_time <= 1.19e-7

    def max_substep(self, max_velocity: float) -> float:
        """CFL bound from the maximum particle speed (`:36-46`)."""
        if max_velocity <= 0.0:
            return self.total_step_size
        return self.particle_radius * 2.0 / max_velocity * self.cfl_coeff

    def compute_substep(self, max_velocity: float) -> float:
        if not self.adaptive:
            return self.total_step_size
        min_substep = self.total_step_size / self.max_num_substeps
        max_substep = self.total_step_size / self.min_num_substeps
        cfl = self.max_substep(max_velocity)
        return min(max(cfl, min_substep), max_substep, self.remaining_time)

    def advance(self, max_velocity: float = 0.0) -> float:
        substep = self.compute_substep(max_velocity)
        self.dt = substep
        self.inv_dt = 1.0 / substep if substep > 0.0 else 0.0
        self.remaining_time -= substep
        return substep
