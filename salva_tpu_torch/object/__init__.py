"""Particle containers and interaction groups."""

from .interaction_groups import ALL, NONE, InteractionGroups, group
from .state import BoundariesState, FluidsState, state_from_numpy, state_to_numpy

__all__ = [
    "ALL",
    "NONE",
    "InteractionGroups",
    "group",
    "FluidsState",
    "BoundariesState",
    "state_from_numpy",
    "state_to_numpy",
]
