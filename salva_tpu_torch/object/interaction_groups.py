"""Interaction groups: 32-bit membership/filter bitmask pairs.

Mirrors ``src/object/interaction_groups.rs``: an interaction between a and
b is allowed iff ``(a.memberships & b.filter) != 0 && (b.memberships &
a.filter) != 0`` (`:64-69`). Defaults are GROUP_1 membership with ALL
filter (`:72-79`).
"""

from __future__ import annotations

import dataclasses

ALL = 0xFFFFFFFF
NONE = 0


def group(n: int) -> int:
    """GROUP_n bit (1-based, n in 1..=32), like the `Group` bitflags
    (`interaction_groups.rs:81-155`)."""
    if not 1 <= n <= 32:
        raise ValueError("group index must be in 1..=32")
    return 1 << (n - 1)


@dataclasses.dataclass(frozen=True)
class InteractionGroups:
    """Host-side pair of bitmasks, stored per-particle on device."""

    memberships: int = group(1)
    filter: int = ALL

    def test(self, other: "InteractionGroups") -> bool:
        return (
            (self.memberships & other.filter) != 0
            and (other.memberships & self.filter) != 0
        )
