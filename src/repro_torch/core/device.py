"""Vertical geometry of a crossbar cell site (``DeviceConfig``).

The memristor device model of the reference (``MemristorModel``) is not
ported yet; only the stack geometry the executor needs lives here.
"""
from __future__ import annotations

import dataclasses
import string
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DeviceConfig:
    """Vertical geometry of one crossbar cell site.

    The paper's 10x10x2 array stacks exactly two TiO2/TiO2-x planes per
    cell; ``stack_planes`` generalizes that height.  The default of 2 is
    the classic ping-pong pair.
    """
    stack_planes: int = 2

    def __post_init__(self):
        if self.stack_planes < 2:
            raise ValueError(
                f"stack_planes must be >= 2 (a read plane plus at least "
                f"one write/twin plane); got {self.stack_planes}")

    @property
    def tenant_names(self) -> Tuple[str, ...]:
        """One addressable tenant name per plane slot: "A", "B", ..."""
        letters = string.ascii_uppercase
        return tuple(letters[i] if i < len(letters) else f"T{i}"
                     for i in range(self.stack_planes))
