"""Seeded violation for dead_knobs: SearchConfig.phantom_knob is read
nowhere; max_hops is live only through the hops_bound property."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    L: int = 64
    max_hops: int = 0
    phantom_knob: int = 3

    @property
    def hops_bound(self) -> int:
        return self.max_hops if self.max_hops > 0 else 4 * self.L
