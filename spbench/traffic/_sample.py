"""A reservoir of answers kept for the comparison, drawn from the seed."""

from __future__ import annotations

import numpy as np


class Reservoir:
    """Keeps ``size`` of the items offered, each offered item equally
    likely to stay (Vitter's algorithm R), choices drawn from ``rng``."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1
