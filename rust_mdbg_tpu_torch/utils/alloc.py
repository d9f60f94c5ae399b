"""Fast host-buffer allocation.

On this platform, first-touch page faults of malloc'd memory (np.empty /
np.full) run ~100x slower than the calloc/zero-page path (~20 s vs ~0.2 s
for a 400 MB buffer; ~4k faults/s), so every hot-path staging buffer must
be allocated with np.zeros and then filled — zeroed pages arrive fast and
an in-place fill() on mapped pages is memory-bandwidth speed.
"""

from __future__ import annotations

import numpy as np


def full_fast(shape, fill, dtype) -> np.ndarray:
    """np.full twin that avoids the slow malloc first-touch path."""
    a = np.zeros(shape, dtype=dtype)
    if fill:
        a.fill(fill)
    return a
