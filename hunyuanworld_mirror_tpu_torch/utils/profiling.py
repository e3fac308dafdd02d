"""Phase marks for timing the forward on the card with CUDA events."""

from typing import List, Optional

import torch


def mark(marks: Optional[List], name: str) -> None:
    """Append (name, CUDA event recorded now) to `marks`; no-op for None.

    A phase's time is the elapsed time between its event and the previous
    one (the first phase is timed from an event the caller records)."""
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
