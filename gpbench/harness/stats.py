"""Arithmetic of the end-to-end metrics: rates over the whole window
(never a median of chunks or a rate of the fastest part)."""

__all__ = ["rate"]


def rate(total, seconds):
    """``total`` units over ``seconds`` of window: the whole window's rate."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return total / seconds
