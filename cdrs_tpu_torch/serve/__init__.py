"""Serving: the read view of a pinned placement epoch."""

from .view import ReadView, read_view

__all__ = ["ReadView", "read_view"]
