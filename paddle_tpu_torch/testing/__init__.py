"""Deterministic drill harnesses: the fault-injection seams
(:mod:`.faultline`)."""

from . import faultline  # noqa: F401

__all__ = ["faultline"]
