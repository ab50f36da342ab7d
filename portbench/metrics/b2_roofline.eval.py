"""Kernel B2's share of its roofline in the eval forwards (x read and y
written, a plane each)."""

from portbench.readers import b2_roofline as read  # noqa: F401
