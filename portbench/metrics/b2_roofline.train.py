"""Kernel B2's share of its roofline in a train step (forward x read and
y written, backward g and x read and dx written)."""

from portbench.readers import b2_roofline as read  # noqa: F401
