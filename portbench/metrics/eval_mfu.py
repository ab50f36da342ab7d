"""The eval's share of the card's dense bf16 peak: the forward FLOPs the
configured algorithm needs for the completed cases."""

from portbench.readers import mfu as read  # noqa: F401
