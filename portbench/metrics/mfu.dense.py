"""The DenseUNet train step's share of the card's dense bf16 peak (forward
x 3, 2 FLOP a multiply-add: portbench/dense_counts.py)."""

from portbench.readers import mfu as read  # noqa: F401
