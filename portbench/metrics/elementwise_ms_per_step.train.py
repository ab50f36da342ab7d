"""Device milliseconds a train step spends in the other elementwise
kernels, reductions, copies and gathers (G-Net's plain modulated norm
among them)."""

from portbench.readers import ms_per_unit

read = ms_per_unit("elementwise", "copy")
