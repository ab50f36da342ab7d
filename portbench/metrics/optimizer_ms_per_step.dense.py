"""Device milliseconds a DenseUNet train step spends in the optimizer's
multi-tensor (foreach) kernels."""

from portbench.readers import ms_per_unit

read = ms_per_unit("optimizer")
