"""Device milliseconds a DenseUNet train step spends in convolutions and
their layout transposes (cuDNN, CUTLASS, gemm kernels)."""

from portbench.readers import ms_per_unit

read = ms_per_unit("conv")
