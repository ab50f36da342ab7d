"""Milliseconds of the predictor per volume slice."""

from portbench.readers import predict_ms_per_slice as read  # noqa: F401
