"""Host milliseconds a DenseUNet train step waited for its raw batch."""

from portbench.readers import input_wait_ms as read  # noqa: F401
