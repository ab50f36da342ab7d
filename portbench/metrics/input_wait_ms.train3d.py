"""As input_wait_ms.train, in the 3-D training cell."""

from portbench.readers import input_wait_ms as read  # noqa: F401
