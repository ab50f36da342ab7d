"""As host_launches_per_step.train, in the 3-D training cell."""

from portbench.readers import host_launches as read  # noqa: F401
