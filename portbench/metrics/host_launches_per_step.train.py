"""Host launch calls per train step."""

from portbench.readers import host_launches as read  # noqa: F401
