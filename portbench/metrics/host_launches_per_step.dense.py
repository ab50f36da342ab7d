"""Host launch calls per DenseUNet train step: about 4 while the K steps
of a dispatch replay captured graphs, thousands were they eager."""

from portbench.readers import host_launches as read  # noqa: F401
