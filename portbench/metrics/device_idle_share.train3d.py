"""As device_idle_share.train, in the 3-D training cell."""

from portbench.readers import idle_share as read  # noqa: F401
