"""Share of the traced DenseUNet train window with no device activity."""

from portbench.readers import idle_share as read  # noqa: F401
