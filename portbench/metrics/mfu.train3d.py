"""As train_mfu, in the 3-D training cell."""

from portbench.readers import mfu as read  # noqa: F401
