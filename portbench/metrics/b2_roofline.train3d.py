"""As b2_roofline.train, in the 3-D training cell."""

from portbench.readers import b2_roofline as read  # noqa: F401
