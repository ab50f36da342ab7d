"""Host milliseconds of a case outside the predictor."""

from portbench.readers import evaluator_ms as read  # noqa: F401
