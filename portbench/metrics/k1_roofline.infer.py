"""K1's bound over the device time of its forward calls in an inference
slice, %."""
from portbench.readers import k1_roofline as read  # noqa: F401
