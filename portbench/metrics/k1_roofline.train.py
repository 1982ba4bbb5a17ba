"""K1's bound over the device time of its forward calls in a training
slice, %."""
from portbench.readers import k1_roofline as read  # noqa: F401
