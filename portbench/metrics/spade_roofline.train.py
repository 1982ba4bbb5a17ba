"""The plain SPADE norm's bound over the device time of its forward calls
(``seg2eye::spade``) in a training slice, %."""
from portbench.roofline_spade import spade_roofline as read  # noqa: F401
