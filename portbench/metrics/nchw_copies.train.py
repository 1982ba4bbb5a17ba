"""NCHW copies per iteration that the program makes for its convs
(``layers.nchw_copy``: f32 dilated convs and dilated depthwise convs)."""
from portbench.spans_deeplab import copies_per_step as read  # noqa: F401
