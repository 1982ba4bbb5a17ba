"""Peak allocated device memory over the inference window, GiB."""
from portbench.readers import peak_gib as read  # noqa: F401
