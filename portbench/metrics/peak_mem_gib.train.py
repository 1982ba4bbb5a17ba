"""Peak allocated device memory over the training window, GiB."""
from portbench.readers import peak_gib as read  # noqa: F401
