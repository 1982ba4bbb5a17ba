"""Idle share of the card in the traced training slice, %."""
from portbench.readers import idle_share as read  # noqa: F401
