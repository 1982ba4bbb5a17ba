"""Idle share of the card in the traced inference slice, %."""
from portbench.readers import idle_share as read  # noqa: F401
