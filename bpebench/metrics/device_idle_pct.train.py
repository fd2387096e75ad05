"""The share of the traced window in which the device ran nothing, %."""

from bpebench.readers import idle_pct as read  # noqa: F401
