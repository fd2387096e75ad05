"""The least bytes of the window's work at the card's peak bandwidth, over
the device's busy time, %: a job's text read once and 12 B a merge
written; a request's bytes read once, its ids written once as int32 and
the table's rows read once at 12 B a row."""

from bpebench.readers import roofline_pct as read  # noqa: F401
