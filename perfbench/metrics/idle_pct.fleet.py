"""Share of the traced window in which no operation ran on the card."""
from perfbench.readers import idle_pct as read  # noqa: F401
