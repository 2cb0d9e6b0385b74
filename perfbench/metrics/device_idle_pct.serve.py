"""device_idle_pct.serve: the share of the traced window (the first
seconds of serving) in which no kernel, memcpy or memset ran, in %."""

from perfbench.core.trace import idle_pct


def read(ctx):
    return idle_pct(ctx["trace"])
