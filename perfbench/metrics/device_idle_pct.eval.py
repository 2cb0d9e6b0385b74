"""device_idle_pct.eval: the share of the traced window (the first whole
calls of the eval loop) in which no kernel, memcpy or memset ran, in %."""

from perfbench.core.trace import idle_pct


def read(ctx):
    return idle_pct(ctx["trace"])
