"""device_idle_pct.flux: the share of the traced window (the first whole
calls of the FLUX eval loop) in which no kernel, memcpy or memset ran, in
%: ``device_idle_pct.eval``'s reader."""

from perfbench.core.harness import load

read = load("metrics", "device_idle_pct.eval").read
