"""device.idle_pct: the share of the traced window in which no
operation ran on the device, in percent."""

from benchmark.harness.trace import idle_pct


def read(run):
    return idle_pct(run.trace)
