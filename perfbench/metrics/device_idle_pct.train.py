"""The share of the traced train window in which no operation ran on the
card (the union of the trace's kernel, copy and memset intervals)."""
from perfbench.metrics_common import idle_pct


def read(run):
    return idle_pct(run, 'train')
