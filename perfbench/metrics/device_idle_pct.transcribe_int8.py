"""The share of the traced int8 transcribe window in which no operation ran
on the card."""
from perfbench.metrics_common import idle_pct


def read(run):
    return idle_pct(run, 'transcribe_int8')
