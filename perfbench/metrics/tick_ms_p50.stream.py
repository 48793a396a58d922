"""The median host milliseconds of a streaming engine tick (ring advance,
the (N, W) forward, argmax, the tail's read-back, the inboxes) over the
ticks that began in the measured window."""
from perfbench import measure


def read(run):
    ticks = run.values.get('tick_s') if run.values.get('kind') == 'stream' else None
    return 1e3 * measure.percentile(ticks, 50) if ticks else None
