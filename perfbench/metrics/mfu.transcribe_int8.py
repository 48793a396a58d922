"""The int8 transcribe forward's share of the card's int8 peak: the model
convolutions' operations for the valid audio of the window's batches, from
the configuration's widths, over the window's wall seconds, over 1,979
TOP/s."""
from perfbench import measure


def read(run):
    v = run.values
    if v.get('kind') != 'transcribe_int8' or not v.get('window_s'):
        return None
    return 100.0 * v['fwd_flops'] / v['window_s'] / measure.PEAK_INT8_OPS
