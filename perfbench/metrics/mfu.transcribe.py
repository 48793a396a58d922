"""The transcribe forward's share of the card's bf16 peak: the model
convolutions' FLOPs for the valid audio of the window's batches, from the
configuration's widths, over the window's wall seconds, over 989 TFLOP/s."""
from perfbench import measure


def read(run):
    v = run.values
    if v.get('kind') != 'transcribe' or not v.get('window_s'):
        return None
    return 100.0 * v['fwd_flops'] / v['window_s'] / measure.PEAK_BF16_FLOPS
