"""The train step's share of the card's bf16 peak: the model convolutions'
FLOPs for the valid audio of the window's steps (forward, and the backward's
two products: three times the forward), from the configuration's widths,
over the window's wall seconds, over 989 TFLOP/s."""
from perfbench import measure


def read(run):
    v = run.values
    if v.get('kind') != 'train' or not v.get('window_s'):
        return None
    return 100.0 * v['train_flops'] / v['window_s'] / measure.PEAK_BF16_FLOPS
