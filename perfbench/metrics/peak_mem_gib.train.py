"""The card's peak allocated memory over the measured train window, in GiB
(torch.cuda.max_memory_allocated after reset_peak_memory_stats at the
window's start)."""


def read(run):
    if run.values.get('kind') != 'train' or run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30
