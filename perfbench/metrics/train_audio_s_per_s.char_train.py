"""Audio seconds trained over the measured window's wall seconds in
char-train: `train_audio_s_per_s`'s reading, kept per layer there, where the
host's speed spreads it too widely to carry a bound (PERF.md §2)."""


def read(run):
    v = run.values
    if v.get('kind') != 'train' or not v.get('window_s'):
        return None
    return v['audio_s'] / v['window_s']
