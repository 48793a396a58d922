"""`peak_mem_gib.train`'s reading in char-train, where it moves
`train_card_ms_per_audio_s` (char-train's wall rate spreads too widely with
the host's speed to carry a bound; PERF.md §2)."""
from perfbench import harness


def read(run):
    return harness.Registry().metric('peak_mem_gib.train').read(run)
