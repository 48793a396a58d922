"""`ctc_roofline_pct.train`'s reading in char-train, where it moves
`train_card_ms_per_audio_s` (char-train's wall rate spreads too widely with
the host's speed to carry a bound; PERF.md §2)."""
from perfbench import harness


def read(run):
    return harness.Registry().metric('ctc_roofline_pct.train').read(run)
