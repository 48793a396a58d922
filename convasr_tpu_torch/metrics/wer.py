"""Edit-distance metrics CER / WER (counterpart of convasr_tpu/metrics/wer.py;
the CLI needs these two, the rest of that module comes later).

Behavior spec: the reference convasr metrics.py (cer metrics.py:409-411, wer
metrics.py:414-421, pure-python fallback metrics.py:424-444).
"""
try:
    import Levenshtein as _lev

    def edit_distance(a: str, b: str) -> int:
        return _lev.distance(a, b)
except ImportError:  # pure-python fallback, O(min(n,m)) space
    def edit_distance(a: str, b: str) -> int:
        if len(a) > len(b):
            a, b = b, a
        previous = list(range(len(a) + 1))
        for i, cb in enumerate(b, 1):
            current = [i] + [0] * len(a)
            for j, ca in enumerate(a, 1):
                current[j] = min(previous[j] + 1, current[j - 1] + 1, previous[j - 1] + (ca != cb))
            previous = current
        return previous[len(a)]


levenshtein = edit_distance


def cer(*, hyp: str, ref: str) -> float:
    """Character error rate: edit distance over space-stripped lowercase strings,
    normalized by ref char count (min 1)."""
    if hyp == ref:
        return 0
    ref_len = len(ref.replace(' ', '')) or 1
    return edit_distance(hyp.replace(' ', '').lower(), ref.replace(' ', '').lower()) / ref_len


def wer(*, hyp: str, ref: str) -> float:
    """Word error rate: words remapped to single chars, then edit distance,
    normalized by ref word count (min 1)."""
    if hyp == ref:
        return 0
    vocab = {w: i for i, w in enumerate(set(hyp.split() + ref.split()))}
    ref_len = len(ref.split()) or 1
    return edit_distance(''.join(chr(vocab[w]) for w in hyp.split()),
                         ''.join(chr(vocab[w]) for w in ref.split())) / ref_len

