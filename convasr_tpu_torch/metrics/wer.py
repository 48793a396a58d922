"""Edit-distance metrics CER / WER and helpers (a copy of
convasr_tpu/metrics/wer.py).

Behavior spec: the reference convasr metrics.py (cer metrics.py:409-411, wer
metrics.py:414-421, pure-python fallback metrics.py:424-444, nanmean
metrics.py:247-253, quantiles metrics.py:256-258).
"""
import math
import typing

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


def extract_metric_value(analysis_result: dict, key: str, sep: str = '.',
                         missing: typing.Optional[float] = None) -> typing.Optional[float]:
    keys = key.split(sep)
    assert len(keys) <= 2
    value = analysis_result
    for k in keys:
        if not isinstance(value, dict):
            return missing
        value = value.get(k, missing)
    return value


def nanmean(list_of_dicts: typing.List[dict], key: str, sep: str = '.', missing: float = -1.0) -> float:
    vals = [v for d in list_of_dicts
            for v in [extract_metric_value(d, key, sep)]
            if v is not None and isinstance(v, (int, float)) and math.isfinite(v)]
    return sum(vals) / len(vals) if vals else missing


def quantiles(vals) -> dict:
    vals = sorted(vals)
    if not vals:
        return {}
    return {k: '{:.2f}'.format(float(vals[int(len(vals) * k / 100)])) for k in range(0, 100, 10)}
