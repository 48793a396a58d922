"""Seeded audio and transcripts of the traffic: speech-like noise (a
loudness envelope over quarter-second syllables, with pauses) as float32
values that int16 PCM holds exactly, and CTC label ids.

The sizes of a mix (durations, label lengths, batch shapes, arrivals) come
from the mix's own `corpus_seed`, so every run seed does the same work; the
run seed draws the content and the order.
"""
import math

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator of its own for each use of one seed."""
    return np.random.default_rng([int(seed) & (2 ** 64 - 1), stream])


def speechlike(g: np.random.Generator, samples: int, sample_rate: int) -> np.ndarray:
    """(samples,) float32 in [-1, 1], each value k / 32767 for an integer k."""
    syllable = max(sample_rate // 4, 1)
    n = math.ceil(samples / syllable)
    env = g.uniform(0.02, 0.5, size=n).astype(np.float32)
    env[g.random(n) < 0.2] = 0.003                                   # pauses
    x = g.standard_normal(samples, dtype=np.float32) * np.repeat(env, syllable)[:samples]
    return np.round(np.clip(x, -1.0, 1.0) * 32767.0) / np.float32(32767.0)


def labels(g: np.random.Generator, length: int, classes: int) -> np.ndarray:
    """`length` label ids over the non-blank classes (blank is the last)."""
    return g.integers(0, classes - 1, size=length, dtype=np.int64)


def lognormal_clipped(g: np.random.Generator, n: int, median: float, sigma: float,
                      lo: float, hi: float) -> np.ndarray:
    return np.clip(np.exp(np.log(median) + sigma * g.standard_normal(n)), lo, hi)


def to_int16(x: np.ndarray) -> np.ndarray:
    """float32 audio as int16 PCM (the transport's rounding)."""
    return (np.clip(x, -1.0, 1.0) * 32767.0).round().astype(np.int16)
