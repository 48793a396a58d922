"""Reader of the compact mmap-able binary n-gram LM format "CNLM" (copy of
the reading half of convasr_tpu/text/binlm.py: BinaryLM, is_binary_lm).

The JAX package's `python -m convasr_tpu.text.binlm model.arpa model.binlm`
writes the format; the port reads it here and in its C++ beam
(native/ctc_beam.cpp NgramLM::load_binary, a bit-identical hash). Load time is
O(vocab): the n-gram bulk is memory-mapped with no parsing.

Format (little-endian, 8-byte-aligned sections)::

    0   8s   magic  b'CNLMBIN1'
    8   u32  order
    12  u32  vocab_size
    16  u64  vocab_blob_bytes
    24  u64  counts[order]
    ..  vocab blob: vocab_size NUL-terminated UTF-8 strings (id = index)
    ..  per order n = 1..order:
          u64 hash[counts[n-1]]   (sorted ascending)
          f32 logp[counts[n-1]]   (natural log)
          f32 backoff[counts[n-1]] (natural log)

Each n-gram is keyed by a 64-bit FNV-1a/fmix64 fingerprint of its word-id
sequence; lookup is a binary search on the sorted hash array.
"""
import math
import mmap
import struct
import typing

import numpy as np

MAGIC = b'CNLMBIN1'
LOG10 = math.log(10.0)
_FNV_OFFSET = 0xcbf29ce484222325
_FNV_PRIME = 0x100000001b3
_GOLDEN = 0x9e3779b97f4a7c15
# sentinel id for words absent from the LM vocab: hashes to a key that is
# (with fingerprint probability) never present, so any n-gram containing an
# OOV word misses — mirroring ArpaLM's string-keyed behavior
OOV_ID = 0xFFFFFFFF


def _fmix64(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(0xff51afd7ed558ccd)
    h = h ^ (h >> np.uint64(33))
    h = h * np.uint64(0xc4ceb9fe1a85ec53)
    h = h ^ (h >> np.uint64(33))
    return h


def ngram_hash_many(ids: np.ndarray) -> np.ndarray:
    """Vectorized fingerprint of each ROW of an (N, n) uint32 id matrix."""
    ids = np.asarray(ids, np.uint64)
    with np.errstate(over='ignore'):
        h = np.full(ids.shape[0], _FNV_OFFSET, np.uint64)
        for col in range(ids.shape[1]):
            h = (h ^ (ids[:, col] + np.uint64(_GOLDEN))) * np.uint64(_FNV_PRIME)
        return _fmix64(h)


def ngram_hash(ids: typing.Sequence[int]) -> int:
    return int(ngram_hash_many(np.asarray([ids], np.uint64))[0])


def is_binary_lm(path: str) -> bool:
    try:
        with open(path, 'rb') as f:
            return f.read(8) == MAGIC
    except OSError:
        return False


class BinaryLM:
    """mmap loader scoring-compatible with `decode.beam.ArpaLM` (same Katz
    backoff chain, natural-log scores), so it drops into BeamSearchDecoder's
    python fallback and `char_lm_table` device fusion unchanged."""

    def __init__(self, path: str):
        self.path = str(path)   # native rescoring fast path (decode/beam.py)
        self._f = open(path, 'rb')
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        mm = self._mm
        assert mm[:8] == MAGIC, f'{path} is not a CNLM binary LM'
        self.order, vocab_size, blob_bytes = struct.unpack_from('<IIQ', mm, 8)
        counts = struct.unpack_from(f'<{self.order}Q', mm, 24)
        off = 24 + 8 * self.order
        blob = mm[off:off + blob_bytes]
        off += blob_bytes
        off += -off % 8
        # the only O(vocab) work at load: word -> id map from the blob
        words = blob.split(b'\0')[:-1]
        assert len(words) == vocab_size
        self.vocab = {w.decode('utf-8'): i for i, w in enumerate(words)}
        self._hash: typing.List[np.ndarray] = []
        self._logp: typing.List[np.ndarray] = []
        self._backoff: typing.List[np.ndarray] = []
        for n in range(self.order):
            c = counts[n]
            self._hash.append(np.frombuffer(mm, np.uint64, c, off))
            off += 8 * c
            self._logp.append(np.frombuffer(mm, np.float32, c, off))
            off += 4 * c
            self._backoff.append(np.frombuffer(mm, np.float32, c, off))
            off += 4 * c
            off += -off % 8
        unk = self.vocab.get('<unk>')
        self._unk_logp = None
        if unk is not None:
            found, logp, _ = self._lookup([unk])
            if found:
                self._unk_logp = logp

    def _lookup(self, ids: typing.Sequence[int]):
        n = len(ids)
        if n > self.order:
            return False, 0.0, 0.0
        h = np.uint64(ngram_hash(ids))
        arr = self._hash[n - 1]
        i = int(np.searchsorted(arr, h))
        if i < arr.shape[0] and arr[i] == h:
            return True, float(self._logp[n - 1][i]), \
                float(self._backoff[n - 1][i])
        return False, 0.0, 0.0

    def score(self, context_words: typing.Sequence[str]) -> float:
        """log P(w_last | preceding words) — ArpaLM.score semantics."""
        ids = [self.vocab.get(w, OOV_ID)
               for w in context_words[-self.order:]]
        total = 0.0
        while ids:
            found, logp, _ = self._lookup(ids)
            if found:
                return total + logp
            if len(ids) == 1:
                unk = self._unk_logp
                return total + (unk if unk is not None else -10.0 * LOG10)
            ctx_found, _, ctx_backoff = self._lookup(ids[:-1])
            if ctx_found:
                total += ctx_backoff
            ids = ids[1:]
        return -float('inf')
