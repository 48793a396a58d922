"""Needleman-Wunsch global/semi-global sequence aligner (a copy of
convasr_tpu/metrics/needleman.py).

Behavior spec: the reference convasr metrics.py:447-645 (class Needleman). This is a
fresh implementation with the same external contract (align(seq_a, seq_b,
semi_global) -> (aligned_a, aligned_b) where gaps are `separator * len(elem)`)
but a vectorized numpy DP fill: each row is computed with a
running-max-with-decay trick for the insert chain, so the fill is O(n*m) numpy
work instead of an O(n*m) Python loop.
"""
import numpy as np

SCORE_UNIFORM = 1
SCORE_PROPORTION = 2


class Needleman:
    def __init__(self, score_null=5, score_sub=-100, score_del=-3, score_ins=-3,
                 separator='|', mode=SCORE_UNIFORM):
        self.score_null = score_null
        self.score_sub = score_sub
        self.score_del = score_del
        self.score_ins = score_ins
        self.separator = separator
        self.mode = mode

    def set_score(self, score_null=None, score_sub=None, score_del=None, score_ins=None):
        if score_null is not None:
            self.score_null = score_null
        if score_sub is not None:
            self.score_sub = score_sub
        if score_del is not None:
            self.score_del = score_del
        if score_ins is not None:
            self.score_ins = score_ins

    # element-wise scores (PROPORTION mode scales by element length)
    def _match(self, a, b):
        base = self.score_null if a == b else self.score_sub
        return base if self.mode == SCORE_UNIFORM else base * len(a)

    def _delete(self, a):
        return self.score_del if self.mode == SCORE_UNIFORM else self.score_del * len(a)

    def _insert(self, b):
        return self.score_ins if self.mode == SCORE_UNIFORM else self.score_ins * len(b)

    def _gap(self, elem):
        return self.separator * len(elem)

    def _compute_matrix(self, seq_a, seq_b, semi_global):
        len_a, len_b = len(seq_a), len(seq_b)
        if self.mode == SCORE_UNIFORM:
            # uniform: vectorized over elements
            eq = np.zeros((len_a, len_b), dtype=bool)
            for i, a in enumerate(seq_a):
                for j, b in enumerate(seq_b):
                    eq[i, j] = a == b
            sub = np.where(eq, self.score_null, self.score_sub).astype(np.int64)
            del_cost = np.full(len_a, self.score_del, dtype=np.int64)
            ins_cost = np.full(len_b, self.score_ins, dtype=np.int64)
        else:
            sub = np.empty((len_a, len_b), dtype=np.int64)
            for i, a in enumerate(seq_a):
                for j, b in enumerate(seq_b):
                    sub[i, j] = self._match(a, b)
            del_cost = np.array([self._delete(a) for a in seq_a], dtype=np.int64)
            ins_cost = np.array([self._insert(b) for b in seq_b], dtype=np.int64)

        m = np.zeros((len_a + 1, len_b + 1), dtype=np.int64)
        if not semi_global:
            m[1:, 0] = np.cumsum(del_cost)
            m[0, 1:] = np.cumsum(ins_cost)

        # only constant ins cost admits the running-max trick; PROPORTION mode
        # with per-element costs also works because cumsum(ins) is the chain cost
        ins_prefix = np.concatenate([[0], np.cumsum(ins_cost)])  # cost of ins chain up to j
        for i in range(1, len_a + 1):
            cand = np.empty(len_b + 1, dtype=np.int64)
            cand[0] = m[i, 0]
            cand[1:] = np.maximum(m[i - 1, :-1] + sub[i - 1], m[i - 1, 1:] + del_cost[i - 1])
            # m[i, j] = max_{k<=j} (cand[k] + ins_chain(k..j])
            m[i] = np.maximum.accumulate(cand - ins_prefix) + ins_prefix
        return m

    def align(self, seq_a, seq_b, semi_global=True, mode=None):
        if mode is not None:
            self.mode = mode
        len_a, len_b = len(seq_a), len(seq_b)
        if len_a == 0:
            return [self._gap(b) for b in seq_b], list(seq_b)
        if len_b == 0:
            return list(seq_a), [self._gap(a) for a in seq_a]

        m = self._compute_matrix(seq_a, seq_b, semi_global)

        aligned_a, aligned_b = [], []
        if semi_global:
            # free end gaps: start backtrack from the best cell on the far edge
            # of the shorter sequence (spec: metrics.py:573-585)
            if len_a < len_b:
                j = int(np.argmax(m[-1]))
                i = len_a
                aligned_a = [self._gap(b) for b in seq_b[j:]]
                aligned_b = list(seq_b[j:])
            else:
                i = int(np.argmax(m[:, -1]))
                j = len_b
                aligned_a = list(seq_a[i:])
                aligned_b = [self._gap(a) for a in seq_a[i:]]
        else:
            i, j = len_a, len_b

        while i > 0 or j > 0:
            if semi_global and (i == 0 or j == 0):
                # free leading gaps
                aligned_a = [self._gap(b) for b in seq_b[:j]] + list(seq_a[:i]) + aligned_a
                aligned_b = list(seq_b[:j]) + [self._gap(a) for a in seq_a[:i]] + aligned_b
                break
            if j > 0 and m[i, j] == m[i, j - 1] + self._insert(seq_b[j - 1]):
                aligned_a.insert(0, self._gap(seq_b[j - 1]))
                aligned_b.insert(0, seq_b[j - 1])
                j -= 1
            elif i > 0 and m[i, j] == m[i - 1, j] + self._delete(seq_a[i - 1]):
                aligned_a.insert(0, seq_a[i - 1])
                aligned_b.insert(0, self._gap(seq_a[i - 1]))
                i -= 1
            elif i > 0 and j > 0 and m[i, j] == m[i - 1, j - 1] + self._match(seq_a[i - 1], seq_b[j - 1]):
                aligned_a.insert(0, seq_a[i - 1])
                aligned_b.insert(0, seq_b[j - 1])
                i -= 1
                j -= 1
            else:
                raise RuntimeError(f'backtrack error at ({i}, {j})')

        return aligned_a, aligned_b

    def map_alignment(self, aligned_seq_a, aligned_seq_b):
        """Map positions of seq_b to indices in seq_a (spec: metrics.py:516-539)."""
        map_b2a, idx = [], 0
        for x, y in zip(aligned_seq_a, aligned_seq_b):
            if x == y:
                map_b2a.append(idx)
                idx += 1
            elif x == self.separator:
                map_b2a.append(idx)
            elif y == self.separator:
                idx += 1
        return map_b2a
