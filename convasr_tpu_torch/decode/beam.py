"""Beam-search CTC decoders (counterpart of convasr_tpu/decode/beam.py): the
host C++ prefix beam with word n-gram LM fusion or rescoring, the hybrid of
the device beam and host word-LM rescoring, and the Python executable spec.

`BeamSearchDecoder` runs native/ctc_beam.cpp (the JAX package's source,
copied), compiled by g++ at first use into build/native/ and bound with
ctypes; a failed build raises. `prefix_beam_search` is the pure-Python spec
the C++ beam is held against in the tests; nothing falls back to it.
`decode_device_with_lm` and `tune_rescore_weights` run the device beam
(ops/beam_device.py) on the log-probs' device and rescore on the host.
"""
import ctypes
import math
import typing

import numpy as np
import torch

from ..metrics.wer import wer as wer_fn
from ..native.build import load_library
from ..ops import beam_device
from ..text.binlm import BinaryLM, is_binary_lm
from ..text.ngram_lm import SPACE_TOKEN

NEG_INF = -1e30


def _logsumexp(a, b):
    if a <= NEG_INF / 2:
        return b
    if b <= NEG_INF / 2:
        return a
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


class ArpaLM:
    """Minimal ARPA n-gram LM with Katz backoff (Python mirror of the C++
    loader). Scores are natural log."""

    LOG10 = math.log(10.0)

    def __init__(self, path: str):
        self.path = str(path)   # the native rescorer reads the same file
        self.ngrams: typing.Dict[tuple, typing.Tuple[float, float]] = {}
        self.order = 0
        current = 0
        opener = __import__('gzip').open if str(path).endswith('.gz') else open
        with opener(path, 'rt') as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith('\\data\\'):
                    continue
                if line.startswith('\\end\\'):
                    break
                if line.startswith('\\') and line.endswith('-grams:'):
                    current = int(line[1:line.index('-')])
                    self.order = max(self.order, current)
                    continue
                if current == 0:
                    continue
                parts = line.split()
                if len(parts) < 1 + current:
                    continue
                logp = float(parts[0]) * self.LOG10
                words = tuple(parts[1:1 + current])
                backoff = float(parts[1 + current]) * self.LOG10 \
                    if len(parts) > 1 + current else 0.0
                self.ngrams[words] = (logp, backoff)

    def score(self, context_words: typing.Sequence[str]) -> float:
        """log P(w_last | preceding words), backoff chain."""
        words = tuple(context_words[-self.order:])
        while words:
            if words in self.ngrams:
                return self.ngrams[words][0]
            backoff = self.ngrams.get(words[:-1], (0.0, 0.0))[1] if len(words) > 1 else 0.0
            if len(words) == 1:
                unk = self.ngrams.get(('<unk>',))
                return unk[0] if unk else -10.0 * self.LOG10
            return backoff + self.score(words[1:])
        return NEG_INF


def load_lm(path: str):
    """ARPA text / .arpa.gz -> ArpaLM; a CNLM binary (magic-detected) ->
    text.binlm.BinaryLM. Both expose .score(context_words) and .order."""
    if is_binary_lm(path):
        return BinaryLM(path)
    return ArpaLM(path)


def char_lm_table(lm: 'ArpaLM', vocab: typing.Sequence[str]) -> np.ndarray:
    """Densify a CHAR-level ARPA bigram LM into a (V+1, V) conditional
    log-prob table for the device beam's shallow fusion (ops/beam_device.py):
    table[c1, c2] = logP(vocab[c2] | vocab[c1]) with Katz backoff resolved at
    build time; row V is the empty-context (unigram) row. Each vocab symbol is
    one LM token, ' ' spelled SPACE_TOKEN (text/ngram_lm.char_tokenize)."""
    V = len(vocab)
    sym = [SPACE_TOKEN if str(w) == ' ' else str(w) for w in vocab]
    table = np.zeros((V + 1, V), np.float32)
    for c2, w2 in enumerate(sym):
        table[V, c2] = lm.score([w2])
        for c1, w1 in enumerate(sym):
            table[c1, c2] = lm.score([w1, w2])
    return table


def collapse_blanks(log_probs: np.ndarray, blank_id: int,
                    threshold: float = 0.999) -> np.ndarray:
    """Blank-collapse emission compression (arXiv:2210.17017): drop frames
    whose blank probability exceeds `threshold`, keeping ONE frame of each
    dropped run so repeated characters stay separated."""
    log_probs = np.asarray(log_probs)
    blank_lp = log_probs[:, blank_id]
    collapsible = blank_lp > math.log(threshold)
    keep = ~collapsible
    run_start = collapsible & np.concatenate([[True], ~collapsible[:-1]])
    keep |= run_start
    return log_probs[keep]


def prefix_beam_search(log_probs: np.ndarray, blank_id: int, beam_width: int = 16,
                       labels: typing.Optional[typing.Sequence[str]] = None,
                       lm: typing.Optional[ArpaLM] = None, alpha: float = 0.0,
                       beta: float = 0.0, cutoff_top_n: typing.Optional[int] = None,
                       cutoff_prob: float = 1.0, topk: int = 1):
    """Pure-Python CTC prefix beam search (the executable spec of the C++
    beam): (T, C) log-probs -> [(tokens, score)] best first, topk of them."""
    T, C = log_probs.shape
    space_id = labels.index(' ') if labels is not None and ' ' in labels else -1
    # beams: prefix(tuple) -> [p_b, p_nb, lm_score, words(tuple)]
    beams = {(): [0.0, NEG_INF, 0.0, ()]}

    def lm_extend(prefix, words, lm_score):
        if lm is None:
            return words, lm_score
        chars = []
        for tok in reversed(prefix):
            if tok == space_id:
                break
            chars.append(labels[tok])
        word = ''.join(reversed(chars))
        if not word:
            return words, lm_score
        new_words = words + (word,)
        return new_words, lm_score + alpha * lm.score(new_words) + beta

    for t in range(T):
        lp = log_probs[t]
        order = np.argsort(lp)[::-1]
        ncand = min(cutoff_top_n or C, C)
        if cutoff_prob < 1.0:
            cum, keep = 0.0, 0
            for keep in range(ncand):
                cum += math.exp(lp[order[keep]])
                if cum >= cutoff_prob:
                    break
            ncand = max(1, keep + 1)
        cand = order[:ncand]

        next_beams: dict = {}

        def entry(prefix, parent, ext_char):
            if prefix in next_beams:
                return next_beams[prefix]
            _, _, lm_score, words = parent
            if ext_char == space_id and ext_char >= 0:
                words, lm_score = lm_extend(prefix[:-1], words, lm_score)
            e = [NEG_INF, NEG_INF, lm_score, words]
            next_beams[prefix] = e
            return e

        for prefix, vals in beams.items():
            p_b, p_nb, lm_score, words = vals
            p_total = _logsumexp(p_b, p_nb)
            for c in cand:
                c = int(c)
                p = float(lp[c])
                if c == blank_id:
                    e = entry(prefix, vals, -1)
                    e[0] = _logsumexp(e[0], p_total + p)
                elif prefix and c == prefix[-1]:
                    e = entry(prefix, vals, -1)
                    e[1] = _logsumexp(e[1], p_nb + p)
                    if p_b > NEG_INF / 2:
                        ext = prefix + (c,)
                        e2 = entry(ext, vals, c)
                        e2[1] = _logsumexp(e2[1], p_b + p)
                else:
                    ext = prefix + (c,)
                    e = entry(ext, vals, c)
                    e[1] = _logsumexp(e[1], p_total + p)

        scored = sorted(next_beams.items(),
                        key=lambda kv: -(_logsumexp(kv[1][0], kv[1][1]) + kv[1][2]))
        beams = dict(scored[:beam_width])

    out = [(list(prefix), _logsumexp(v[0], v[1]) + v[2])
           for prefix, v in sorted(beams.items(),
                                   key=lambda kv: -(_logsumexp(kv[1][0], kv[1][1]) + kv[1][2]))]
    return out[:topk]


def rescore_with_lm(hyps: typing.List[typing.Tuple[typing.List[int], float]],
                    labels: typing.Sequence[str], lm: 'ArpaLM',
                    alpha: float, beta: float):
    """Re-rank (tokens, ctc_score) hypotheses with a word n-gram LM:
    total = ctc + alpha * sum logP(word|ctx) + beta * num_words. The label
    pieces are joined and split on spaces, as the JAX package does (wrong for
    BPE heads; ROADMAP queue 3)."""
    texts = [''.join(labels[t] for t in tokens) for tokens, _ in hyps]
    lm_scores, word_counts = lm_word_scores(texts, lm)
    rescored = [(tokens, ctc_score + alpha * float(s) + beta * int(w))
                for (tokens, ctc_score), s, w
                in zip(hyps, lm_scores, word_counts)]
    rescored.sort(key=lambda h: -h[1])
    return rescored


def lm_word_scores(texts: typing.Sequence[str], lm: 'ArpaLM'):
    """Per text: (sum of logP(word | preceding words), word count) under the
    word n-gram LM, in C++ over the LM file (ctc_beam.cpp lm_rescore). The
    Python loop scores an LM whose file the C++ loader does not read (a
    .arpa.gz)."""
    native = load_native_lm(getattr(lm, 'path', None))
    if native is not None:
        return native.rescore(texts)
    lm_scores, word_counts = [], []
    for text in texts:
        words = text.split()
        lm_scores.append(sum(lm.score(words[:i + 1])
                             for i in range(len(words))))
        word_counts.append(len(words))
    return (np.asarray(lm_scores, np.float32),
            np.asarray(word_counts, np.int32))


def frame_lengths(log_probs, output_lengths):
    """(B,) int32 valid frames on the log-probs' device (all T when None)."""
    B, T = log_probs.shape[:2]
    if output_lengths is None:
        return torch.full((B,), T, dtype=torch.int32, device=log_probs.device)
    return torch.as_tensor(output_lengths).to(device=log_probs.device, dtype=torch.int32)


def tune_rescore_weights(log_probs, output_lengths, refs, tokenizer, to_text,
                         lm_path, beam_widths=(16, 32, 64),
                         alphas=(0.2, 0.3, 0.5, 0.7, 1.0, 1.5, 2.0),
                         betas=(0.0, 0.25, 0.5, 1.0, 1.5, 2.0, 3.0),
                         cutoff_top_n=8, max_len=None, holdout=True):
    """Dev-tune the hybrid decoder's (alpha, beta) PER BEAM WIDTH.

    The rescoring rule `ctc + alpha*lm + beta*n_words` has a deletion bias
    (fewer words score a higher lm term, and wider beams surface more short
    candidates), so the word bonus beta must rise with K. Per K the device
    beam runs once over the dev posteriors (log_probs (B, T, C), on any
    device), each candidate is scored with the word LM once, and the grid is
    swept in numpy. With holdout=True (>= 4 utterances) the grid is tuned on
    the even utterances and `eval_wer` reports the odd ones. to_text maps a
    token-id list to the final text and serves the WER only; the ranking
    features come from the raw lowercased label join, as rescore_with_lm's.
    Returns {K: dict(alpha, beta, dev_wer, eval_wer, oracle_wer)}."""
    log_probs = torch.as_tensor(log_probs, dtype=torch.float32)
    B = len(log_probs)
    lengths = frame_lengths(log_probs, output_lengths)
    lm = load_lm(lm_path)
    labels = [str(l).lower() for l in tokenizer.vocab]
    split = holdout and B >= 4
    dev_idx = list(range(0, B, 2)) if split else list(range(B))
    eval_idx = list(range(1, B, 2)) if split else list(range(B))
    out = {}
    for K in beam_widths:
        tks, lens, scores = (t.cpu().numpy() for t in beam_device.beam_search_device(
            log_probs, lengths, tokenizer.eps_id, beam_width=K, cutoff_top_n=cutoff_top_n,
            max_len=max_len or int(log_probs.shape[1]) + 1, compact_tokens=True))
        utts = []
        for b in range(B):
            toks = [tks[b, k, :lens[b, k]].tolist() for k in range(K)]
            raw = [''.join(labels[t] for t in ts) for ts in toks]
            lm_s, n_words = lm_word_scores(raw, lm)
            utts.append(dict(
                ctc=scores[b, :K].astype(np.float64),
                lm=np.asarray(lm_s, np.float64),
                W=np.asarray(n_words, np.float64),
                wer=np.asarray([wer_fn(hyp=to_text(ts), ref=refs[b])
                                for ts in toks])))

        def rank_wer(idx, a, bb):
            return float(np.mean([
                utts[i]['wer'][int(np.argmax(
                    utts[i]['ctc'] + a * utts[i]['lm'] + bb * utts[i]['W']))]
                for i in idx]))

        best = min(((rank_wer(dev_idx, a, bb), a, bb)
                    for a in alphas for bb in betas), key=lambda t: t[0])
        out[K] = dict(alpha=best[1], beta=best[2], dev_wer=best[0],
                      eval_wer=rank_wer(eval_idx, best[1], best[2]),
                      oracle_wer=float(np.mean(
                          [u['wer'].min() for u in utts])))
    return out


def decode_device_with_lm(log_probs, output_lengths, tokenizer,
                          lm_path: typing.Optional[str] = None,
                          alpha: float = 0.5, beta: float = 0.0,
                          beam_width: int = 16, cutoff_top_n: int = 8,
                          max_len: typing.Optional[int] = None):
    """Device beam + host word-LM rescoring; returns per-utterance token
    lists (best hypothesis). The beam runs where log_probs (B, T, C) lie (a
    numpy array goes to the CPU); only its top-K tokens, lengths and scores
    come to the host. max_len caps the hypothesis buffer (default T+1,
    exact). Tune (alpha, beta) per beam width (tune_rescore_weights)."""
    log_probs = torch.as_tensor(log_probs)
    tokens, lens, scores = (t.cpu().numpy() for t in beam_device.beam_search_device(
        log_probs, frame_lengths(log_probs, output_lengths), tokenizer.eps_id,
        beam_width=beam_width, cutoff_top_n=cutoff_top_n,
        max_len=max_len or int(log_probs.shape[1]) + 1, compact_tokens=True))
    lm = load_lm(lm_path) if lm_path else None
    labels = [str(l).lower() for l in tokenizer.vocab]
    out = []
    for b in range(len(tokens)):
        hyps = [(tokens[b, k, :lens[b, k]].tolist(), float(scores[b, k]))
                for k in range(tokens.shape[1])]
        if lm is not None:
            hyps = rescore_with_lm(hyps, labels, lm, alpha, beta)
        out.append(hyps[0][0])
    return out


# ------------------- native library binding -------------------

_word_lms: dict = {}   # path -> NativeWordLM (or None), one handle per process


def load_native():
    """The C++ beam library (native/ctc_beam.cpp), built at first use;
    raises if it cannot be built."""
    lib = load_library('ctc_beam.cpp')
    if lib.bsd_create.argtypes is None:
        lib.bsd_create.restype = ctypes.c_void_p
        lib.bsd_create.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                   ctypes.c_int, ctypes.c_char_p, ctypes.c_float,
                                   ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float]
        lib.bsd_decode.restype = ctypes.c_int
        lib.bsd_decode.argtypes = [ctypes.c_void_p,
                                   np.ctypeslib.ndpointer(np.float32, flags='C'),
                                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   np.ctypeslib.ndpointer(np.int32, flags='C'),
                                   np.ctypeslib.ndpointer(np.int32, flags='C'),
                                   np.ctypeslib.ndpointer(np.float32, flags='C')]
        lib.bsd_has_lm.restype = ctypes.c_int
        lib.bsd_has_lm.argtypes = [ctypes.c_void_p]
        lib.bsd_free.argtypes = [ctypes.c_void_p]
        lib.lm_create.restype = ctypes.c_void_p
        lib.lm_create.argtypes = [ctypes.c_char_p]
        lib.lm_order.restype = ctypes.c_int
        lib.lm_order.argtypes = [ctypes.c_void_p]
        lib.lm_rescore.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                                   np.ctypeslib.ndpointer(np.float32, flags='C'),
                                   np.ctypeslib.ndpointer(np.int32, flags='C')]
        lib.lm_destroy.argtypes = [ctypes.c_void_p]
    return lib


class NativeWordLM:
    """C++ word-LM batch rescorer over the mmap'd CNLM/ARPA file
    (native/ctc_beam.cpp lm_rescore): ArpaLM.score's Katz backoff chain
    without the per-word Python cost."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._handle = handle
        self.order = lib.lm_order(handle)

    def rescore(self, texts: typing.Sequence[str]):
        """-> (lm_scores f32 (N,), word_counts i32 (N,)): per text, the sum
        of logP(word | preceding words) and the word count."""
        blob = b'\0'.join(t.encode('utf-8') for t in texts) + b'\0'
        lm_scores = np.zeros(len(texts), np.float32)
        word_counts = np.zeros(len(texts), np.int32)
        if texts:
            self._lib.lm_rescore(self._handle, blob, len(texts),
                                 lm_scores, word_counts)
        return lm_scores, word_counts


def load_native_lm(path: typing.Optional[str]) -> typing.Optional[NativeWordLM]:
    """Process-cached native LM handle for `path`: None when the path is
    empty or the C++ loader does not read the file."""
    if not path:
        return None
    if path not in _word_lms:
        lib = load_native()
        handle = lib.lm_create(str(path).encode('utf-8'))
        _word_lms[path] = NativeWordLM(lib, handle) if handle else None
    return _word_lms[path]


class GreedyDecoder:
    """Top-K argmax decode."""

    def decode(self, log_probs, output_lengths=None, K: int = 1):
        log_probs = np.asarray(log_probs)  # (B, T, C)
        lengths = output_lengths if output_lengths is not None \
            else [log_probs.shape[1]] * len(log_probs)
        if K == 1:
            idx = log_probs.argmax(-1)
            return [idx[b, :int(l)].tolist() for b, l in enumerate(lengths)]
        topk = np.argsort(-log_probs, axis=-1)[..., :K]
        return [topk[b, :int(l)].tolist() for b, l in enumerate(lengths)]


class BeamSearchDecoder:
    """C++ prefix beam search with an optional word n-gram LM.

    `tokenizer` needs .vocab (label strings) and .eps_id (the blank). The LM
    (ARPA text, .arpa.gz or a CNLM binary) is fused in the beam, adding
    alpha * logP(word | context) + beta when a space closes a word, or, with
    rescore=True, the beam runs on the acoustics alone and its top
    `rescore_topk` complete hypotheses are re-ranked by rescore_with_lm.
    Utterances decode in parallel across `num_workers` threads (the C++ call
    releases the GIL). It takes host arrays: on_device is False."""

    on_device = False

    def __init__(self, tokenizer, lm_path: typing.Optional[str] = None,
                 beam_width: int = 128, beam_alpha: float = 0.0,
                 beam_beta: float = 0.0, cutoff_top_n: typing.Optional[int] = 40,
                 cutoff_prob: float = 1.0, num_workers: int = 1, topk: int = 1,
                 blank_collapse_threshold: typing.Optional[float] = 0.999,
                 rescore: bool = False, rescore_topk: int = 16):
        self.blank_collapse_threshold = blank_collapse_threshold
        self.num_workers = num_workers
        self.tokenizer = tokenizer
        self.labels = [str(l).lower() for l in tokenizer.vocab]
        self.blank_id = tokenizer.eps_id
        self.topk = topk
        self.beam_width = beam_width
        self.alpha, self.beta = beam_alpha, beam_beta
        self.cutoff_top_n = cutoff_top_n or len(self.labels)
        self.cutoff_prob = cutoff_prob
        # the C++ loader reads ARPA text or a CNLM binary; .arpa.gz is
        # decompressed to a temporary file
        if lm_path and str(lm_path).endswith('.gz'):
            import gzip
            import tempfile
            with gzip.open(lm_path, 'rb') as f:
                tmp = tempfile.NamedTemporaryFile(suffix='.arpa', delete=False)
                tmp.write(f.read())
                tmp.close()
            lm_path = tmp.name
        self.lm_path = lm_path
        self.rescore = bool(rescore and lm_path)
        self.rescore_topk = rescore_topk
        self.rescore_lm = load_lm(lm_path) if self.rescore else None
        beam_lm_path = '' if self.rescore else (lm_path or '')
        self.lib = load_native()
        arr = (ctypes.c_char_p * len(self.labels))(
            *[l.encode('utf-8') for l in self.labels])
        self.handle = self.lib.bsd_create(
            arr, len(self.labels), self.blank_id,
            beam_lm_path.encode(), beam_alpha, beam_beta, beam_width,
            self.cutoff_top_n, cutoff_prob)
        if beam_lm_path and not self.lib.bsd_has_lm(self.handle):
            raise ValueError(f'the C++ beam could not load the LM {beam_lm_path}')

    def decode_one(self, log_probs, length: typing.Optional[int] = None):
        """log_probs: (T, C) -> list of (tokens, score) of size topk."""
        lp = np.ascontiguousarray(np.asarray(log_probs, np.float32))
        if length is not None:
            lp = lp[:int(length)]
        if self.blank_collapse_threshold is not None:
            lp = np.ascontiguousarray(
                collapse_blanks(lp, self.blank_id, self.blank_collapse_threshold))
        T, C = lp.shape
        k = max(self.topk, self.rescore_topk) if self.rescore else self.topk
        k = min(k, self.beam_width)
        max_len = T + 1
        out_tokens = np.full((k, max_len), -1, np.int32)
        out_lens = np.zeros(k, np.int32)
        out_scores = np.zeros(k, np.float32)
        n = self.lib.bsd_decode(ctypes.c_void_p(self.handle), lp, T, C, k,
                                max_len, out_tokens, out_lens, out_scores)
        hyps = [(out_tokens[i, :out_lens[i]].tolist(), float(out_scores[i]))
                for i in range(n)]
        if self.rescore and hyps:
            hyps = rescore_with_lm(hyps, self.labels, self.rescore_lm,
                                   self.alpha, self.beta)
        return hyps[:self.topk]

    def decode(self, log_probs, output_lengths=None):
        """(B, T, C) -> per-utterance token list (topk=1) or list of lists."""
        log_probs = np.asarray(log_probs)
        lengths = output_lengths if output_lengths is not None \
            else [log_probs.shape[1]] * len(log_probs)

        def one(b_l):
            b, l = b_l
            hyps = self.decode_one(log_probs[b], l)
            tokens = [h[0] for h in hyps]
            return tokens[0] if self.topk == 1 else tokens

        work = list(enumerate(lengths))
        if self.num_workers > 1 and len(work) > 1:
            import concurrent.futures
            with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
                return list(pool.map(one, work))
        return [one(w) for w in work]

    def __del__(self):
        try:
            if getattr(self, 'handle', None) and getattr(self, 'lib', None) is not None:
                self.lib.bsd_free(ctypes.c_void_p(self.handle))
        except Exception:
            pass  # interpreter teardown may have released ctypes already
