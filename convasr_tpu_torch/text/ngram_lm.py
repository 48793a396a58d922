"""In-repo n-gram language-model trainer with ARPA output (copy of
convasr_tpu/text/ngram_lm.py: SPACE_TOKEN, char_tokenize, train_ngram_lm,
save_arpa).

Interpolated Kneser-Ney smoothing with Ney discount estimation, emitted as
standard ARPA, which decode/beam.ArpaLM, the C++ beam's loader
(native/ctc_beam.cpp) and char_lm_table (the device beam's char-bigram
fusion) read. A seen n-gram stores its full interpolated probability and each
context stores bow(c) = lambda(c), so an unseen continuation evaluates to
lambda(c) * p_lower(w | shorter context), the interpolation term.

Char-level LMs tokenize text into single characters with a printable
`SPACE_TOKEN` standing in for ' ': ARPA tokens are whitespace-split, so a
literal space cannot be an LM token. One line builds an ARPA:

    from convasr_tpu_torch.text.ngram_lm import save_arpa, train_ngram_lm
    save_arpa(train_ngram_lm([s.split() for s in sentences], order=3), 'word3.arpa')
"""
import gzip
import math
import typing
from collections import Counter, defaultdict

BOS, EOS, UNK = '<s>', '</s>', '<unk>'
SPACE_TOKEN = '<sp>'  # printable stand-in for ' ' in char-level LMs
LOG10 = math.log(10.0)


def char_tokenize(text: str) -> typing.List[str]:
    """Text -> per-character LM tokens (space mapped to SPACE_TOKEN)."""
    return [SPACE_TOKEN if ch == ' ' else ch for ch in text.strip()]


def _ney_discount(counts: typing.Iterable[int]) -> float:
    """Ney absolute-discount estimate D = n1 / (n1 + 2 n2), clamped."""
    n1 = n2 = 0
    for c in counts:
        if c == 1:
            n1 += 1
        elif c == 2:
            n2 += 1
    if n1 == 0 or (n1 + 2 * n2) == 0:
        return 0.75
    return min(0.9, max(0.1, n1 / (n1 + 2.0 * n2)))


def train_ngram_lm(sentences: typing.Iterable[typing.Sequence[str]],
                   order: int = 3) -> str:
    """Train an interpolated Kneser-Ney n-gram LM; returns ARPA text.

    `sentences` are token sequences (words, or char_tokenize() output for
    char-level models). The highest order uses raw counts; lower orders use
    Kneser-Ney continuation counts; the unigram level interpolates with the
    uniform distribution so <unk> (and every vocabulary word) has mass.
    """
    assert order >= 1
    sentences = [list(s) for s in sentences if len(s)]
    raw = [Counter() for _ in range(order + 1)]  # raw[k]: k-gram counts
    for sent in sentences:
        for k in range(1, order + 1):
            padded = [BOS] * (k - 1) + sent + [EOS]
            for i in range(len(padded) - k + 1):
                raw[k][tuple(padded[i:i + k])] += 1

    vocab = sorted(set(w for c in raw[1] for w in c) | {UNK})
    V = len(vocab)

    # effective counts: raw at the highest order, continuation counts below
    # (count of distinct left-extensions w0 of the gram in raw[k+1])
    eff = [Counter() for _ in range(order + 1)]
    eff[order] = raw[order]
    for k in range(order - 1, 0, -1):
        cont = Counter()
        for gram in raw[k + 1]:
            cont[gram[1:]] += 1
        # grams that never appear as a continuation (start with <s>, or the
        # top order is too low to cover them) fall back to raw counts so the
        # ARPA stays connected (every higher-order context must have an entry)
        eff[k] = Counter({g: cont.get(g, 0) or raw[k][g] for g in raw[k]})

    discounts = [0.0] * (order + 1)
    for k in range(1, order + 1):
        discounts[k] = _ney_discount(eff[k].values())

    # per-context totals and distinct-continuation counts on effective counts
    totals = [defaultdict(int) for _ in range(order + 1)]
    n1plus = [defaultdict(int) for _ in range(order + 1)]
    for k in range(1, order + 1):
        for gram, c in eff[k].items():
            totals[k][gram[:-1]] += c
            n1plus[k][gram[:-1]] += 1

    # unigram distribution: KN continuation prob interpolated with uniform
    uni_total = totals[1][()]
    D1 = discounts[1]
    lam_uni = D1 * n1plus[1][()] / uni_total if uni_total else 1.0
    uniform = 1.0 / (V + 1)

    def p_uni(w: str) -> float:
        c = eff[1].get((w,), 0)
        return max(c - D1, 0.0) / uni_total + lam_uni * uniform \
            if uni_total else uniform

    def p_interp(gram: tuple) -> float:
        k = len(gram)
        if k == 1:
            return p_uni(gram[0])
        ctx = gram[:-1]
        denom = totals[k][ctx]
        if denom == 0:
            return p_interp(gram[1:])
        D = discounts[k]
        lam = D * n1plus[k][ctx] / denom
        return max(eff[k].get(gram, 0) - D, 0.0) / denom + lam * p_interp(gram[1:])

    def bow(ctx: tuple) -> float:
        k = len(ctx) + 1
        denom = totals[k].get(ctx, 0)
        if denom == 0:
            return 1.0
        return discounts[k] * n1plus[k][ctx] / denom

    def log10p(p: float) -> float:
        return math.log10(max(p, 1e-99))

    sections = []
    entries: typing.List[typing.List[str]] = []
    # unigrams: full vocab + specials. <s> is context-only: prob placeholder
    # -99 (lmplz convention), bow real.
    uni_lines = []
    for w in [UNK] + [w for w in vocab if w != UNK] + [BOS]:
        if w == BOS and (BOS,) not in raw[1] and order > 1:
            # <s> appears only as context padding; raw[1] never counts it
            pass
        lp = -99.0 if w == BOS else log10p(p_uni(w))
        line = f'{lp:.7f}\t{w}'
        if order > 1:
            b = bow((w,))
            if b != 1.0:
                line += f'\t{log10p(b):.7f}'
        uni_lines.append(line)
    entries.append(uni_lines)

    for k in range(2, order + 1):
        lines = []
        for gram in sorted(raw[k]):
            line = f'{log10p(p_interp(gram)):.7f}\t{" ".join(gram)}'
            if k < order:
                b = bow(gram)
                if b != 1.0:
                    line += f'\t{log10p(b):.7f}'
            lines.append(line)
        entries.append(lines)

    out = ['\\data\\']
    for k in range(1, order + 1):
        out.append(f'ngram {k}={len(entries[k - 1])}')
    for k in range(1, order + 1):
        out += ['', f'\\{k}-grams:'] + entries[k - 1]
    out += ['', '\\end\\', '']
    return '\n'.join(out)


def save_arpa(arpa_text: str, path: str) -> str:
    if str(path).endswith('.gz'):
        with gzip.open(path, 'wt') as f:
            f.write(arpa_text)
    else:
        with open(path, 'w') as f:
            f.write(arpa_text)
    return path
