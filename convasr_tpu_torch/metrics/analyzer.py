"""Word/error tagging and transcript error analytics (a copy of
convasr_tpu/metrics/analyzer.py).

Behavior spec: the reference convasr metrics.py — ErrorTagger metrics.py:17-56,
WordTagger metrics.py:59-76, ErrorAnalyzer metrics.py:78-232, align_words
metrics.py:261-362, align_strings metrics.py:365-407.

A hypothesis/reference pair is char-aligned with Needleman-Wunsch (word-level
first, then char-level inside mismatched stretches), split into aligned word
pairs, and every word pair is tagged: ok / typo_easy / typo_hard / missing /
missing_ref. Aggregated metrics (wer_wordwise, mer, pseudo/filtered cer...)
are computed over configurable tag filters (configs/ru_val_config.json).
"""
import collections
import typing

from .needleman import Needleman
from .wer import cer, wer, nanmean

PLACEHOLDER = '|'
SPACE = ' '
SILENCE = PLACEHOLDER + SPACE


def _strip_placeholder(s: str, rep: str = '') -> str:
    return s.replace(PLACEHOLDER, rep)


class WordTagger(collections.defaultdict):
    """Tags words as vocab_hit/vocab_miss plus configured stem-based tags."""

    vocab_hit = 'vocab_hit'
    vocab_miss = 'vocab_miss'
    stop = 'stop'

    def __init__(self, stemmer=None, word_tags: dict = {}, vocab: set = set()):
        super().__init__()
        self.stemmer = stemmer if stemmer is not None else (lambda word: word)
        self.vocab = vocab
        self.stem2tag = {self.stemmer(word): tag for tag, words in word_tags.items() for word in words}

    def __missing__(self, word):
        self[word] = self.stem2tag.get(self.stemmer(word))
        return self[word]

    def tag(self, word: str) -> typing.List[str]:
        tags = [self.vocab_hit if word in self.vocab else self.vocab_miss]
        word_tag = self[word]
        if word_tag:
            tags.append(word_tag)
        return tags


class ErrorTagger:
    """Classifies an aligned word pair into ok/typo_easy/typo_hard/missing/missing_ref.

    Spec: metrics.py:26-56; inputs are placeholder-aligned word strings.
    """

    typo_easy = 'typo_easy'
    typo_hard = 'typo_hard'
    missing = 'missing'
    missing_ref = 'missing_ref'
    ok = 'ok'
    error_tags = [typo_easy, typo_hard, missing, missing_ref]

    def tag(self, *, hyp: str, ref: str, hyp_tags=[], ref_tags=[], p=0.5, L=3, clamp=False):
        errors = sum(ch != cr for ch, cr in zip(hyp, ref) if not (ch == SPACE and cr == PLACEHOLDER))
        errors_no_ph = sum(ch != cr for ch, cr in zip(hyp, ref) if ch not in SILENCE and cr not in SILENCE)
        ok_except_end = all(ch == cr or i >= len(ref) - 2 or (ch == SPACE and cr == PLACEHOLDER)
                            for i, (ch, cr) in enumerate(zip(hyp, ref)))

        ref_placeholders = ref.count(PLACEHOLDER)
        ref_chars = len(ref) - ref_placeholders
        hyp_empty = hyp.count(PLACEHOLDER) == len(hyp)
        ref_empty = ref_placeholders == len(ref)

        hyp_vocab_hit = WordTagger.vocab_hit in hyp_tags or WordTagger.stop in hyp_tags
        vocab_typo_easy = (ref_empty and hyp_vocab_hit) or (hyp_empty and WordTagger.stop in ref_tags)

        short_typo = len(ref) == 1 or (ref_chars == 0 and len(hyp) < L) or (0 < ref_chars < L and len(hyp) <= L)
        short_few_replacements = ref_chars < L and errors_no_ph <= 1
        is_typo = vocab_typo_easy or short_typo or (
            hyp.count(PLACEHOLDER) < p * len(ref) and ref_placeholders < p * len(ref))

        if hyp == ref:
            error_tag = self.ok
        elif is_typo:
            easy = (vocab_typo_easy or short_few_replacements or errors <= 1
                    or (len(ref) > 2 and errors == 2 and ok_except_end)
                    or (len(ref) >= 5 and errors <= 2))
            error_tag = self.typo_easy if easy else self.typo_hard
        else:
            error_tag = self.missing_ref if ref_placeholders >= p * len(ref) else self.missing

        if clamp:
            errors = errors if error_tag in (self.typo_easy, self.ok) else -1 if error_tag == self.typo_hard else -2
        return error_tag, errors


def align_strings(*, hyp: str, ref: str,
                  char_align_coefs=(5, -3, -4, -3),
                  word_align_coefs=(100, -6, -8, -3)) -> typing.Tuple[str, str]:
    """Two-level alignment: words first, then chars inside mismatched stretches.

    Returns equal-length strings where '|' marks gaps. Coef tuples are
    (null, sub, del, ins); the defaults reproduce the reference's *effective*
    values (metrics.py:365-372 assigns score_sub twice — a bug that leaves
    score_ins at -3 and makes the second tuple element dead; we keep the
    resulting behavior but name the fields honestly).
    """
    aligner = Needleman(separator=PLACEHOLDER)
    aligner.set_score(*word_align_coefs)
    hyp_words, ref_words = aligner.align(hyp.split(), ref.split())

    aligner.set_score(*char_align_coefs)
    out_hyp, out_ref, hyp_buf, ref_buf = [], [], [], []

    def flush():
        if hyp_buf or ref_buf:
            a, b = aligner.align(list(SPACE.join(hyp_buf)), list(SPACE.join(ref_buf)))
            out_hyp.append(''.join(a))
            out_ref.append(''.join(b))
            hyp_buf.clear()
            ref_buf.clear()

    for h, r in zip(hyp_words, ref_words):
        if h == r:
            flush()
            out_hyp.append(h)
            out_ref.append(r)
        elif PLACEHOLDER in h:  # hyp-side gap
            ref_buf.append(r)
        elif PLACEHOLDER in r:  # ref-side gap
            hyp_buf.append(h)
        else:
            hyp_buf.append(h)
            ref_buf.append(r)
    flush()

    joined_hyp, joined_ref = SPACE.join(out_hyp), SPACE.join(out_ref)
    assert len(joined_hyp) == len(joined_ref)
    return joined_hyp, joined_ref


def _split_into_word_pairs(*, _hyp_: str, _ref_: str, copy_space=False):
    """Split a pair of aligned strings into aligned word pairs (spec:
    metrics.py:265-315)."""
    assert len(_hyp_) == len(_ref_)
    hyp, ref = list(_hyp_), list(_ref_)

    ref_charinds = [i for i, c in enumerate(ref) if c != PLACEHOLDER]
    for i in range(len(ref)):
        if (not ref_charinds or i < ref_charinds[0] or i > ref_charinds[-1]) \
                and hyp[i] == SPACE and ref[i] == PLACEHOLDER:
            ref[i] = SPACE

    if copy_space and ref_charinds:
        before, after = ref_charinds[0] - 1, ref_charinds[-1] + 1
        hyp_s, ref_s = _strip_placeholder(''.join(hyp)), _strip_placeholder(''.join(ref))
        if hyp_s.endswith(ref_s) and before >= 0 and hyp[before] not in SILENCE:
            ref[before] = SPACE
        if hyp_s.startswith(ref_s) and after < len(hyp) and hyp[after] not in SILENCE:
            ref[after] = SPACE

    ref.append(SPACE)
    hyp.append(SPACE)
    k, words = 0, []
    for i in range(len(ref)):
        if ref[i] != SPACE:
            continue
        take_to = i + 1
        if hyp[i] in SILENCE:
            j = i
        elif ref_charinds and i < ref_charinds[0]:
            j = i + 1
        else:
            j = i
            take_to = i
            ref[i] = PLACEHOLDER
        if k != j:
            words.append((''.join(hyp[k:j]), ''.join(ref[k:j])))
        k = take_to
    return words


def _prefer_replacement(*, hyp, ref):
    """Slide adjacent ins+del pairs together into substitutions (spec:
    metrics.py:317-327)."""
    hyp, ref = list(hyp), list(ref)
    for k in range(len(ref) - 1):
        if ref[k] == PLACEHOLDER and hyp[k] != PLACEHOLDER and ref[k + 1] != PLACEHOLDER and hyp[k + 1] == PLACEHOLDER:
            ref[k], ref[k + 1] = ref[k + 1], PLACEHOLDER
        elif hyp[k] == PLACEHOLDER and ref[k] != PLACEHOLDER and hyp[k + 1] != PLACEHOLDER and ref[k + 1] == PLACEHOLDER:
            hyp[k], hyp[k + 1] = hyp[k + 1], PLACEHOLDER
    pairs = [(ch, cr) for ch, cr in zip(hyp, ref) if not (ch == cr == PLACEHOLDER)]
    return ''.join(p[0] for p in pairs), ''.join(p[1] for p in pairs)


def align_words(_hyp_: str, _ref_: str, word_tagger: WordTagger = None,
                error_tagger: ErrorTagger = None, postproc: bool = False,
                compute_cer: bool = False) -> typing.List[dict]:
    """Turn aligned strings into a per-word alignment with tags (spec:
    metrics.py:261-362)."""
    word_tagger = word_tagger if word_tagger is not None else WordTagger()
    error_tagger = error_tagger if error_tagger is not None else ErrorTagger()
    assert len(_hyp_) == len(_ref_)

    pairs = _split_into_word_pairs(_hyp_=_hyp_, _ref_=_ref_, copy_space=False)
    if postproc:
        refined = []
        for hyp_word, ref_word in pairs:
            hyp_word, ref_word = _prefer_replacement(hyp=hyp_word, ref=ref_word)
            refined.extend(_split_into_word_pairs(_hyp_=hyp_word, _ref_=ref_word, copy_space=True))
        pairs = refined

    alignment = []
    for hyp_word, ref_word in pairs:
        assert len(hyp_word) == len(ref_word)
        w = dict(_hyp_=hyp_word, _ref_=ref_word,
                 hyp=_strip_placeholder(hyp_word), ref=_strip_placeholder(ref_word))
        w['ref_tags'] = word_tagger.tag(w['ref'])
        w['hyp_tags'] = word_tagger.tag(w['hyp'])
        # NOTE: deliberate fix vs the reference. metrics.py:351 tags the
        # placeholder-STRIPPED strings, which makes the missing/missing_ref
        # branches of ErrorTagger unreachable (they count placeholders). The
        # tagger's logic expects the aligned strings, so we pass those.
        w['error_tags'] = [error_tagger.tag(hyp=w['_hyp_'], ref=w['_ref_'],
                                            hyp_tags=w['hyp_tags'], ref_tags=w['ref_tags'])[0]]
        w['error_tag'] = w['error_tags'][0]
        w['len'] = len(w['ref'])
        if compute_cer:
            w['cer'] = cer(hyp=w['hyp'], ref=w['ref'])
        alignment.append(w)
    return alignment


class ErrorAnalyzer:
    """Per-utterance and aggregated error analytics (spec: metrics.py:78-232)."""

    def __init__(self, word_tagger=None, error_tagger=None, configs: dict = {}, postprocessors: dict = {}):
        self.word_tagger = word_tagger if word_tagger is not None else WordTagger()
        self.error_tagger = error_tagger if error_tagger is not None else ErrorTagger()
        self.configs = configs or dict(default={})
        self.postprocessors = postprocessors

    def filter_words(self, word_alignment, word_include_tags=[], word_exclude_tags=[],
                     error_include_tags=[], error_exclude_tags=[], **kwargs):
        wi, we, ei, ee = map(set, [word_include_tags, word_exclude_tags, error_include_tags, error_exclude_tags])
        out = []
        for w in word_alignment:
            if set(w['ref_tags']) & we or set(w['error_tags']) & ee:
                continue
            if (wi and not set(w['ref_tags']) & wi) or (ei and not set(w['error_tags']) & ei):
                continue
            out.append(w)
        return out

    def compute_wordwise_metrics(self, filtered_alignment) -> dict:
        n = len(filtered_alignment)
        n_ok = sum(ErrorTagger.ok in w['error_tags'] for w in filtered_alignment)
        n_missing = sum(ErrorTagger.missing in w['error_tags'] for w in filtered_alignment)
        return dict(
            num_words=n, num_words_ok=n_ok, num_words_missing=n_missing,
            mer_wordwise=n_missing / n if n else 0,
            wer_wordwise=1.0 - n_ok / n if n else 0,
            cer_wordwise=sum(w['cer'] for w in filtered_alignment) / n if n else 0,
        )

    def compute_pseudo_metrics(self, word_alignment, filtered_alignment, postprocess_transcript, **kwargs):
        """Metrics if all FILTERED words were replaced by ground truth."""
        filtered = set(map(id, filtered_alignment))
        hyp_p = SPACE.join(w['ref'] if id(w) in filtered else w['hyp'] for w in word_alignment)
        ref_p = SPACE.join(w['ref'] for w in word_alignment)
        hyp_p, ref_p = postprocess_transcript(hyp_p), postprocess_transcript(ref_p)
        return dict(cer_pseudo=cer(hyp=hyp_p, ref=ref_p), wer_pseudo=wer(hyp=hyp_p, ref=ref_p))

    def compute_filtered_metrics(self, word_alignment, filtered_alignment, postprocess_transcript, **kwargs):
        """Metrics if all NOT-filtered words were replaced by ground truth."""
        filtered = set(map(id, filtered_alignment))
        hyp_f = SPACE.join(w['hyp'] if id(w) in filtered else w['ref'] for w in word_alignment)
        ref_f = SPACE.join(w['ref'] for w in word_alignment)
        hyp_f, ref_f = postprocess_transcript(hyp_f), postprocess_transcript(ref_f)
        return dict(cer_filtered=cer(hyp=hyp_f, ref=ref_f), wer_filtered=wer(hyp=hyp_f, ref=ref_f))

    def compute_vocabness_metrics(self, word_alignment, filtered_alignment, postprocess_transcript, **kwargs):
        n = len(filtered_alignment)
        hyp_v, ref_v = [sum(self.word_tagger.vocab_hit in w[k] for w in filtered_alignment) / n if n else 0
                        for k in ['hyp_tags', 'ref_tags']]
        return dict(ref_vocabness=ref_v, hyp_vocabness=hyp_v)

    def analyze(self, hyp: str, ref: str, postprocess_fn=None, detailed=False,
                extra: dict = {}, split_candidates=None) -> dict:
        if split_candidates is None:
            split_candidates = lambda s: [s]
        hyp, ref = min((cer(hyp=h, ref=r), (h, r))
                       for r in split_candidates(ref) for h in split_candidates(hyp))[1]
        pp_ref = postprocess_fn(ref) if postprocess_fn is not None else ref
        pp_hyp = postprocess_fn(hyp) if postprocess_fn is not None else hyp
        res = dict(ref=pp_ref, hyp=pp_hyp, ref_orig=ref, hyp_orig=hyp,
                   cer=cer(hyp=pp_hyp, ref=pp_ref), wer=wer(hyp=pp_hyp, ref=pp_ref), **extra)
        if not detailed:
            return res

        _hyp_, _ref_ = align_strings(hyp=pp_hyp, ref=pp_ref)
        word_alignment = align_words(_hyp_, _ref_, word_tagger=self.word_tagger,
                                     error_tagger=self.error_tagger, compute_cer=True)
        res['alignment'] = word_alignment
        stats = dict(ok=0, replace=0, delete=0, insert=0, delete_spaces=0, insert_spaces=0, total_spaces=0)
        for ch, cr in zip(_hyp_, _ref_):
            stats['ok'] += (cr == ch)
            stats['replace'] += (cr != PLACEHOLDER and cr != ch and ch != PLACEHOLDER)
            stats['delete'] += (cr != PLACEHOLDER and cr != ch and ch == PLACEHOLDER)
            stats['insert'] += (cr == PLACEHOLDER and ch != PLACEHOLDER)
            stats['delete_spaces'] += (cr == SPACE and ch != SPACE)
            stats['insert_spaces'] += (ch == SPACE and cr != SPACE)
            stats['total_spaces'] += (cr == SPACE)
        res['char_stats'] = stats

        for config_name, config in self.configs.items():
            postprocessor = self.postprocessors[config['postprocessor']] if 'postprocessor' in config \
                else (lambda word: word)
            filtered = self.filter_words(word_alignment, **config)
            res[config_name] = self.compute_wordwise_metrics(filtered)
            for metric_fn in [self.compute_filtered_metrics, self.compute_pseudo_metrics,
                              self.compute_vocabness_metrics]:
                res[config_name].update(metric_fn(word_alignment, filtered, postprocessor, **config))
        return res

    def aggregate(self, analyzed: typing.List[dict], sep='__', defaults: dict = {}) -> dict:
        if not analyzed:
            return dict(defaults, cer=-1.0, wer=-1.0, loss=-1.0, entropy=-1.0,
                        errors=dict(distribution={}, words=[]))
        numeric_keys = lambda d: [k for k, v in d.items() if isinstance(v, (int, float))]
        keys = numeric_keys(analyzed[0])
        for c in self.configs:
            keys.extend(c + sep + k for k in numeric_keys(analyzed[0].get(c, {})))

        stats = dict(defaults)
        stats.update({k: nanmean(analyzed, k, sep=sep) for k in keys})
        prefix = 'default' + sep
        stats.update({name[len(prefix):]: value for name, value in list(stats.items())
                      if name.startswith(prefix)})

        error_chars, error_words = collections.defaultdict(int), []
        for a in analyzed:
            for w in a.get('alignment', []):
                # aligned strings when available (see note in align_words)
                error_tag, errors = self.error_tagger.tag(
                    hyp=w.get('_hyp_', w['hyp']), ref=w.get('_ref_', w['ref']), clamp=True)
                error_chars[errors] += 1
                if error_tag != ErrorTagger.ok:
                    error_words.append(w)
        stats['errors'] = dict(distribution=dict(sorted(error_chars.items())), words=error_words)
        return stats
