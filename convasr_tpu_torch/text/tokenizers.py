"""Tokenizers: legacy char tokenizer and a self-contained BPE tokenizer.

Behavior spec: the reference convasr text_tokenizers.py (CharTokenizerLegacy
text_tokenizers.py:7-51, BPETokenizer text_tokenizers.py:54-94).

The reference delegates BPE to the SentencePiece C++ library. That library is
not a dependency here: `BPETokenizer` below is a self-contained byte-pair
tokenizer with the same external contract (word-start pieces are marked with
'▁', `is_start_word_token`, pad/unk/bos/eos ids) plus an in-repo trainer
(`train_bpe`), so `tools.py bpetrain` works without native third-party code.
"""
import collections
import json
import typing

WORD_START = '▁'  # same marker sentencepiece uses


class CharTokenizer:
    """Character tokenizer with the legacy convasr alphabet layout.

    Vocab = alphabet + [unk '*', punkt '.', repeat '2', space ' ', blank '|'];
    the CTC blank is the LAST class (matching blank=num_classes-1 in the
    reference loss call, models.py:323).
    """

    def __init__(self, alphabet: str):
        self.alphabet = alphabet
        self.unk_token, self.punkt_token, self.repeat_token = '*', '.', '2'
        self.space_token, self.eps_token = ' ', '|'
        self.idx2char = list(alphabet) + [
            self.unk_token, self.punkt_token, self.repeat_token, self.space_token, self.eps_token
        ]
        self.char2idx = {char: idx for idx, char in enumerate(self.idx2char)}
        self.unk_idx = self.char2idx[self.unk_token]
        self.space_id = self.char2idx[self.space_token]
        self.eps_id = self.char2idx[self.eps_token]

    @property
    def vocab(self):
        return self.idx2char

    @property
    def vocab_size(self):
        return len(self.idx2char)

    @property
    def silence_tokens_ids(self):
        return {self.eps_id, self.space_id}

    def is_start_word_token(self, idx):
        return idx == self.space_id

    def encode(self, sentences: typing.List[str], **kwargs) -> typing.List[typing.List[int]]:
        return [[self.char2idx.get(c, self.unk_idx) for c in s] for s in sentences]

    def decode(self, tokens: typing.Iterable[typing.List[int]], **kwargs) -> typing.List[str]:
        return [''.join(self.idx2char[i] for i in ts) for ts in tokens]


# keep the reference class name importable
CharTokenizerLegacy = CharTokenizer


def train_bpe(sentences: typing.Iterable[str], vocab_size: int, model_path: str = None,
              character_coverage: float = 1.0) -> dict:
    """Train a byte-pair-encoding model (replaces sentencepiece training,
    tools.py:282-287 in the reference).

    Returns (and optionally writes as JSON) a model dict with `pieces` (id ->
    piece string) and `merges` (ranked piece pairs). Ids 0-3 are reserved for
    <unk>, <s>, </s>, <pad> like sentencepiece defaults; the CTC blank reuses
    <pad> (the generator treats pad_id as silence, text_tokenizers.py:65-66).
    """
    # reserve the LAST id for a dedicated CTC blank: training uses blank =
    # num_classes-1 (reference models.py:323), and the reference silently
    # overloads its last sentencepiece piece as blank (targets can collide
    # with it); a reserved <blank> piece removes the collision.
    vocab_size -= 1

    word_freq = collections.Counter()
    for sentence in sentences:
        for word in sentence.strip().split():
            word_freq[WORD_START + word] += 1

    char_freq = collections.Counter()
    for word, freq in word_freq.items():
        for ch in word:
            char_freq[ch] += freq
    # optionally drop ultra-rare characters (sentencepiece character_coverage)
    if character_coverage < 1.0 and char_freq:
        total = sum(char_freq.values())
        covered, kept = 0, set()
        for ch, freq in char_freq.most_common():
            if covered / total >= character_coverage:
                break
            kept.add(ch)
            covered += freq
        kept.add(WORD_START)
    else:
        kept = set(char_freq)

    words = {tuple(ch if ch in kept else '\ufffd' for ch in word): freq for word, freq in word_freq.items()}
    specials = ['<unk>', '<s>', '</s>', '<pad>']
    pieces = list(specials) + sorted(kept)
    merges = []
    piece_set = set(pieces)

    while len(pieces) < vocab_size:
        pair_freq = collections.Counter()
        for symbols, freq in words.items():
            for a, b in zip(symbols, symbols[1:]):
                pair_freq[(a, b)] += freq
        if not pair_freq:
            break
        (a, b), freq = pair_freq.most_common(1)[0]
        if freq < 2:
            break
        merged = a + b
        merges.append([a, b])
        if merged not in piece_set:
            pieces.append(merged)
            piece_set.add(merged)
        new_words = {}
        for symbols, wfreq in words.items():
            out, i = [], 0
            while i < len(symbols):
                if i + 1 < len(symbols) and symbols[i] == a and symbols[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(symbols[i])
                    i += 1
            new_words[tuple(out)] = new_words.get(tuple(out), 0) + wfreq
        words = new_words

    pieces.append('<blank>')
    model = dict(type='bpe', pieces=pieces, merges=merges,
                 unk_id=0, bos_id=1, eos_id=2, pad_id=3)
    if model_path is not None:
        with open(model_path, 'w') as f:
            json.dump(model, f, ensure_ascii=False)
    return model


class BPETokenizer:
    """BPE tokenizer over a JSON model produced by `train_bpe`.

    External contract matches the reference's sentencepiece wrapper
    (text_tokenizers.py:54-94): `vocab`, `vocab_size`, `silence_tokens_ids`
    = {pad_id}, `is_start_word_token` via the '▁' marker, encode/decode.
    """

    def __init__(self, model_path: str, name: str = 'bpe'):
        self.name = name
        if isinstance(model_path, dict):
            model = model_path
        else:
            with open(model_path) as f:
                model = json.load(f)
        self.pieces: typing.List[str] = model['pieces']
        self.piece2id = {p: i for i, p in enumerate(self.pieces)}
        self.merge_ranks = {tuple(m): r for r, m in enumerate(model['merges'])}
        self.unk_id = model.get('unk_id', 0)
        self.bos_id = model.get('bos_id', 1)
        self.eos_id = model.get('eos_id', 2)
        self.pad_id = model.get('pad_id', 3)
        self.word_start_tokens = {i for i, p in enumerate(self.pieces) if WORD_START in p}

    @property
    def vocab(self):
        return self.pieces

    @property
    def vocab_size(self):
        return len(self.pieces)

    @property
    def eps_id(self):
        """CTC-blank alias for decode/align paths. Training uses blank =
        num_classes - 1 for EVERY head (reference models.py:323: F.ctc_loss
        with blank = C-1), so for a BPE head with C = vocab_size classes the
        LAST vocab entry doubles as the blank — exactly as in the reference,
        where the last sentencepiece piece is never emitted. Must match the
        training blank or decode produces garbage."""
        return len(self.pieces) - 1

    @property
    def silence_tokens_ids(self):
        return {self.pad_id, self.eps_id}

    def is_start_word_token(self, idx):
        return idx in self.word_start_tokens

    def _encode_word(self, word: str) -> typing.List[int]:
        symbols = list(WORD_START + word)
        while len(symbols) > 1:
            best_rank, best_i = None, None
            for i, pair in enumerate(zip(symbols, symbols[1:])):
                rank = self.merge_ranks.get(pair)
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_i is None:
                break
            symbols[best_i:best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        return [self.piece2id.get(s, self.unk_id) for s in symbols]

    def encode(self, sentences: typing.List[str], bos=False, eos=False, **kwargs):
        out = []
        for sentence in sentences:
            ids = [tok for word in sentence.strip().split() for tok in self._encode_word(word)]
            out.append(([self.bos_id] if bos else []) + ids + ([self.eos_id] if eos else []))
        return out

    def decode(self, tokens: typing.List[typing.List[int]], **kwargs) -> typing.List[str]:
        special = {self.bos_id, self.eos_id, self.pad_id, self.eps_id}
        out = []
        for ts in tokens:
            text = ''.join(self.pieces[i] if i not in special else '' for i in ts)
            out.append(text.replace(WORD_START, ' ').strip())
        return out
