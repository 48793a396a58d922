# -*- coding: utf-8 -*-
"""English language resources (LibriSpeech-style ASR).

The reference is Russian-first but pluggable by language module
(datasets.py:664-666, scripts/download_en_librispeech.sh); this module makes
LibriSpeech-style English corpora work with the same pipeline machinery.
"""
import re

PUNKT = '.'
UNK = '*'
ALPHA = "abcdefghijklmnopqrstuvwxyz'"
ALPHABET = ALPHA + UNK + PUNKT

EVAL_REPLACE_GROUPS = []
PHONETIC_REPLACE_GROUPS = []
VOWELS = 'aeiouy'

_ONES = ['zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven', 'eight',
         'nine', 'ten', 'eleven', 'twelve', 'thirteen', 'fourteen', 'fifteen',
         'sixteen', 'seventeen', 'eighteen', 'nineteen']
_TENS = ['', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy',
         'eighty', 'ninety']
_SCALES = [(1000000000, 'billion'), (1000000, 'million'), (1000, 'thousand'),
           (100, 'hundred')]


def arabic2text(num, ordinal=False) -> str:
    num = int(num)
    if num < 0:
        return 'minus ' + arabic2text(-num)
    if num < 20:
        words = [_ONES[num]]
    elif num < 100:
        words = [_TENS[num // 10]] + ([_ONES[num % 10]] if num % 10 else [])
    else:
        for value, name in _SCALES:
            if num >= value:
                head = arabic2text(num // value).split()
                rest = num % value
                words = head + [name] + (arabic2text(rest).split() if rest else [])
                break
    text = ' '.join(words)
    if ordinal:
        # common irregulars, else -th
        irregular = dict(one='first', two='second', three='third', five='fifth',
                         eight='eighth', nine='ninth', twelve='twelfth')
        last = words[-1]
        if last in irregular:
            words[-1] = irregular[last]
        elif last.endswith('ty'):
            words[-1] = last[:-1] + 'ieth'
        else:
            words[-1] = last + 'th'
        text = ' '.join(words)
    return text


def preprocess_word(word: str) -> str:
    # bare ordinals: 2nd, 21st, 3rd, 100th
    m = re.fullmatch(r'(-?\d+)(st|nd|rd|th)', word, re.IGNORECASE)
    if m:
        return arabic2text(m.group(1), ordinal=True)
    head, rest = word[0], word[1:]
    num_part, _, suffix = rest.partition('-')
    is_num = (head == '-' or head.isdigit()) and (not num_part or num_part.isdigit())
    is_ordinal = bool(suffix) and suffix.lower() in ('st', 'nd', 'rd', 'th')
    if is_num:
        return arabic2text(head + num_part, ordinal=is_ordinal)
    return word


def normalize_text(text: str, remove_unk: bool = True) -> str:
    if remove_unk:
        text = text.replace('*', '')
    words = re.findall(r"-?\d+(?:st|nd|rd|th)\b|-?\d+-\w+|-?\d+\.?\d*|[\w'*]+", text)
    text = ' '.join(preprocess_word(w) for w in words)
    text = text.lower()
    return re.sub(f"[^{ALPHA} ]", '*', text)


def stem(word: str, inflections=(), inflection: bool = False):
    suffixes = ['ing', 'ed', 'es', 's', 'ly', 'er', 'est'] if not inflections \
        else list(inflections)
    stem_ = word
    if len(word) > 4:
        for suffix in sorted(suffixes, key=len, reverse=True):
            if word.endswith(suffix) and len(word) - len(suffix) >= 3:
                stem_ = word[:-len(suffix)]
                break
    return (stem_, word[len(stem_):]) if inflection else stem_
