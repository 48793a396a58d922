# -*- coding: utf-8 -*-
"""Russian language resources: alphabet, number verbalization, stemming.

Behavior spec: the reference convasr ru.py (alphabet ru.py:7, phonetic groups
ru.py:13, number tables ru.py:16-73, normalize_text ru.py:228-249,
stem ru.py:252-263). The number-word tables are linguistic facts shared with
the reference; the code around them is written fresh.
"""
import re

PUNKT = '.'
UNK = '*'
ALPHA = 'абвгдеёжзийклмнопрстуфхцчшщъыьэюя'
ALPHABET = ALPHA + UNK + PUNKT

EVAL_REPLACE_GROUPS = ['её']
PHONETIC_REPLACE_GROUPS = ['оая', 'пб', 'сзц', 'вф', 'кгх', 'тд', 'чжшщ', 'еыэий', 'лр', 'ую', 'ьъ', 'нм']
VOWELS = 'аоийеёэыуюя'

MINUS = 'минус'
PERCENT = 'процент'

# value -> (cardinal, ordinal)
NUMBER_WORDS = {
    0: ('ноль', 'нулевой'),
    1: ('один', 'первый'),
    2: ('два', 'второй'),
    3: ('три', 'третий'),
    4: ('четыре', 'четвертый'),
    5: ('пять', 'пятый'),
    6: ('шесть', 'шестой'),
    7: ('семь', 'седьмой'),
    8: ('восемь', 'восьмой'),
    9: ('девять', 'девятый'),
    10: ('десять', 'десятый'),
    11: ('одиннадцать', 'одиннадцатый'),
    12: ('двенадцать', 'двенадцатый'),
    13: ('тринадцать', 'тринадцатый'),
    14: ('четырнадцать', 'четырнадцатый'),
    15: ('пятнадцать', 'пятнадцатый'),
    16: ('шестнадцать', 'шестнадцатый'),
    17: ('семнадцать', 'семнадцатый'),
    18: ('восемнадцать', 'восемнадцатый'),
    19: ('девятнадцать', 'девятнадцатый'),
    20: ('двадцать', 'двадцатый'),
    30: ('тридцать', 'тридцатый'),
    40: ('сорок', 'сороковой'),
    50: ('пятьдесят', 'пятьдесятый'),
    60: ('шестьдесят', 'шестьдесятый'),
    70: ('семьдесят', 'семидесятый'),
    80: ('восемьдесят', 'восемьдесятый'),
    90: ('девяносто', 'девяностый'),
    100: ('сто', 'сотый'),
    200: ('двести', 'двухсотый'),
    300: ('триста', 'трехсотый'),
    400: ('четыреста', 'четырехсотый'),
    500: ('пятьсот', 'пятисотый'),
    600: ('шестьсот', 'шестисотый'),
    700: ('семьсот', 'семисотый'),
    800: ('восемьсот', 'восьмисотый'),
    900: ('девятьсот', 'девятисотый'),
    1000: ('тысяча', 'тысячный'),
    1000000: ('миллион', 'миллионный'),
    1000000000: ('миллиард', 'миллиардный'),
}

_ROMAN_DIGITS = [
    (1000, 'M'), (900, 'CM'), (500, 'D'), (400, 'CD'), (100, 'C'), (90, 'XC'),
    (50, 'L'), (40, 'XL'), (10, 'X'), (9, 'IX'), (5, 'V'), (4, 'IV'), (1, 'I'),
]

# common Russian inflection suffixes, longest-first, for the naive stemmer
INFLECTIONS = sorted({
    'а', 'я', 'ы', 'и', 'о', 'е', 'у', 'ю', 'м', 'ое', 'ее', 'ой', 'ые', 'ие',
    'ый', 'ий', 'ам', 'ами', 'ая', 'ем', 'им', 'ет', 'ит', 'ут', 'ют', 'ят',
    'ешь', 'ишь', 'ете', 'ите', 'ал', 'ял', 'ала', 'яла', 'али', 'яли', 'ол',
    'ел', 'ола', 'ела', 'оли', 'ели', 'ул', 'ула', 'ули', 'ать', 'ять', 'оть',
    'еть', 'уть', 'ов', 'ого', 'ому', 'ою', 'ом', 'ей', 'ею', 'их', 'ими',
    'ми', 'мя', 'ую', 'ух', 'шь', 'ёт', 'ёте', 'ёх', 'ёшь', 'ию', 'её', 'оё',
}, key=len, reverse=True)


def arabic2roman(x: int) -> str:
    out = []
    for value, digit in _ROMAN_DIGITS:
        count, x = divmod(x, value)
        out.append(digit * count)
    return ''.join(out)


ROMAN2ARABIC = {arabic2roman(i): i for i in range(1, 31)}


def _number_to_pairs(num: int):
    """Decompose `num` into a list of (cardinal, ordinal) word pairs."""
    pairs = []
    if num < 0:
        pairs.append((MINUS, MINUS))
        num = -num
    for value in sorted(NUMBER_WORDS, reverse=True):
        if num >= value:
            count = num // value if value > 0 else 0
            if count > 1:
                pairs.extend(_number_to_pairs(count))
            pairs.append(NUMBER_WORDS[value])
            num -= count * value
            if num == 0:
                break
    if not pairs:
        pairs.append(NUMBER_WORDS[0])
    return pairs


def arabic2text(num, ordinal=False) -> str:
    """Verbalize an integer in Russian; ordinal=True inflects the last word."""
    pairs = _number_to_pairs(int(num))
    words = [cardinal for cardinal, _ in pairs]
    if ordinal:
        words[-1] = pairs[-1][1]
    return ' '.join(words)


def preprocess_word(word: str) -> str:
    """Convert a single token: roman numerals -> arabic -> Russian words.

    Tokens like '1-й' become ordinals; plain numbers become cardinals.
    Spec: ru.py:214-225.
    """
    if word in ROMAN2ARABIC:
        word = str(ROMAN2ARABIC[word])
    head, rest = word[0], word[1:]
    num_part, _, suffix = rest.partition('-')
    is_num = (head == '-' or head.isdigit()) and (not num_part or num_part.isdigit())
    is_ordinal = bool(suffix) and not suffix.isdigit()
    if is_num:
        return arabic2text(head + num_part, ordinal=is_ordinal)
    return word


def normalize_text(text: str, remove_unk: bool = True) -> str:
    """Normalize raw Russian text to the training alphabet. Spec: ru.py:228-249."""
    if remove_unk:
        text = text.replace('*', '')
    text = re.sub('[⁰¹²³⁴⁵⁶⁷⁸⁹]', ' ', text)
    text = text.replace('%', f' {PERCENT}*')
    words = re.findall(r'-?\d+-\w+|-?\d+\.?\d*|[\w*]+', text)
    text = ' '.join(preprocess_word(w) for w in words)
    text = text.lower()
    return re.sub(f'[^{ALPHA} ]', '*', text)


def stem(word: str, inflections=(), inflection: bool = False):
    """Naive truncation stemmer. Spec: ru.py:252-263.

    Without an inflection list: drop 3 chars if len>8, 2 if len>5.
    With one: strip the longest matching suffix for words longer than 5 chars.
    """
    stem_ = word
    if not inflections:
        stem_ = word[:-3] if len(word) > 8 else word[:-2] if len(word) > 5 else word
    elif len(word) > 5:
        for suffix in inflections:
            if word.endswith(suffix):
                stem_ = word[:-len(suffix)]
                break
    return (stem_, word[len(stem_):]) if inflection else stem_
