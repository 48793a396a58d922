"""Config-driven text processing pipelines.

Behavior spec: the reference convasr text_processing.py (handler chains
text_processing.py:48-172, TextNormalizer text_processing.py:175-297,
ProcessingPipeline text_processing.py:17-45) and
the reference convasr configs/ru_text_config.json for the pipeline config schema.
"""
import importlib
import json
import re
import typing

from . import tokenizers as text_tokenizers
from .langs import ru


def Language(lang: str):
    """Pluggable language module (spec: datasets.py:664-666)."""
    return importlib.import_module(f'convasr_tpu_torch.text.langs.{lang}')


class Stemmer:
    """Naive truncation stemmer (spec: text_processing.py:5-14)."""

    def __init__(self, lang: str = 'ru'):
        self.lang = lang

    def __call__(self, word: str) -> str:
        if self.lang is None:
            return word
        return word[:-3] if len(word) > 8 else word[:-2] if len(word) > 5 else word


class TextNormalizer:
    """Number/roman-numeral verbalization into Russian words.

    Spec: text_processing.py:175-297. Delegates the number tables to the
    language module (text/langs/ru.py).
    """

    SCRIPTS = '⁰¹²³⁴⁵⁶⁷⁸⁹₀₁₂₃₄₅₆₇₈₉⓪①②③④⑤⑥⑦⑧⑨'

    def normalize(self, text: str) -> str:
        starts_with_space = text.startswith(' ')
        text = re.sub(f'[{self.SCRIPTS}]', ' ', text)
        text = text.replace('%', f' {ru.PERCENT}*')
        words = re.findall(r'-?\d+-\w+|-?\d+\.?\d*|[\w*]+', text)
        text = ' '.join(ru.preprocess_word(w) for w in words)
        return (' ' + text) if starts_with_space else text


class TextProcessor:
    """Chain of text handlers configured from JSON (spec: text_processing.py:48-118).

    Handlers: normalize -> strip -> lower -> collapse repeats -> drop
    substrings -> replace char groups -> filter to allowed chars.
    """

    def __init__(self,
                 drop_space_at_borders: bool = True,
                 to_lower_case: bool = True,
                 collapse_char_series: bool = True,
                 drop_substrings: typing.Sequence[str] = (),
                 replace_chars: typing.Sequence[str] = (),
                 allowed_chars: typing.Optional[str] = None,
                 normalize_text: bool = False,
                 **kwargs):
        self.drop_space_at_borders = drop_space_at_borders
        self.to_lower_case = to_lower_case
        self.collapse_char_series = collapse_char_series
        self.drop_substrings = drop_substrings
        self.replace_chars = replace_chars
        self.allowed_chars = allowed_chars.replace(' ', r'\s') if allowed_chars is not None else None
        self.text_normalizer = TextNormalizer() if normalize_text else None
        self.handlers = [
            self.handle_normalize, self.handle_strip, self.handle_case, self.handle_collapse,
            self.handle_drop, self.handle_replace, self.handle_allowed
        ]

    def __call__(self, text: str) -> str:
        for handler in self.handlers:
            text = handler(text)
        return text

    def handle_normalize(self, text):
        return self.text_normalizer.normalize(text) if self.text_normalizer is not None else text

    def handle_strip(self, text):
        return text.strip() if self.drop_space_at_borders else text

    def handle_case(self, text):
        return text.lower() if self.to_lower_case else text

    def handle_collapse(self, text):
        return re.sub(r'(.)\1+', r'\g<1>', text) if self.collapse_char_series else text

    def handle_drop(self, text):
        for substring in self.drop_substrings:
            text = text.replace(substring, '')
        return text

    def handle_replace(self, text):
        for group in self.replace_chars:
            assert len(group) > 1, f'replace group needs a replacer and at least one replaceable char: {group!r}'
            text = re.sub(f'[{group[1:]}]', group[0], text)
        return text

    def handle_allowed(self, text):
        if self.allowed_chars is None:
            return text
        text = re.sub(rf'[^{self.allowed_chars}]', '', text)
        text = re.sub(r'\s2', ' ', text)  # orphaned repeat marker after a dropped char
        return re.sub(r'\s+', ' ', text)


class TextPreprocessor(TextProcessor):
    """Adds doubled-char -> repeat-marker encoding ('оо' -> 'о2').

    Spec: text_processing.py:121-142 (note the handler order: repeat encoding
    runs before collapse, and strip runs last).
    """

    def __init__(self, repeat_character: str = None, **kwargs):
        super().__init__(**kwargs)
        self.repeat_character = repeat_character
        self.handlers = [
            self.handle_normalize, self.handle_case, self.handle_repeat, self.handle_collapse,
            self.handle_drop, self.handle_replace, self.handle_allowed, self.handle_strip
        ]

    def handle_repeat(self, text):
        if self.repeat_character is not None:
            text = re.sub(r'(\w)\1', rf'\g<1>{self.repeat_character}', text)
        return text


class TextPostprocessor(TextProcessor):
    """Decodes repeat markers back into doubled characters ('о2' -> 'оо').

    Spec: text_processing.py:145-172.
    """

    def __init__(self, repeat_character: str = None, **kwargs):
        super().__init__(**kwargs)
        self.repeat_character = repeat_character
        self.handlers = [
            self.handle_normalize, self.handle_case, self.handle_collapse, self.handle_drop,
            self.handle_repeat, self.handle_replace, self.handle_allowed, self.handle_strip
        ]

    def handle_repeat(self, text):
        if self.repeat_character is None or not text:
            return text
        out = [text[0]] if text[0] != self.repeat_character else []
        for prev, cur in zip(text, text[1:]):
            out.append(prev if cur == self.repeat_character else cur)
        return ''.join(out)


class ProcessingPipeline:
    """Named bundle of tokenizer + pre/postprocessor (spec: text_processing.py:17-45)."""

    @staticmethod
    def make(config: dict, name: str) -> 'ProcessingPipeline':
        pipeline_config = config['pipelines'][name]
        tokenizer_config = dict(config['tokenizers'][pipeline_config['tokenizer']])
        tokenizer_cls = tokenizer_config.pop('class')
        # accept both our names and the reference's class names
        aliases = dict(CharTokenizerLegacy='CharTokenizer')
        tokenizer = getattr(text_tokenizers, aliases.get(tokenizer_cls, tokenizer_cls))(**tokenizer_config)
        preprocessor = TextPreprocessor(**config['preprocess'][pipeline_config['preprocessor']])
        postprocessor = TextPostprocessor(**config['postprocess'][pipeline_config['postprocessor']])
        return ProcessingPipeline(name=name, tokenizer=tokenizer,
                                  preprocessor=preprocessor, postprocessor=postprocessor)

    @staticmethod
    def load_config(path: str) -> dict:
        with open(path) as f:
            return json.load(f)

    def __init__(self, name, tokenizer, preprocessor, postprocessor):
        self.name = name
        self.tokenizer = tokenizer
        self.preprocessor = preprocessor
        self.postprocessor = postprocessor

    def preprocess(self, text):
        return self.preprocessor(text)

    def postprocess(self, text):
        return self.postprocessor(text)

    def encode(self, sentences, **kwargs):
        return self.tokenizer.encode(sentences, **kwargs)

    def decode(self, sentences, **kwargs):
        return self.tokenizer.decode(sentences, **kwargs)
