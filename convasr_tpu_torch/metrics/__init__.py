from .wer import cer, wer, edit_distance, levenshtein, nanmean, quantiles, extract_metric_value
from .needleman import Needleman
from .analyzer import (
    ErrorAnalyzer, ErrorTagger, WordTagger, align_strings, align_words,
    PLACEHOLDER, SPACE, SILENCE,
)
