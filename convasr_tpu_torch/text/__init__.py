from .tokenizers import CharTokenizer, CharTokenizerLegacy, BPETokenizer, train_bpe
from .processing import (
    ProcessingPipeline, TextProcessor, TextPreprocessor, TextPostprocessor,
    TextNormalizer, Stemmer, Language,
)
