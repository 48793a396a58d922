from .wer import cer, wer, edit_distance, levenshtein
