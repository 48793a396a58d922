"""Transcript generation from CTC posteriors (host-side postprocessing).

Behavior spec: the reference convasr transcript_generators.py:8-93
(GreedyCTCGenerator): argmax path -> word-segmented, timestamped transcript
segments; long blank runs (>= blank_amount_to_space) insert spaces; repeats
are suppressed unless separated by blanks.
"""
import typing

import numpy as np

from ..data import transcripts


class GreedyCTCGenerator:
    def __init__(self, blank_amount_to_space: int = 10):
        self.blank_amount_to_space = blank_amount_to_space

    def generate(self, tokenizer, log_probs,
                 begin, end, output_lengths=None,
                 time_stamps=None, segment_text_key: str = 'hyp',
                 segment_extra_info: typing.Optional[typing.List[dict]] = None,
                 most_probable_idx=None):
        """log_probs: (B, T, C) array (channels-last); begin/end: (B,) seconds.

        Returns list (len B) of [Transcript] — each a list of Segment dicts
        with begin/end timestamps and decoded text.
        """
        if most_probable_idx is None:
            most_probable_idx = np.asarray(log_probs).argmax(axis=-1)
        most_probable_idx = np.asarray(most_probable_idx).tolist()
        time_stamps = np.asarray(time_stamps).tolist() if time_stamps is not None else None
        begin = np.maximum(np.asarray(begin, dtype=np.float64), 0.0).tolist() \
            if time_stamps is not None else np.asarray(begin, dtype=np.float64).tolist()
        end = np.asarray(end, dtype=np.float64).tolist()

        results = []
        for i, sample_idx in enumerate(most_probable_idx):
            sample_len = int(output_lengths[i]) if output_lengths is not None else len(sample_idx)
            ts = time_stamps[i] if time_stamps is not None else None
            transcript = transcripts.Transcript()

            t = 0
            while t < len(sample_idx) and sample_idx[t] in tokenizer.silence_tokens_ids:
                t += 1
            if t >= len(sample_idx):
                results.append([transcript])
                continue

            tokens = [tokenizer.eps_id]
            time_begin = begin[i] + ts[t] if ts is not None else begin[i]
            time_end = end[i]
            allow_repeat = False
            blank_run = 0

            def emit(tokens, time_begin, time_end):
                segment = transcripts.Segment(
                    begin=time_begin, end=time_end,
                    **{segment_text_key: tokenizer.decode([tokens[1:]])[0]})
                if segment_extra_info is not None:
                    segment.update(segment_extra_info[i])
                transcript.append(segment)

            space_id = getattr(tokenizer, 'space_id', None)
            for t in range(t, sample_len):
                tok = sample_idx[t]
                if tok == tokenizer.eps_id and tokens[-1] == space_id:
                    continue
                if tok == tokenizer.eps_id:
                    allow_repeat = True
                    blank_run += 1
                    if blank_run >= self.blank_amount_to_space \
                            and not tokenizer.is_start_word_token(tokens[-1]) \
                            and space_id is not None:
                        tokens.append(space_id)
                    continue
                if tok == tokens[-1] and not allow_repeat:
                    continue

                if tokenizer.is_start_word_token(tok) and ts is not None:
                    emit(tokens, time_begin, time_end)
                    tokens = [tokenizer.eps_id, tok]
                    time_begin = begin[i] + ts[t]

                allow_repeat = False
                tokens.append(tok)
                time_end = begin[i] + ts[t] if ts is not None else end[i]
                blank_run = 0

            if len(tokens) > 1:
                emit(tokens, time_begin, time_end)
            results.append([transcript])
        return results
