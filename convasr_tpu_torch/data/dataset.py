"""Audio+text dataset with bucketing and fixed-shape collation.

Behavior spec: the reference convasr datasets.py — AudioTextDataset datasets.py:23-355
(modes default / batched_channels / batched_transcript, duration pruning,
speaker alignment, example ids, state_dict broadcast), collate_fn
datasets.py:305-332 (xlen is the valid FRACTION of the padded time dim).

Collate pads the time dim to `time_padding_multiple` (reference flag
--batch-time-padding-multiple, train.py:1042), which keeps the set of batch
shapes small, as the JAX package does for XLA.

Storage is numpy (strings in a packed `StringArray`) so a fork to dataloader
workers shares pages instead of pickling python object graphs — the same
motivation as the reference's TensorBackedStringArray (utils.py:214-251).
"""
import itertools
import math
import os
import typing

import numpy as np

from ..audio import io as audio_io
from . import transcripts


class StringArray:
    """Packed string storage: one contiguous encoded buffer + offsets
    (spec: utils.py:214-241)."""

    def __init__(self, strings: typing.List[str], encoding: str = 'utf_16_le'):
        self.encoding = encoding
        encoded = [s.encode(encoding) for s in strings]
        self.offsets = np.cumsum([0] + [len(e) for e in encoded]).astype(np.int64)
        self.buffer = np.frombuffer(b''.join(encoded), dtype=np.uint8).copy() \
            if encoded else np.zeros(0, np.uint8)

    def __getitem__(self, i: int) -> str:
        return self.buffer[self.offsets[i]:self.offsets[i + 1]].tobytes().decode(self.encoding)

    def __len__(self):
        return len(self.offsets) - 1

    def tolist(self):
        return [self[i] for i in range(len(self))]

    def state_dict(self):
        return dict(encoding=self.encoding, offsets=self.offsets, buffer=self.buffer)

    @staticmethod
    def from_state_dict(d):
        out = StringArray([], d['encoding'])
        out.offsets, out.buffer = d['offsets'], d['buffer']
        return out


class AudioTextDataset:
    DEFAULT_MODE = 'default'
    BATCHED_CHANNELS_MODE = 'batched_channels'
    BATCHED_TRANSCRIPT_MODE = 'batched_transcript'

    def __init__(self, data_paths, text_pipelines, sample_rate: int,
                 mode: str = DEFAULT_MODE, frontend=None,
                 speaker_names=None, max_audio_file_size=None,
                 min_duration=None, max_duration=None, max_num_channels: int = 2,
                 mono: bool = True, audio_dtype: str = 'float32',
                 time_padding_multiple: int = 1, audio_backend=None,
                 exclude: typing.Optional[typing.Set] = None,
                 bucket_fn: typing.Callable = lambda transcript: 0,
                 pop_meta: bool = False, string_array_encoding: str = 'utf_16_le',
                 pad_to_bucket: bool = False,
                 duration_from_transcripts: bool = False, _print=print):
        self.mode = mode
        self.min_duration = min_duration
        self.max_duration = max_duration
        self.text_pipelines = text_pipelines
        self.frontend = frontend
        self.sample_rate = sample_rate
        self.time_padding_multiple = time_padding_multiple
        self.mono = mono
        self.audio_backend = audio_backend
        self.audio_dtype = audio_dtype
        self.pad_to_bucket = pad_to_bucket
        self.string_array_encoding = string_array_encoding

        data_paths = data_paths if isinstance(data_paths, list) else [data_paths]
        expanded = []
        for path in data_paths:
            if os.path.isdir(path):
                expanded.extend(os.path.join(path, f) for f in os.listdir(path)
                                if audio_io.is_audio(f))
            else:
                expanded.append(path)

        segments = []
        for path in expanded:
            if audio_io.is_audio(path):
                assert self.mono or self.mode != self.DEFAULT_MODE, \
                    'only mono audio allowed as direct input in default mode'
                if self.mono:
                    segments.append(dict(audio_path=path, channel=transcripts.channel_missing))
                else:
                    segments.extend(dict(audio_path=path, channel=c)
                                    for c in range(max_num_channels))
            else:
                segments.extend(transcripts.load(path))

        for t in segments:
            t['ref'] = t.get('ref') or transcripts.ref_missing
            t['begin'] = t['begin'] if t.get('begin') is not None else transcripts.time_missing
            t['end'] = t['end'] if t.get('end') is not None else transcripts.time_missing
            t['channel'] = (t['channel'] if t.get('channel') is not None
                            else transcripts.channel_missing) if not self.mono \
                else transcripts.channel_missing

        transcripts.collect_speaker_names(segments, speaker_names=speaker_names or [],
                                          num_speakers=max_num_channels, set_speaker_data=True)

        if self.mode == self.DEFAULT_MODE:
            grouped = ((i, [t]) for i, t in enumerate(segments))
        else:
            grouped = itertools.groupby(sorted(segments, key=transcripts.group_key),
                                        transcripts.group_key)

        buckets, grouped_segments, transcript_lens, speaker_lens = [], [], [], []
        for _, transcript in grouped:
            transcript = sorted(transcript, key=transcripts.sort_key)
            if self.mode == self.BATCHED_CHANNELS_MODE:
                transcript = transcripts.join_transcript(
                    transcript, self.mono, duration_from_transcripts=duration_from_transcripts)
            allowed = None
            if exclude is not None:
                allowed = set(transcripts.audio_name(t) for t in transcript
                              if transcripts.audio_name(t) not in exclude)
            transcript = list(transcripts.prune(
                transcript, allowed_audio_names=allowed,
                duration=(min_duration if min_duration is not None else 0.0,
                          max_duration if max_duration is not None else 24.0 * 3600),
                max_audio_file_size=max_audio_file_size))
            for t in transcript:
                t['example_id'] = self.get_example_id(t)
            if not transcript:
                continue
            bucket = bucket_fn(transcript)
            for t in transcript:
                t['bucket'] = bucket
                speaker_lens.append(len(t['speaker']) if isinstance(t['speaker'], list) else 1)
            buckets.append(bucket)
            grouped_segments.extend(transcript)
            transcript_lens.append(len(transcript))

        self.bucket = np.asarray(buckets, dtype=np.int16)
        self.audio_path = StringArray([t['audio_path'] for t in grouped_segments],
                                      string_array_encoding)
        self.ref = StringArray([t['ref'] for t in grouped_segments], string_array_encoding)
        self.begin = np.asarray([t['begin'] for t in grouped_segments], dtype=np.float64)
        self.end = np.asarray([t['end'] for t in grouped_segments], dtype=np.float64)
        self.channel = np.asarray([t['channel'] for t in grouped_segments], dtype=np.int8)
        self.example_id = StringArray([t['example_id'] for t in grouped_segments],
                                      string_array_encoding)
        if self.mode == self.BATCHED_CHANNELS_MODE:
            self.speaker = np.asarray([s for t in grouped_segments for s in t['speaker']],
                                      dtype=np.int64)
        else:
            self.speaker = np.asarray([t['speaker'] for t in grouped_segments], dtype=np.int64)
        self.speaker_len = np.asarray(speaker_lens, dtype=np.int16)
        self.transcript_cumlen = np.cumsum(np.asarray(transcript_lens, dtype=np.int64)) \
            if transcript_lens else np.zeros(0, np.int64)
        self.meta = {} if pop_meta else {t['example_id']: t for t in grouped_segments}

    # --- persistence for rank-0-builds-then-broadcast (spec: train.py:588-636) ---

    def state_dict(self) -> dict:
        return dict(
            bucket=self.bucket, audio_path=self.audio_path.state_dict(),
            ref=self.ref.state_dict(), begin=self.begin, end=self.end,
            channel=self.channel, speaker=self.speaker,
            example_id=self.example_id.state_dict(), meta=self.meta,
            speaker_len=self.speaker_len, transcript_cumlen=self.transcript_cumlen)

    def load_state_dict(self, state_dict: dict):
        self.bucket = state_dict['bucket']
        self.audio_path = StringArray.from_state_dict(state_dict['audio_path'])
        self.ref = StringArray.from_state_dict(state_dict['ref'])
        self.begin, self.end = state_dict['begin'], state_dict['end']
        self.channel, self.speaker = state_dict['channel'], state_dict['speaker']
        self.example_id = StringArray.from_state_dict(state_dict['example_id'])
        self.meta = state_dict['meta']
        self.speaker_len = state_dict['speaker_len']
        self.transcript_cumlen = state_dict['transcript_cumlen']

    def pop_meta(self):
        meta, self.meta = self.meta, {}
        return meta

    @staticmethod
    def get_example_id(t):
        return ('{{ "audio_path" : "{audio_path}", "begin" : {begin:.04f}, '
                '"end" : {end:.04f}, "channel" : {channel} }}').format(
            audio_path=t['audio_path'], begin=t.get('begin', transcripts.time_missing),
            end=t.get('end', transcripts.time_missing),
            channel=t.get('channel', transcripts.channel_missing))

    def unpack_transcript(self, index: int):
        if index < 0:
            index += len(self)
        lo = int(self.transcript_cumlen[index - 1]) if index > 0 else 0
        hi = int(self.transcript_cumlen[index])
        out = []
        for i in range(lo, hi):
            out.append(dict(
                audio_path=self.audio_path[i], ref=self.ref[i],
                begin=float(self.begin[i]), end=float(self.end[i]),
                channel=int(self.channel[i]),
                speaker=self.speaker[i:i + int(self.speaker_len[i])],
                example_id=self.example_id[i]))
        return out

    def __len__(self):
        return len(self.transcript_cumlen)

    def __getitem__(self, index):
        transcript = self.unpack_transcript(index)
        signal, sample_rate = audio_io.read_audio(
            transcript[0]['audio_path'], sample_rate=self.sample_rate, mono=self.mono,
            backend=self.audio_backend, duration=self.max_duration, dtype=self.audio_dtype)

        transcript = [t for t in transcript if t['channel'] < len(signal)]
        features = []
        for t in transcript:
            channel = t.pop('channel')
            begin = int(t['begin'] * sample_rate) if t['begin'] != transcripts.time_missing else 0
            end = 1 + int(t['end'] * sample_rate) if t['end'] != transcripts.time_missing \
                else signal.shape[1]
            if self.mode == self.DEFAULT_MODE:
                segment = signal[None, channel, :]
            else:
                segment = signal[None, channel, begin:end]
            features.append(self.frontend(segment) if self.frontend is not None else segment)

        targets, speakers = [], []
        for pipeline in self.text_pipelines:
            encoded_refs, aligned_speakers = self.encode_transcript(transcript, pipeline)
            targets.append(encoded_refs)
            speakers.append(aligned_speakers)
        for t in transcript:
            t['ref'] = t['ref'].replace(transcripts.speaker_phrase_separator, ' ')

        speaker = speakers[0]
        if self.mode == self.DEFAULT_MODE:
            transcript, speaker, features = transcript[0], speaker[0], features[0]
            targets = [target[0] for target in targets]
        return [transcript, speaker, features] + targets

    @staticmethod
    def encode_transcript(transcript, pipeline):
        """Encode refs + aligned per-token speaker ids (spec: datasets.py:334-355)."""
        encoded_refs, aligned_speakers = [], []
        for t in transcript:
            parts = t['ref'].split(transcripts.speaker_phrase_separator)
            parts = [parts[0]] + [' ' + p for p in parts[1:]]
            speakers_list = t['speaker'] if hasattr(t['speaker'], '__len__') else [t['speaker']]
            assert len(parts) == len(speakers_list), (parts, speakers_list)
            tokens, labels = [], []
            for part, speaker_label in zip(parts, speakers_list):
                ids = np.asarray(pipeline.encode([pipeline.preprocess(part)])[0], dtype=np.int64)
                tokens.append(ids)
                labels.append(np.full(len(ids), speaker_label, dtype=np.int64))
            encoded_refs.append(np.concatenate(tokens) if tokens else np.zeros(0, np.int64))
            aligned_speakers.append(np.concatenate(labels) if labels else np.zeros(0, np.int64))
        return encoded_refs, aligned_speakers

    def collate_fn(self, batch):
        """Pad + stack a batch -> (meta, s, x, xlen, y, ylen); x is (B, C, T),
        xlen the valid fraction of the padded T (spec: datasets.py:305-332)."""
        if self.mode != self.DEFAULT_MODE:
            batch = list(zip(*batch))
        _, sample_s, sample_x, *sample_y = batch[0]
        mult = self.time_padding_multiple

        def padded_len(k):
            m = max(b[k].shape[-1] for b in batch)
            return int(math.ceil(m / (mult if k >= 2 else 1))) * (mult if k >= 2 else 1)

        smax_len = max(b[1].shape[-1] for b in batch)
        xmax_len = padded_len(2)
        ymax_len = [int(math.ceil(max(b[3 + j].shape[-1] for b in batch) / mult)) * mult
                    for j in range(len(sample_y))]

        meta = [b[0] for b in batch]
        B = len(batch)
        x = np.zeros((B, len(sample_x), xmax_len), dtype=sample_x.dtype)
        y = np.zeros((B, len(sample_y), max(ymax_len)), dtype=np.int64)
        s = np.full((B, max(smax_len, 1)), transcripts.speaker_missing, dtype=np.int64)
        xlen = np.zeros(B, dtype=np.float32)
        ylen = np.zeros((B, len(sample_y)), dtype=np.int64)

        for k, (_, sample_s, sample_x, *sample_y) in enumerate(batch):
            xlen[k] = sample_x.shape[-1] / x.shape[-1] if x.shape[-1] > 0 else 1.0
            x[k, ..., :sample_x.shape[-1]] = sample_x
            s[k, :sample_s.shape[-1]] = sample_s
            for j, t in enumerate(sample_y):
                y[k, j, :t.shape[-1]] = t
                ylen[k, j] = len(t)
        # the xlen convention is ESTABLISHED here: (B,) float32 fraction of
        # the padded T in (0, 1] — downstream checks (check_xlen,
        # compute_output_lengths) enforce what this line produces
        assert xlen.dtype == np.float32 and xlen.ndim == 1 \
            and (len(batch) == 0 or float(xlen.max(initial=0.0)) <= 1.0), xlen
        return meta, s, x, xlen, y, ylen


def frame_count_bucket_fn(window_stride: float, time_padding_multiple: int):
    """Quantized padded-frame-count bucketing (spec: train.py:597-601)."""
    def bucket(transcript):
        return int(math.ceil(
            ((transcript[-1]['end'] - transcript[0]['begin']) / window_stride + 1)
            / time_padding_multiple))
    return bucket
