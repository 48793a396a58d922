"""Transcript data model: lists of segment dicts + load/save/prune/segment ops.

Behavior spec: the reference convasr transcripts.py. A segment is a dict with keys
among {audio_path, audio_name, ref, hyp, begin, end, channel, speaker,
speaker_name, cer, wer, mer, words, ...}; missing-value sentinels match
transcripts.py:11-21.
"""
import itertools
import json
import os
import typing

from ..audio import io as audio_io
from ..infra.utils import flatten as _flatten, open_maybe_gz

ref_missing = ''
speaker_name_missing = ''
speaker_missing = 0
speaker_phrase_separator = ';'
speaker_separator = ', '
channel_missing = -1
time_missing = -1
_er_missing = -1.0

default_speaker_names = '_' + ''.join(chr(ord('A') + i) for i in range(26))
default_channel_names = {channel_missing: 'channel_', 0: 'channel0', 1: 'channel1'}


class Segment(dict):
    pass


class Transcript(list):
    pass


def flatten(segments):
    return _flatten(segments)


def map_text(postprocess, hyp=[], ref=[]):
    return ([dict(t, hyp=postprocess(t.get('hyp', ''))) for t in hyp] +
            [dict(t, ref=postprocess(t.get('ref', ''))) for t in ref])


def load(data_path: str) -> typing.List[dict]:
    """Load transcripts from .json/.json.gz/.rttm, or wrap a bare audio path."""
    assert os.path.exists(data_path), data_path
    if data_path.endswith('.rttm'):
        with open(data_path) as f:
            return [dict(audio_name=parts[1], begin=float(parts[3]),
                         end=float(parts[3]) + float(parts[4]), speaker_name=parts[7])
                    for parts in map(str.split, f)]
    if data_path.endswith('.json') or data_path.endswith('.json.gz'):
        with open_maybe_gz(data_path) as f:
            return json.load(f)
    if os.path.exists(data_path + '.json'):
        with open(data_path + '.json') as f:
            transcript = json.load(f)
        for t in transcript:
            t['audio_path'] = data_path
        return transcript
    return [dict(audio_path=data_path)]


def save(data_path: str, transcript):
    with open(data_path, 'w') as f:
        if data_path.endswith('.json'):
            json.dump(transcript, f, ensure_ascii=False, sort_keys=True, indent=2)
        elif data_path.endswith('.rttm'):
            name = audio_name(transcript[0])
            f.writelines(
                'SPEAKER {name} 1 {begin:.3f} {duration:.3f} <NA> <NA> {speaker} <NA> <NA>\n'.format(
                    name=name, begin=t['begin'], duration=compute_duration(t), speaker=t['speaker'])
                for t in transcript if t['speaker'] != speaker_missing)
    return data_path


def strip(transcript, keys=[]):
    return [{k: v for k, v in t.items() if k not in keys} for t in transcript]


def join(ref=[], hyp=[]) -> str:
    return ' '.join(filter(bool, [t.get('ref', '').strip() for t in ref] +
                           [t.get('hyp', '').strip() for t in hyp]))


def collect_speaker_names(transcript, speaker_names=[], num_speakers=1, set_speaker_data=False):
    """Build the speaker-name table and optionally backfill speaker ids
    (spec: transcripts.py:92-132)."""
    if not transcript:
        return
    has_speaker = all(t.get('speaker') is not None for t in transcript)
    has_speaker_names = all(bool(t.get('speaker_name')) for t in transcript)

    if speaker_names:
        # explicit per-channel names (--speakers; the reference parses the
        # flag, transcribe.py:340, but never applies it — here it assigns
        # name/id per segment channel)
        speaker_names = [speaker_name_missing] + list(speaker_names)
        if set_speaker_data:
            for t in transcript:
                c = t.get('channel', channel_missing)
                idx = 1 + c if 0 <= c + 1 < len(speaker_names) else speaker_missing
                t['speaker_name'] = speaker_names[idx] if idx != speaker_missing \
                    else speaker_name_missing
                t['speaker'] = idx
    else:
        if has_speaker:
            table = {t['speaker']: default_speaker_names[t['speaker']] for t in transcript}
            if set_speaker_data:
                for t in transcript:
                    t['speaker_name'] = default_speaker_names[t['speaker']]
            table[speaker_missing] = speaker_name_missing
            speaker_names = [table.get(s, speaker_name_missing) for s in range(1 + max(table))]
        elif has_speaker_names:
            speaker_names = [speaker_name_missing] + sorted(set(t['speaker_name'] for t in transcript))
            index = {name: i for i, name in enumerate(
                [n for n in speaker_names if speaker_separator not in n])}
            if set_speaker_data:
                for t in transcript:
                    t['speaker'] = index.get(t['speaker_name'], speaker_missing)
        else:
            speaker_names = ([default_channel_names[channel_missing]] +
                             [default_channel_names[c] for c in range(num_speakers)])
            index = {default_channel_names[channel_missing]: speaker_missing,
                     **{name: i for i, name in enumerate(speaker_names)}}
            if set_speaker_data:
                for t in transcript:
                    t['speaker_name'] = default_channel_names[t.get('channel', channel_missing)]
                    t['speaker'] = index[t['speaker_name']]

    if num_speakers is not None and len(speaker_names) < 1 + num_speakers:
        speaker_names.extend(f'speaker{s}' for s in range(len(speaker_names), 1 + num_speakers))
    return speaker_names


def remap_speaker(transcript, speaker_perm):
    speaker_names = collect_speaker_names(transcript, num_speakers=len(speaker_perm) - 1)
    for t in transcript:
        s = speaker_perm[t['speaker']]
        t['speaker'], t['speaker_name'] = s, speaker_names[s]


def speaker_name(ref=None, hyp=None):
    return speaker_separator.join(
        sorted(filter(bool, set(t.get('speaker_name') for t in ref + hyp)))) or None


def summary(transcript, ij=False) -> dict:
    res = dict(
        begin=min(w.get('begin', 0.0) for w in transcript),
        end=max(w.get('end', 0.0) for w in transcript),
        i=min([w['i'] for w in transcript if 'i' in w] or [0]),
        j=max([w['j'] for w in transcript if 'j' in w] or [0]),
    ) if transcript else dict(begin=time_missing, end=time_missing, i=0, j=0)
    if not ij:
        del res['i']
        del res['j']
    return res


def sort_key(t):
    return t.get('audio_path'), t.get('begin'), t.get('end'), t.get('channel')


def group_key(t):
    return t.get('audio_path')


def sort(transcript):
    return sorted(transcript,
                  key=lambda t: sort_key(summary(t.get('words_ref', []) + t.get('words_hyp', []))))


def take_between(transcript, ind_last_taken, t, first, last, sort_by_time=True,
                 soft=True, set_speaker=False):
    """Select segments between the last-taken anchor and `t` (spec:
    transcripts.py:151-173)."""
    if sort_by_time:
        lt = lambda a, b: a['end'] < b['begin']
        gt = lambda a, b: a['end'] > b['begin']
    else:
        lt = lambda a, b: sort_key(a) < sort_key(b)
        gt = lambda a, b: sort_key(a) > sort_key(b)

    if soft:
        res = [(k, u) for k, u in enumerate(transcript)
               if (first or ind_last_taken < 0 or lt(transcript[ind_last_taken], u)) and (last or gt(t, u))]
    else:
        intersects = lambda t_, begin, end: (begin <= t_['end'] and t_['begin'] <= end)
        res = ([(k, u) for k, u in enumerate(transcript)
                if ind_last_taken < k and intersects(t, u['begin'], u['end'])] if t else [])

    inds, taken = zip(*res) if res else ([ind_last_taken], [])
    if set_speaker:
        for u in taken:
            u['speaker'] = t.get('speaker', speaker_missing)
            if t.get('speaker_name') is not None:
                u['speaker_name'] = t['speaker_name']
    return inds[-1], list(taken)


def segment_by_time(transcript, max_segment_seconds, break_on_speaker_change=True,
                    break_on_channel_change=True):
    """Greedy segmentation into <= max_segment_seconds chunks (spec:
    transcripts.py:137-149)."""
    transcript = [t for t in transcript if t['begin'] != time_missing and t['end'] != time_missing]
    ind_last_taken = -1
    for j, t in enumerate(transcript):
        first, last = ind_last_taken == -1, j == len(transcript) - 1
        if last or (t['end'] - transcript[ind_last_taken + 1]['begin'] > max_segment_seconds) \
                or (break_on_speaker_change and j >= 1 and t['speaker'] != transcript[j - 1]['speaker']) \
                or (break_on_channel_change and j >= 1 and t['channel'] != transcript[j - 1]['channel']):
            ind_last_taken, segment = take_between(transcript, ind_last_taken, t, first, last,
                                                   sort_by_time=False)
            if segment:
                yield segment


def segment_by_ref(transcript, ref_segments, soft=True, set_speaker=False):
    """Re-segment `transcript` along reference segment boundaries (spec:
    transcripts.py:175-184)."""
    if not ref_segments:
        return
    ind_last_taken = -1
    for j in range(len(ref_segments)):
        first, last = ind_last_taken == -1, j == len(ref_segments) - 1
        ind_last_taken, segment = take_between(transcript, ind_last_taken,
                                               summary(ref_segments[j]), first, last,
                                               sort_by_time=True, soft=soft, set_speaker=set_speaker)
        yield segment


Interval = typing.Tuple[typing.Union[float, int], typing.Union[float, int]]


def prune(transcript, align_boundary_words=False, cer=None, wer=None, mer=None,
          duration=None, gap=None, num_speakers=None, allowed_audio_names=None,
          allowed_unk_count=None, max_audio_file_size=None, **kwargs):
    """Yield segments passing all the interval/name filters (spec:
    transcripts.py:215-252)."""
    size_cache = {}

    def file_size_ok(t):
        if max_audio_file_size is None:
            return True
        path = t['audio_path']
        if path not in size_cache:
            size_cache[path] = os.path.getsize(path)
        return size_cache[path] <= max_audio_file_size

    is_aligned = lambda w: (w.get('type') or w.get('error_tag')) == 'ok'
    in_interval = lambda interval, v: interval is None or v is None or interval[0] <= v <= interval[1]

    prev = None
    for t in transcript:
        dur = compute_duration(t) if duration is not None else None
        ok = (
            file_size_ok(t)
            and in_interval(allowed_unk_count, t.get('ref', '').count('*'))
            and (duration is None or dur == time_missing or in_interval(duration, dur))
            and in_interval(cer, t.get('cer'))
            and in_interval(wer, t.get('wer'))
            and in_interval(mer, t.get('mer'))
            and ((not t.get('words')) or (not align_boundary_words)
                 or (is_aligned(t['words'][0]) and is_aligned(t['words'][-1])))
            and (prev is None or gap is None or in_interval(gap, t['begin'] - prev['end']))
            and (num_speakers is None
                 or in_interval(num_speakers, (t.get('speaker_name') or '').count(',') + 1))
            and (allowed_audio_names is None or audio_name(t) in allowed_audio_names)
        )
        if ok:
            yield t
        prev = t


def join_transcript(transcript, join_channels=False, duration_from_transcripts=False):
    """Join per-channel segments into one long-form entry per channel (spec:
    transcripts.py:255-284; feeds the `batched_channels` dataset mode)."""
    joined = []
    if join_channels:
        grouped = [(channel_missing, transcript)]
    else:
        channel_key = lambda t: t.get('channel', channel_missing)
        grouped = itertools.groupby(sorted(transcript, key=channel_key), channel_key)

    for channel, group in grouped:
        group = list(group)
        audio_path = group[0]['audio_path']
        assert all(t['audio_path'] == audio_path for t in group)
        duration = summary(group)['end'] if duration_from_transcripts \
            else audio_io.compute_duration(audio_path)
        joined.append(dict(
            audio_path=audio_path,
            ref=speaker_phrase_separator.join(t['ref'].strip() for t in group),
            begin=0.0, end=duration,
            speaker=[t['speaker'] for t in group],
            speaker_name=','.join(collect_speaker_names(group)),
            channel=channel))
    return joined


def compute_duration(t, hours=False):
    seconds = None
    if 'begin' in t or 'end' in t:
        seconds = t.get('end', 0) - t.get('begin', 0) if t.get('end') != time_missing else time_missing
    elif 'hyp' in t or 'ref' in t:
        seconds = max(t_['end'] for k in ['hyp', 'ref'] for t_ in t.get(k, []))
    elif 'audio_path' in t:
        seconds = audio_io.compute_duration(t['audio_path'])
    assert seconds is not None
    return seconds / 3600 if hours else seconds


def audio_name(t):
    return (t.get('audio_name') or os.path.basename(t['audio_path'])) if isinstance(t, dict) \
        else os.path.basename(t)


def number_tuple(s: str):
    """Parse '1-2' / '0.1' / '3-' style interval strings (spec:
    transcripts.py:306-311)."""
    def parse(i, part):
        if not part:
            return float(['-inf', 'inf'][i])
        return float(part) if '.' in part else int(part)
    parts = (s if '-' in s else s + '-' + s).split('-')
    return tuple(parse(i, p) for i, p in enumerate(parts))
