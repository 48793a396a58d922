"""Batch/dir transcription CLI of the port (counterpart of
convasr_tpu/cli/transcribe.py): greedy decoding, optional forced alignment of
the reference text (--align, on the CUDA Viterbi kernel), json/txt/csv
outputs.

    python -m convasr_tpu_torch.cli.transcribe --checkpoint model.pt \
        -i audio_or_dir_or_transcript.json -o out --output-json --align

Runs on the card (--device cuda, the default) and raises if there is none;
--device cpu runs the plain PyTorch versions of every kernel. --quantize int8
calibrates activation scales on the first --calibration-batches items (or
reads --calibration-cache) and then runs every forward as int8 PTQ inference
(models/quantized.py) on the int8 conv and GEMM kernels. Flags that the JAX
CLI has and the port has not reached yet raise NotImplementedError.
"""
import argparse
import collections
import inspect
import os
import time

import numpy as np
import torch

from ..data import transcripts
from ..data.dataset import AudioTextDataset
from ..data.loader import prefetch_map
from ..decode.generators import GreedyCTCGenerator
from ..frontend.logmel import LogFilterBankFrontend
from ..metrics import cer as cer_fn
from ..models.jasper import JasperNet
from ..models.quantized import quantize_cached, quantized_apply, to_device
from ..models.zoo import create_model
from ..ops.align import ctc_alignment_auto as ctc_alignment
from ..text import ProcessingPipeline
from ..train.checkpoints import load_any_checkpoint


def str2bool(v):
    return str(v).lower() in ('yes', 'true', 't', '1')


def resolve_device(name: str) -> torch.device:
    if name == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is visible; '
                           'pass --device cpu to run on the CPU')
    return torch.device(name)


def ckpt_model_overrides(ckpt_args: dict) -> dict:
    """Architectural hyper-params recorded in the checkpoint args (base_width,
    repeat, kernel sizes, ...) passed back to create_model so the weights
    always fit the module tree."""
    model_fields = set(inspect.signature(JasperNet.__init__).parameters) \
        - {'self', 'num_input_features', 'num_classes', 'frontend', 'dtype',
           'decoder_type'}
    return {k: v for k, v in ckpt_args.items() if k in model_fields and v is not None}


def check_ported(args):
    """Flags outside the port's first slice fail loudly instead of being ignored."""
    unported = dict(
        decoder=args.decoder != 'GreedyDecoder',
        vad=args.vad is not None, diarize=args.diarize, data_parallel=args.data_parallel,
        output_html=args.output_html, logits=args.logits, align_words=args.align_words,
        frontend=args.frontend == 'Wav2VecFrontend')
    for flag, used in unported.items():
        if used:
            raise NotImplementedError(f'--{flag.replace("_", "-")} is not yet ported '
                                      'to convasr_tpu_torch')


def setup(args):
    device = resolve_device(args.device)
    state_dict, ckpt_args = load_any_checkpoint(args.checkpoint)
    for key in ['sample_rate', 'window_size', 'window_stride', 'window', 'num_input_features']:
        if ckpt_args.get(key) is not None:
            setattr(args, key, ckpt_args[key])
    if (args.frontend or ckpt_args.get('frontend')) == 'Wav2VecFrontend':
        raise NotImplementedError('Wav2VecFrontend is not yet ported to convasr_tpu_torch')
    frontend = LogFilterBankFrontend(
        out_channels=args.num_input_features, sample_rate=args.sample_rate,
        window_size=args.window_size, window_stride=args.window_stride,
        window=args.window, dither=args.dither, dither0=args.dither0,
        normalize_signal_enabled=args.normalize_signal,
        normalize_signal_multiplier=args.debug_short_long_records_normalize_signal_multiplier)

    text_config = ProcessingPipeline.load_config(ckpt_args.get('text_config', args.text_config))
    pipeline_names = ckpt_args.get('text_pipelines', args.text_pipelines)
    # dual-head checkpoints carry every head; --pipeline picks the one to decode
    want = args.pipeline or pipeline_names[0]
    assert want in pipeline_names, \
        f'--pipeline {want!r} not in this checkpoint\'s heads {pipeline_names}'
    head = pipeline_names.index(want)
    all_pipelines = [ProcessingPipeline.make(text_config, n) for n in pipeline_names]
    text_pipeline = all_pipelines[head]

    model_name = args.model or ckpt_args.get('model', 'JasperNetBig')
    with torch.random.fork_rng(devices=[]):
        # no weights (e.g. smoke runs): a random init made from seed 0
        torch.manual_seed(0)
        model = create_model(model_name, num_input_features=args.num_input_features,
                             num_classes=tuple(p.tokenizer.vocab_size for p in all_pipelines),
                             decoder_type='bpe' if len(all_pipelines) > 1 else None,
                             frontend=frontend,
                             dtype=torch.bfloat16 if args.bf16 else torch.float32,
                             **ckpt_model_overrides(ckpt_args))
    if state_dict:
        model.load_state_dict(state_dict)
    model.to(device).eval()

    # int8 PTQ (--quantize int8): qstate is filled by forward.calibrate(batches)
    # once the first data batches exist; from then on every entry point runs
    # quantized_apply on the quantized tree, put on the device once
    qstate = {}

    def _outputs(x, xlen):
        if qstate:
            out = quantized_apply(model, qstate['qtree'], x, xlen=xlen)
        else:
            out = model(x, xlen=xlen)
        return out['log_probs'][head], out['logits'][head], out['olen'][head]

    # inference_mode is thread-local: each entry point enters it itself, since
    # the one-ahead dispatch calls them from a worker thread
    def forward(x, xlen):
        """(B, T) signal + (B,) fractions -> log_probs, logits, olen of the head."""
        with torch.inference_mode():
            return _outputs(x.to(device), xlen.to(device))

    def calibrate(batches, percentile=100.0, cache_path=None):
        """PTQ on the model's device (the card under --device cuda)."""
        qstate['qtree'] = to_device(
            quantize_cached(model, batches, percentile, cache_path=cache_path), device)

    def _fused(x, xlen):
        lp = _outputs(x, xlen)[0]
        best = lp.max(dim=-1)
        return torch.stack([best.indices.to(torch.float32), best.values], dim=-1)  # (B, T', 2)

    def fused(x, xlen):
        """Greedy argmax + its log-prob packed into one (B, T', 2) buffer."""
        with torch.inference_mode():
            return _fused(x.to(device), xlen.to(device))

    def fused_i16(x_i16, xlen):
        """As fused, with the audio shipped to the device as int16 PCM."""
        with torch.inference_mode():
            x = x_i16.to(device).to(torch.float32) / 32767.0
            return _fused(x, xlen.to(device))

    forward.calibrate, forward.fused, forward.fused_i16 = calibrate, fused, fused_i16
    generator = GreedyCTCGenerator(blank_amount_to_space=args.replace_blank_series)
    return text_pipeline, frontend, model, forward, generator


def main(args, ext_json=('.json', '.json.gz')):
    check_ported(args)
    assert args.output_json or args.output_txt or args.output_csv, \
        'at least one output format must be requested'
    os.makedirs(args.output_path, exist_ok=True)

    audio_paths = set(
        p for f in args.input_path
        for p in ([os.path.join(f, g) for g in os.listdir(f)] if os.path.isdir(f) else [f])
        if os.path.isfile(p) and any(p.endswith(e) for e in args.ext))
    json_paths = set(p for p in args.input_path if any(p.endswith(e) for e in ext_json))
    data_paths = sorted(audio_paths | json_paths)

    exclude = set(os.path.splitext(b)[0] for b in os.listdir(args.output_path)
                  if b.endswith('.json')) if args.skip_processed else None
    data_paths = [p for p in data_paths
                  if exclude is None or os.path.basename(p) not in exclude]

    text_pipeline, frontend, model, forward, generator = setup(args)

    # --profile-phases: cumulative wall seconds per pipeline phase; worker
    # phases (getitem/collate/dispatch) overlap the consumer's
    phases = collections.defaultdict(float)
    profile = args.profile_phases

    def _timed(name, fn, *a, **kw):
        if not profile:
            return fn(*a, **kw)
        t0 = time.time()
        r = fn(*a, **kw)
        phases[name] += time.time() - t0
        return r

    dataset = AudioTextDataset(
        data_paths, [text_pipeline], args.sample_rate, frontend=None, mono=args.mono,
        time_padding_multiple=args.batch_time_padding_multiple,
        audio_backend=args.audio_backend, exclude=exclude,
        max_duration=args.transcribe_first_n_sec,
        string_array_encoding=args.dataset_string_array_encoding,
        mode='batched_channels' if args.join_transcript else 'batched_transcript',
        duration_from_transcripts=args.join_transcript)
    print('Examples count:', len(dataset))
    meta_table = dataset.pop_meta()

    csv_sep = dict(tab='\t', comma=',')[args.csv_sep]
    csv_lines = []

    if args.quantize == 'int8' and len(dataset):
        # PTQ calibration on the first batches of the input corpus
        calib = []
        for k in range(min(args.calibration_batches, len(dataset))):
            _, _, cx, cxlen, _, _ = dataset.collate_fn(dataset[k])
            if cx.size:
                calib.append(dict(x=np.asarray(cx[:, 0, :]), xlen=np.asarray(cxlen)))
        tic = time.time()
        forward.calibrate(calib, percentile=args.calibration_percentile,
                          cache_path=args.calibration_cache)
        print(f'int8 PTQ: calibrated on {len(calib)} batch(es) '
              f'in {time.time() - tic:.1f} sec')

    items = prefetch_map(lambda i: _timed('getitem', dataset.__getitem__, i),
                         range(len(dataset)), num_workers=args.num_workers)

    # one-ahead pipeline: collate + upload + the fused forward of item i+1 are
    # enqueued while the host post-processes item i
    def collate_and_dispatch(item):
        collated = _timed('collate', dataset.collate_fn, item)
        _, _, x, xlen, _, _ = collated
        dev = None
        if x.size and not args.align:
            try:
                def dispatch():
                    if args.device_transport == 'int16':
                        xi = (np.clip(x[:, 0, :], -1.0, 1.0) * 32767.0).round().astype(np.int16)
                        return forward.fused_i16(torch.from_numpy(xi), torch.from_numpy(xlen))
                    return forward.fused(torch.from_numpy(x[:, 0, :]), torch.from_numpy(xlen))
                dev = _timed('dispatch', dispatch)
            except Exception as e:  # surfaced (and possibly skipped) at fetch
                dev = e
        return collated, dev

    pipelined = prefetch_map(collate_and_dispatch, items, num_workers=1, lookahead=2)
    for i, (collated, packed_dev) in enumerate(pipelined):
        meta, s, x, xlen, y, ylen = collated
        meta = [meta_table[t['example_id']] for t in meta]
        audio_path = meta[0]['audio_path']
        audio_name = transcripts.audio_name(audio_path)
        if x.size == 0:
            print(f'Skipping empty [{audio_path}]')
            continue

        tic = time.time()
        begin = np.asarray([t['begin'] for t in meta], dtype=np.float64)
        end = np.asarray([t['end'] for t in meta], dtype=np.float64)
        channel = [t['channel'] for t in meta]
        speaker = [t['speaker'] for t in meta]
        speaker_name = [t.get('speaker_name') for t in meta]
        duration = x.shape[-1] / args.sample_rate

        try:
            if isinstance(packed_dev, Exception):
                raise packed_dev
            if packed_dev is not None:
                packed = _timed('fetch', lambda: packed_dev.cpu().numpy())
                most_probable_idx = packed[..., 0].astype(np.int64)
                n_frames = packed.shape[1]
                olen = np.ceil(np.asarray(xlen, np.float64) * n_frames).astype(np.int64)
                log_probs = log_probs_dev = olen_dev = None
            else:
                log_probs_dev, _, olen_dev = forward(torch.from_numpy(x[:, 0, :]),
                                                     torch.from_numpy(xlen))
                log_probs, olen = log_probs_dev.cpu().numpy(), olen_dev.cpu().numpy()
                most_probable_idx = None
                n_frames = log_probs.shape[1]
        except torch.cuda.OutOfMemoryError as e:
            print(f'Skipping {i}/{len(dataset)} [{audio_path}] after OOM: {e}')
            continue
        print(f'Processing {i}/{len(dataset)}: {audio_path} '
              f'({duration:.2f}s audio, {time.time() - tic:.2f}s fetch+decode)')

        ts = duration * np.linspace(0, 1, n_frames)[None, :].repeat(x.shape[0], axis=0)

        extra = [dict(speaker=s_, speaker_name=sn, channel=c)
                 for s_, sn, c in zip(speaker, speaker_name, channel)]
        ref_segments = [[dict(channel=channel[k], begin=begin[k], end=end[k],
                              ref=text_pipeline.postprocess(
                                  text_pipeline.preprocess(meta[k]['ref'])))]
                        for k in range(len(meta))]
        hyp_segments = [alts[0] for alts in _timed(
            'decode_host', generator.generate,
            tokenizer=text_pipeline.tokenizer, log_probs=log_probs, begin=begin,
            end=end, output_lengths=olen, time_stamps=ts, segment_text_key='hyp',
            segment_extra_info=extra, most_probable_idx=most_probable_idx)]
        hyp_segments = [transcripts.map_text(text_pipeline.postprocess, hyp=h)
                        for h in hyp_segments]
        hyp = '\n'.join(transcripts.join(hyp=h) for h in hyp_segments).strip()
        ref = '\n'.join(transcripts.join(ref=r) for r in ref_segments).strip()
        if args.verbose:
            print('HYP:', hyp)
        if ref:
            print('CER: {:.02%}'.format(cer_fn(hyp=hyp, ref=ref)))

        if args.align and y.size > 0 and int(ylen[:, 0].max()) > 0:
            # forced alignment of the refs onto the CTC posteriors; blank = eps
            device = log_probs_dev.device
            alignment = _timed('align', lambda: ctc_alignment(
                log_probs_dev, torch.from_numpy(y[:, 0, :]).to(device), olen_dev,
                torch.from_numpy(ylen[:, 0]).to(device),
                blank=text_pipeline.tokenizer.eps_id).cpu().numpy())
            aligned_ts = np.take_along_axis(ts, alignment, axis=1)
            onehot = np.eye(log_probs.shape[-1], dtype=np.float32)[y[:, 0, :]]
            ref_segments = [alts[0] for alts in generator.generate(
                tokenizer=text_pipeline.tokenizer, log_probs=onehot, begin=begin, end=end,
                output_lengths=ylen[:, 0], time_stamps=aligned_ts,
                segment_text_key='ref', segment_extra_info=extra)]
            ref_segments = [transcripts.map_text(text_pipeline.postprocess, ref=r)
                            for r in ref_segments]

        ref_transcript, hyp_transcript = [
            sorted(transcripts.flatten(segs), key=transcripts.sort_key)
            for segs in [ref_segments, hyp_segments]]

        if args.max_segment_duration:
            if ref:
                ref_segments = list(transcripts.segment_by_time(
                    ref_transcript, args.max_segment_duration))
                hyp_segments = list(transcripts.segment_by_ref(hyp_transcript, ref_segments))
            else:
                hyp_segments = list(transcripts.segment_by_time(
                    hyp_transcript, args.max_segment_duration))
                ref_segments = [[] for _ in hyp_segments]
        elif args.ref_transcript_path and args.join_transcript:
            base = audio_name.split('.')[0]
            ref_segments = [[t] for t in sorted(
                transcripts.load(os.path.join(args.ref_transcript_path, base + '.json')),
                key=transcripts.sort_key)]
            hyp_segments = list(transcripts.segment_by_ref(
                hyp_transcript, ref_segments, set_speaker=True, soft=False))

        transcript = []
        for hyp_seg, ref_seg in zip(hyp_segments, ref_segments):
            h, r = transcripts.join(hyp=hyp_seg), transcripts.join(ref=ref_seg)
            seg_channel = next((s['channel'] for s in list(hyp_seg) + list(ref_seg)
                                if s.get('channel') is not None),
                               transcripts.channel_missing)
            transcript.append(dict(
                audio_path=audio_path, ref=r, hyp=h, channel=seg_channel,
                speaker_name=transcripts.speaker_name(ref=ref_seg, hyp=hyp_seg),
                words=[], words_ref=[], words_hyp=[],
                **transcripts.summary(hyp_seg),
                cer=cer_fn(hyp=h, ref=r)))

        transcripts.collect_speaker_names(transcript, speaker_names=args.speakers or [],
                                          set_speaker_data=True, num_speakers=2)
        filtered = list(transcripts.prune(
            transcript, align_boundary_words=args.align_boundary_words,
            cer=args.prune_cer, duration=args.prune_duration, gap=args.prune_gap,
            allowed_unk_count=args.prune_unk, num_speakers=args.prune_num_speakers))
        print('Filtered segments:', len(filtered), 'of', len(transcript))

        if args.output_json:
            print(_timed('outputs', transcripts.save,
                         os.path.join(args.output_path, audio_name + '.json'), filtered))
        if args.output_txt:
            path = os.path.join(args.output_path, audio_name + '.txt')
            with open(path, 'w') as f:
                f.write(' '.join(t['hyp'].strip() for t in filtered))
            print(path)
        if args.output_csv and filtered:
            csv_lines.append(csv_sep.join([
                audio_path, ' '.join(t['hyp'].strip() for t in filtered),
                str(min(t['begin'] for t in filtered)),
                str(max(t['end'] for t in filtered))]))

    if args.output_csv:
        path = os.path.join(args.output_path, 'transcripts.csv')
        with open(path, 'w') as f:
            f.write('\n'.join(csv_lines))
        print(path)

    if profile:
        acc = sum(phases.values())
        print('PHASES: ' + ' | '.join(
            f'{k} {v:.1f}s' for k, v in sorted(phases.items(), key=lambda kv: -kv[1]))
            + f' | accounted {acc:.1f}s (worker phases overlap consumer ones)')


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--verbose', action='store_true')
    parser.add_argument('--checkpoint', required=True,
                        help='port checkpoint (.pt from torch.save) or a flattened '
                             '.npz of a JAX checkpoint\'s flax trees')
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help='cuda (default) raises when no card is visible')
    parser.add_argument('--model')
    parser.add_argument('--batch-time-padding-multiple', type=int, default=128)
    parser.add_argument('--ext', nargs='*', default=['wav', 'mp3', 'opus', 'm4a'])
    parser.add_argument('--skip-processed', action='store_true')
    parser.add_argument('--input-path', '-i', nargs='+', required=True)
    parser.add_argument('--output-path', '-o', default='data/transcribe')
    parser.add_argument('--output-json', action='store_true')
    parser.add_argument('--output-html', action='store_true', help='not yet ported')
    parser.add_argument('--output-txt', action='store_true')
    parser.add_argument('--output-csv', action='store_true')
    parser.add_argument('--csv-sep', default='tab', choices=['tab', 'comma'])
    parser.add_argument('--bf16', type=str2bool, nargs='?', const=True, default=True)
    parser.add_argument('--quantize', choices=['int8'], default=None,
                        help='int8 PTQ inference: BN-folded per-channel int8 '
                             'weights + calibrated activation scales; convs '
                             'run on the int8 tensor-core kernels')
    parser.add_argument('--calibration-batches', type=int, default=1,
                        help='number of leading input batches used for '
                             'activation-scale calibration (--quantize)')
    parser.add_argument('--calibration-cache', default=None,
                        help='activation-scales cache file (.npz): written '
                             'after the first calibration, loaded instead of '
                             'recalibrating; valid only for the same '
                             'checkpoint + calibration setup')
    parser.add_argument('--calibration-percentile', type=float, default=100.0,
                        help='|x| percentile for activation scales (100 = absmax)')
    parser.add_argument('--num-workers', type=int, default=0)
    parser.add_argument('--data-parallel', action='store_true', help='not yet ported')
    parser.add_argument('--profile-phases', action='store_true',
                        help='print cumulative per-phase wall seconds at exit')
    parser.add_argument('--mono', action='store_true')
    parser.add_argument('--audio-backend', default=None, choices=[None, 'sox', 'ffmpeg'])
    parser.add_argument('--decoder', default='GreedyDecoder',
                        choices=['GreedyDecoder', 'BeamSearchDecoder',
                                 'BeamSearchDecoderDevice', 'BeamSearchDecoderDeviceLM'],
                        help='only GreedyDecoder is ported yet')
    parser.add_argument('--align', action='store_true')
    parser.add_argument('--logits', action='store_true', help='not yet ported')
    parser.add_argument('--normalize-signal', default=True,
                        type=lambda v: str(v).lower() in ('1', 'true', 'yes'))
    parser.add_argument('--dither0', type=float, default=0.0)
    parser.add_argument('--device-transport', choices=['float32', 'int16'], default='int16',
                        help='ship audio to the device as int16 PCM (/32767 on the '
                             'device). Applies to the fused greedy path')
    parser.add_argument('--align-boundary-words', action='store_true')
    parser.add_argument('--align-words', action='store_true', help='not yet ported')
    parser.add_argument('--max-segment-duration', type=float, default=0.0)
    parser.add_argument('--vad', type=int, default=None, metavar='AGGRESSIVENESS',
                        help='not yet ported')
    parser.add_argument('--prune-cer', type=transcripts.number_tuple)
    parser.add_argument('--prune-duration', type=transcripts.number_tuple)
    parser.add_argument('--prune-num-speakers', type=transcripts.number_tuple)
    parser.add_argument('--prune-gap', type=transcripts.number_tuple)
    parser.add_argument('--prune-unk', type=transcripts.number_tuple)
    parser.add_argument('--replace-blank-series', type=int, default=8)
    parser.add_argument('--transcribe-first-n-sec', type=int)
    parser.add_argument('--join-transcript', action='store_true')
    parser.add_argument('--sample-rate', type=int, default=8000)
    parser.add_argument('--window-size', type=float, default=0.02)
    parser.add_argument('--window-stride', type=float, default=0.01)
    parser.add_argument('--window', default='hann_window')
    parser.add_argument('--num-input-features', type=int, default=64)
    parser.add_argument('--dither', type=float, default=0.0)
    parser.add_argument('--text-config', default='configs/ru_text_config.json')
    parser.add_argument('--text-pipelines', nargs='+', default=['char_legacy'])
    parser.add_argument('--pipeline', help='which checkpoint head/pipeline to decode '
                        '(dual-head char+BPE checkpoints; default: the first)')
    parser.add_argument('--ref-transcript-path')
    parser.add_argument('--frontend', default=None,
                        choices=['LogFilterBankFrontend', 'Wav2VecFrontend'],
                        help='override the frontend recorded in the checkpoint args '
                             '(Wav2VecFrontend is not yet ported)')
    parser.add_argument('--speakers', nargs='*', default=None,
                        help='speaker names per channel')
    parser.add_argument('--diarize', action='store_true', help='not yet ported')
    parser.add_argument('--dataset-string-array-encoding', default='utf_16_le',
                        choices=['utf_16_le', 'utf_32_le'])
    parser.add_argument('--debug-short-long-records-normalize-signal-multiplier',
                        type=float, default=1.0,
                        help='scale on the peak-normalization denominator')
    return parser


if __name__ == '__main__':
    main(build_parser().parse_args())
