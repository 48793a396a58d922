"""Training CLI of the port (counterpart of convasr_tpu/cli/train.py):
epochs or a number of iterations over bucketed batches, validation with
greedy or beam-search decoding (--decoder, decode/factory.py; oracle error
rates over the top --decoder-topk hypotheses of the host beam) and error
analytics, checkpoints, resume, and a checkpoint on SIGTERM.

    python -m convasr_tpu_torch.cli.train --train-data-path train.json \
        --val-data-path val.json --experiment-id run1

Runs on one card (--device cuda, the default) and raises if there is none;
--device cpu runs the plain PyTorch versions of every kernel. The CTC loss of
each step runs on the CUDA kernels of csrc/ctc_loss.cu. The flag names and
defaults are the JAX CLI's; flags of parts not yet ported (several
processes, the device cache, SpecAugment, the wav2vec frontend,
rematerialisation, BN adaptation, tensorboard, orbax and reference convasr .pt
checkpoints) raise NotImplementedError.

Audio moves to the card as int16 by default (--device-transport), from pinned
memory with non-blocking copies. Loss, grad norm and finiteness are read back
to the host only every --log-iteration-interval, one step late, so the card
does not wait for the log.
"""
import argparse
import json
import logging
import os
import signal
import threading
import time

import numpy as np
import torch

from ..data import transcripts
from ..data.dataset import AudioTextDataset, frame_count_bucket_fn
from ..data.loader import PrefetchLoader, prefetch_map
from ..data.sampler import BucketingBatchSampler, MixingBatchSampler
from ..decode.factory import build_decoder
from ..decode.generators import GreedyCTCGenerator
from ..frontend.logmel import LogFilterBankFrontend
from ..infra.utils import set_random_seed, setup_logging
from ..metrics import ErrorAnalyzer, ErrorTagger, WordTagger, cer as cer_fn, quantiles
from ..models.zoo import create_model
from ..text import ProcessingPipeline, Stemmer, TextPostprocessor
from ..train import checkpoints as ckpt_lib
from ..train.loop import (
    MULAW_MU, freeze_mask, init_train_state, make_eval_step, make_optimizer_with_accum,
    make_train_step,
)
from ..train.optim import make_optimizer, multistep_lr, noop_lr, polynomial_decay_lr
from .transcribe import resolve_device

_LOG = 'convasr_tpu_torch.train'


def make_lr_schedule(args):
    if args.scheduler == 'MultiStepLR':
        return multistep_lr(args.lr, args.decay_gamma, args.decay_milestones)
    if args.scheduler == 'PolynomialDecayLR':
        decay_steps = args.decay_steps
        if getattr(args, 'decay_epochs', 0):
            # decay_steps = batches per epoch * decay_epochs (reference
            # train.py:689), bound once the sampler exists
            holder = {'steps_per_epoch': args.decay_steps}
            args._steps_per_epoch_holder = holder
            decay_steps = lambda: max(1, holder['steps_per_epoch'] * args.decay_epochs)  # noqa: E731
        return polynomial_decay_lr(args.lr, decay_steps, power=args.decay_power,
                                   begin_decay_at=args.decay_begin, end_lr=args.decay_end_lr,
                                   warmup_steps=args.warmup_steps)
    return noop_lr(args.lr)


def expand_experiment_id(args):
    if not args.experiment_id:
        args.experiment_id = args.experiment_name or \
            '{model}_{optimizer}_lr{lr:.0e}_wd{weight_decay:.0e}_bs{train_batch_size}'.format(
                **vars(args))
    # --experiment-dir is a template (spec: train.py:917)
    args.experiment_dir = args.experiment_dir.format(
        experiments_dir=args.experiments_dir, experiment_id=args.experiment_id)
    return args


def build_text_pipelines(args):
    config = ProcessingPipeline.load_config(args.text_config)
    return [ProcessingPipeline.make(config, name) for name in args.text_pipelines]


def build_model_and_frontend(args, text_pipelines):
    frontend = LogFilterBankFrontend(
        out_channels=args.num_input_features, sample_rate=args.sample_rate,
        window_size=args.window_size, window_stride=args.window_stride,
        window=args.window, dither=args.dither, dither0=args.dither0)
    num_classes = tuple(p.tokenizer.vocab_size for p in text_pipelines)
    overrides = dict(base_width=args.base_width) if args.base_width else {}
    model = create_model(args.model, num_input_features=args.num_input_features,
                         num_classes=num_classes, frontend=frontend,
                         decoder_type='bpe' if len(num_classes) > 1 else None,
                         dropout=args.dropout,
                         dtype=torch.bfloat16 if args.bf16 else torch.float32, **overrides)
    return model, frontend


def build_error_analyzer(args):
    word_tags, configs = {}, {}
    if args.word_tags and os.path.exists(args.word_tags):
        with open(args.word_tags) as f:
            word_tags = json.load(f)
    if args.val_config and os.path.exists(args.val_config):
        with open(args.val_config) as f:
            val_config = json.load(f)
        for tag, words in val_config.get('word_tags', {}).items():
            word_tags[tag] = word_tags.get(tag, []) + words
        configs = val_config.get('error_analyzer', {})
    vocab = set(map(str.strip, open(args.vocab))) if args.vocab and os.path.exists(args.vocab) \
        else set()
    text_config = ProcessingPipeline.load_config(args.text_config)
    postprocessors = {name: TextPostprocessor(**cfg)
                      for name, cfg in text_config['postprocess'].items()}
    return ErrorAnalyzer(word_tagger=WordTagger(stemmer=Stemmer(args.lang), word_tags=word_tags,
                                                vocab=vocab),
                         error_tagger=ErrorTagger(), configs=configs,
                         postprocessors=postprocessors)


def check_ported(args):
    """Flags of parts not yet ported fail loudly instead of being ignored."""
    unported = dict(
        num_processes=(args.num_processes or args.world_size or 0) > 1,
        device_cache=args.device_cache, spec_augment=args.spec_augment,
        frontend=args.frontend == 'Wav2VecFrontend', frontend_checkpoint=args.frontend_checkpoint,
        remat=args.remat, adapt_bn=args.adapt_bn,
        tensorboard=args.tensorboard, log_weight_histograms=args.log_weight_histograms,
        exphtml=args.exphtml, logits=args.logits, onnx=args.onnx,
        vis_errors_audio=args.vis_errors_audio, dump_model_config=args.dump_model_config,
        checkpoint=bool(args.checkpoint) and (os.path.isdir(args.checkpoint)
                                              or not args.checkpoint.endswith(('.pt', '.npz'))))
    for flag, used in unported.items():
        if used:
            raise NotImplementedError(f'--{flag.replace("_", "-")} is not yet ported to '
                                      'convasr_tpu_torch' + (' (orbax checkpoints)'
                                                             if flag == 'checkpoint' else ''))
    if args.steps_per_dispatch != 1:
        raise ValueError('--steps-per-dispatch amortises the JAX dispatch; the port takes only 1')


def to_host_batch(meta_s_x):
    meta, s, x, xlen, y, ylen = meta_s_x
    return meta, dict(x=np.ascontiguousarray(x[:, 0, :]), xlen=np.asarray(xlen, np.float32),
                      y=np.asarray(y, np.int64), ylen=np.asarray(ylen, np.int64))


def transport_cast(batch, transport):
    """Host leg of the audio transport: float32 audio becomes int16 PCM (half
    the bytes) or 8-bit mu-law (a quarter); train/loop.undo_int16_transport
    undoes it on the device."""
    x = batch['x']
    if x.dtype != np.float32:
        return batch
    if transport == 'int16':
        return dict(batch, x=(np.clip(x, -1.0, 1.0) * 32767.0).round().astype(np.int16))
    if transport == 'mulaw':
        xc = np.clip(x, -1.0, 1.0)
        y = np.sign(xc) * np.log1p(MULAW_MU * np.abs(xc)) / np.log1p(MULAW_MU)
        return dict(batch, x=(y * 127.0 + 128.0).round().astype(np.uint8))
    return batch


def put_batch(batch, device):
    """Host numpy batch -> tensors on `device`; to the card from pinned memory
    with non-blocking copies."""
    if device.type != 'cuda':
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    return {k: torch.from_numpy(v).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def evaluate_model(args, model, val_datasets, generator, text_pipelines, error_analyzer,
                   device, epoch=0, iteration=0, training=False):
    """Validation (greedy, or the --decoder beam) + error analytics (spec:
    the reference train.py:156-341), one process."""
    _print = logging.getLogger(_LOG).info
    eval_step = make_eval_step(model, bpe_only=args.bpe_only, forward_x_only=args.forward_x_only)
    decoders = {p.name: build_decoder(args, p.tokenizer) for p in text_pipelines} \
        if args.decoder != 'GreedyDecoder' else {}
    results = {}
    for name, dataset in val_datasets.items():
        _print(f'{name}@{iteration}: examples: {len(dataset)}')
        tic = time.time()
        analyze_jobs = []
        index_batches = [list(range(start, min(start + args.val_batch_size, len(dataset))))
                         for start in range(0, len(dataset), args.val_batch_size)]
        for collated in PrefetchLoader(dataset, index_batches, num_workers=args.num_workers):
            meta, host = to_host_batch(collated)
            outputs, metrics = eval_step(put_batch(transport_cast(host, args.device_transport),
                                                   device))
            loss, ent, unc = (metrics[k].cpu().numpy() for k in ('loss', 'entropy', 'uncertainty'))
            for pipeline, lp, olen in zip(text_pipelines, outputs['log_probs'], outputs['olen']):
                dec = decoders.get(pipeline.name)
                if dec is None or not dec.on_device:
                    # the device beams read the log-probs on the device
                    lp, olen = lp.cpu().numpy(), olen.cpu().numpy()
                if dec is None:
                    gen = generator.generate(tokenizer=pipeline.tokenizer, log_probs=lp,
                                             begin=np.zeros(len(lp)), end=np.zeros(len(lp)),
                                             output_lengths=olen, time_stamps=None,
                                             segment_text_key='hyp')
                    hyps = [transcripts.join(hyp=alts[0]) for alts in gen]
                elif dec.topk > 1:
                    # oracle: the candidate with the lowest cer
                    hyps = []
                    for m, alts in zip(meta, dec.decode(lp, output_lengths=olen)):
                        ref_pp = pipeline.postprocess(pipeline.preprocess(m['ref']))
                        hyps.append(min(pipeline.decode(alts), key=lambda t: cer_fn(
                            hyp=pipeline.postprocess(t), ref=ref_pp)))
                else:
                    hyps = pipeline.decode(dec.decode(lp, output_lengths=olen))
                for k, (m, hyp) in enumerate(zip(meta, hyps)):
                    analyze_jobs.append((
                        hyp, pipeline.preprocess(m['ref']), pipeline.postprocess,
                        args.analyze is not None,
                        dict(labels_name=pipeline.name, audio_path=m['audio_path'],
                             audio_name=transcripts.audio_name(m['audio_path']),
                             loss=float(loss[k]), entropy=float(ent[k]),
                             uncertainty=float(unc[k]))))
        if args.analyze_num_workers > 0 and analyze_jobs:
            import multiprocessing
            with multiprocessing.get_context('spawn').Pool(args.analyze_num_workers) as pool:
                analyzed = pool.starmap(error_analyzer.analyze, analyze_jobs)
        else:
            analyzed = [error_analyzer.analyze(*job) for job in analyze_jobs]
        aggregated = error_analyzer.aggregate(
            analyzed, defaults=dict(mer_wordwise=-1, hyp_vocabness=-1, ref_vocabness=-1))
        _print(f'{name} | epoch {epoch} iter {iteration} | '
               'Loss: {loss:.02f} | WER: {wer:.02%} CER: {cer:.02%}'.format(**aggregated))
        _print(f'cer quantiles: {quantiles(t["cer"] for t in analyzed)}')
        _print(f'eval time: {time.time() - tic:.1f} sec')
        results[name] = aggregated

        if args.output_json or args.output_csv:
            fmt = (args.train_transcripts_format or args.val_transcripts_format) if training \
                else args.val_transcripts_format
            base = os.path.join(args.experiment_dir, fmt.format(
                val_dataset_name=name, epoch=epoch, iteration=iteration, decoder=args.decoder))
            if args.output_json:
                with open(base + '.json', 'w') as f:
                    json.dump(analyzed, f, ensure_ascii=False, indent=2, sort_keys=True,
                              default=str)
            if args.output_csv:
                with open(base + '.csv', 'w') as f:
                    f.write(args.csv_sep.join(args.csv_columns) + '\n')
                    f.writelines(args.csv_sep.join(str(t.get(c, '')) for c in args.csv_columns)
                                 + '\n' for t in analyzed)
    return results


# A SIGTERM (preemption) only sets this event; the train loop notices it after
# the current step, saves a checkpoint that --checkpoint resumes from, and
# returns.
_PREEMPT = threading.Event()


def _on_preempt_signal(signum, frame):
    _PREEMPT.set()


def main(args):
    _PREEMPT.clear()
    prev_sigterm = None
    try:
        prev_sigterm = signal.signal(signal.SIGTERM, _on_preempt_signal)
    except ValueError:
        pass  # not the main thread: the caller keeps its handler
    root = logging.getLogger()
    handlers = list(root.handlers)
    try:
        return _main(args)
    finally:
        for h in root.handlers[:]:
            if h not in handlers:   # the log file handler of this run
                root.removeHandler(h)
                h.close()
        if prev_sigterm is not None:
            signal.signal(signal.SIGTERM, prev_sigterm)


def _main(args):
    check_ported(args)
    device = resolve_device(args.device)
    ckpt = None
    if args.checkpoint:
        ckpt = ckpt_lib.load_train_checkpoint(args.checkpoint, device) \
            if args.checkpoint.endswith('.pt') else \
            dict(model_state_dict=ckpt_lib.load_any_checkpoint(args.checkpoint)[0], args={},
                 opt_state=None, step=0, epoch=0, sampler={}, generator_state=None)
        if any(k.startswith('backbone.') for k in ckpt['model_state_dict']):
            raise NotImplementedError('reference convasr .pt checkpoints are not yet ported '
                                      'to convasr_tpu_torch')
        if not args.finetune:
            # model hyper-params come from the checkpoint on resume
            # (spec: train.py:392-394); --finetune keeps the CLI's
            for key in ['model', 'sample_rate', 'window_size', 'window_stride',
                        'num_input_features', 'frontend', 'base_width']:
                if ckpt['args'].get(key) is not None:
                    setattr(args, key, ckpt['args'][key])

    args = expand_experiment_id(args)
    os.makedirs(args.experiment_dir, exist_ok=True)
    setup_logging(os.path.join(args.experiment_dir, 'log.txt'))
    if args.verbose:
        logging.getLogger().setLevel(logging.DEBUG)
    with open(os.path.join(args.experiment_dir, args.args), 'w') as f:
        json.dump(vars(args), f, ensure_ascii=False, indent=2, sort_keys=True, default=str)
    _print = logging.getLogger(_LOG).info
    rng = set_random_seed(args.seed, device)

    text_pipelines = build_text_pipelines(args)
    model, frontend = build_model_and_frontend(args, text_pipelines)
    generator = GreedyCTCGenerator(blank_amount_to_space=args.replace_blank_series)
    error_analyzer = build_error_analyzer(args)
    bucket_fn = frame_count_bucket_fn(args.window_stride, args.batch_time_padding_multiple)
    val_datasets = {
        os.path.basename(path): AudioTextDataset(
            path, text_pipelines, args.sample_rate, min_duration=args.min_duration,
            max_duration=args.max_duration, time_padding_multiple=args.batch_time_padding_multiple,
            bucket_fn=bucket_fn, mono=True, audio_backend=args.audio_backend)
        for path in (args.val_data_path or [])}

    epoch_start, sampler_state = 0, None
    if ckpt is not None:
        model.load_state_dict(ckpt['model_state_dict'])
    model.to(device)
    schedule = make_lr_schedule(args)
    mask = freeze_mask(model, freeze_backbone=args.freeze_backbone,
                       freeze_decoder0=args.freeze_decoder,
                       freeze_frontend=args.freeze_frontend) \
        if args.freeze_backbone or args.freeze_decoder or args.freeze_frontend else None
    optimizer = make_optimizer_with_accum(
        make_optimizer(args.optimizer, schedule, momentum=args.momentum,
                       weight_decay=args.weight_decay, betas=tuple(args.betas),
                       nesterov=args.nesterov),
        max_grad_norm=args.max_norm, accumulate_steps=args.train_batch_accumulate_iterations,
        trainable_mask=mask)
    state = init_train_state(model, optimizer)
    if ckpt is not None and ckpt['opt_state'] is not None:
        # a training checkpoint: optimizer state, step, position and the
        # random stream continue where the run stopped
        state.opt_state, state.step = ckpt['opt_state'], ckpt['step']
        epoch_start, sampler_state = ckpt['epoch'], ckpt['sampler']
        if ckpt['generator_state'] is not None:
            rng.set_state(ckpt['generator_state'])

    if not args.train_data_path:
        evaluate_model(args, model, val_datasets, generator, text_pipelines, error_analyzer,
                       device, epoch=epoch_start, iteration=state.step)
        return

    def make_train_ds(paths):
        return AudioTextDataset(
            paths, text_pipelines, args.sample_rate, min_duration=args.min_duration,
            max_duration=args.max_duration, time_padding_multiple=args.batch_time_padding_multiple,
            bucket_fn=bucket_fn, mono=True, audio_backend=args.audio_backend, pop_meta=True)

    if args.train_data_mixing:
        assert len(args.train_data_mixing) == len(args.train_data_path)
        train_datasets = [make_train_ds([path]) for path in args.train_data_path]
        sampler = MixingBatchSampler(
            [BucketingBatchSampler(ds, batch_size=args.train_batch_size) for ds in train_datasets],
            args.train_data_mixing, seed=args.seed)
    else:
        train_datasets = None
        train_dataset = make_train_ds(args.train_data_path)
        sampler = BucketingBatchSampler(train_dataset, batch_size=args.train_batch_size)
    if sampler_state:
        sampler.load_state_dict(sampler_state)
    if getattr(args, '_steps_per_epoch_holder', None):
        args._steps_per_epoch_holder['steps_per_epoch'] = len(sampler)
    train_step = make_train_step(model, optimizer, bpe_only=args.bpe_only,
                                 blank_penalty=args.ctc_blank_penalty)

    def save(epoch, sampler_state):
        path = ckpt_lib.checkpoint_path(args.experiment_dir, epoch, state.step,
                                        template=args.checkpoint_format)
        ckpt_lib.save_train_checkpoint(path, model, state, epoch=epoch,
                                       sampler_state=sampler_state, generator=rng,
                                       args=vars(args))
        return path

    iteration = state.step
    _print(f'start training at epoch {epoch_start} iteration {iteration}')
    toc = time.time()
    # metrics of a logged step are read one step later, after the next step
    # is queued, so the card never waits on the host for the log
    pending_log = []
    last_logged = {'t': None, 'it': None}

    def flush_logs(keep_last=False):
        if not keep_last:
            last_logged['t'] = None
        while len(pending_log) > (1 if keep_last else 0):
            p_epoch, it, metrics, p_data, p_dispatch_t, p_step_time = pending_log.pop(0)
            m = {k: float(v) for k, v in metrics.items()}
            step_time = p_step_time if p_step_time is not None else time.time() - p_dispatch_t
            lr = float(schedule(torch.tensor(it - 1)))
            _print(f'epoch {p_epoch} iter {it} loss {m["loss"]:.4f} '
                   f'entropy {m["entropy"]:.3f} grad_norm {m["grad_norm"]:.3f} lr {lr:.3e} '
                   f'data {p_data * 1e3:.0f}ms step {step_time * 1e3:.0f}ms')
            if args.log_json:
                with open(os.path.join(args.experiment_dir, 'log.json'), 'a') as f:
                    f.write(json.dumps(dict(epoch=p_epoch, iteration=it, lr=lr, **m)) + '\n')

    for epoch in range(epoch_start, args.epochs):
        sampler.set_epoch(epoch + args.seed_sampler)
        if train_datasets is not None:
            batch_source = prefetch_map(
                lambda src_idx: train_datasets[src_idx[0]].collate_fn(
                    [train_datasets[src_idx[0]][i] for i in src_idx[1]]),
                iter(sampler), num_workers=args.num_workers)
        else:
            batch_source = PrefetchLoader(train_dataset, iter(sampler),
                                          num_workers=args.num_workers,
                                          timeout=args.timeout or None)
        for collated in batch_source:
            data_time = time.time() - toc
            _, host = to_host_batch(collated)
            metrics = train_step(state, put_batch(transport_cast(host, args.device_transport),
                                                  device), rng)
            iteration = state.step
            sampler.batch_idx += 1
            if iteration % args.log_iteration_interval == 0:
                now = time.time()
                sustained = (now - last_logged['t']) / (iteration - last_logged['it']) \
                    if last_logged['t'] is not None else None
                last_logged['t'], last_logged['it'] = now, iteration
                pending_log.append((epoch, iteration, metrics, data_time, now, sustained))
            flush_logs(keep_last=True)
            toc = time.time()
            at_boundary = args.val_iteration_interval and \
                iteration % args.val_iteration_interval == 0
            preempted = _PREEMPT.is_set()
            done = args.dry or (args.iterations and iteration >= args.iterations)
            if at_boundary or preempted or done:
                flush_logs()
            if preempted:
                if not args.checkpoint_skip:
                    path = save(epoch, sampler.state_dict())
                    _print(f'SIGTERM: checkpoint saved to {path} at iter {iteration}; '
                           'exiting cleanly')
                else:
                    _print('SIGTERM: --checkpoint-skip set, exiting without a checkpoint')
                break
            if at_boundary:
                evaluate_model(args, model, val_datasets, generator, text_pipelines,
                               error_analyzer, device, epoch=epoch, iteration=iteration,
                               training=True)
                if not args.checkpoint_skip:
                    save(epoch, sampler.state_dict())
            if done:
                break
        else:
            flush_logs()
            sampler.batch_idx = 0
            if args.skip_on_epoch_end_evaluation:
                continue
            evaluate_model(args, model, val_datasets, generator, text_pipelines,
                           error_analyzer, device, epoch=epoch, iteration=iteration,
                           training=True)
            if not args.checkpoint_skip:
                save(epoch + 1, dict(batch_idx=0))
            continue
        break
    flush_logs()
    _print('training done')


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                        help='cuda (default) raises when no card is visible')
    parser.add_argument('--num-processes', type=int, default=0, help='not yet ported (> 1)')
    parser.add_argument('--world-size', type=int, default=0, help='not yet ported (> 1)')
    parser.add_argument('--log-json', default=True,
                        type=lambda v: str(v).lower() in ('1', 'true', 'yes'),
                        help='write json-lines train logs (log.json)')
    parser.add_argument('--decay-epochs', type=int, default=0,
                        help='PolynomialDecayLR horizon in epochs (decay_steps = '
                             'batches/epoch * this)')
    parser.add_argument('--base-width', type=int, default=None,
                        help='override the zoo config base width (small models)')
    parser.add_argument('--experiment-id', default='')
    parser.add_argument('--experiment-name', '--name', default='')
    parser.add_argument('--experiments-dir', default='data/experiments')
    parser.add_argument('--checkpoint', help='resume from a port checkpoint (.pt) or start '
                                             'from the weights of a flattened JAX .npz')
    parser.add_argument('--checkpoint-skip', action='store_true')
    parser.add_argument('--finetune', action='store_true',
                        help='keep CLI hyper-params instead of the checkpoint args')
    parser.add_argument('--model', default='JasperNetBig')
    parser.add_argument('--frontend', default='LogFilterBankFrontend',
                        choices=['LogFilterBankFrontend', 'Wav2VecFrontend'],
                        help='Wav2VecFrontend is not yet ported')
    parser.add_argument('--frontend-checkpoint', help='not yet ported')
    parser.add_argument('--train-data-path', nargs='*', default=[])
    parser.add_argument('--train-data-mixing', nargs='*', type=float, default=None)
    parser.add_argument('--val-data-path', nargs='*', default=[])
    parser.add_argument('--sample-rate', type=int, default=8000)
    parser.add_argument('--window-size', type=float, default=0.02)
    parser.add_argument('--window-stride', type=float, default=0.01)
    parser.add_argument('--window', default='hann_window')
    parser.add_argument('--num-input-features', type=int, default=64)
    parser.add_argument('--dither', type=float, default=1e-5)
    parser.add_argument('--dither0', type=float, default=0.0,
                        help='dither BEFORE preemphasis (train.py:1019)')
    parser.add_argument('--min-duration', type=float, default=0.1)
    parser.add_argument('--max-duration', type=float, default=10.0)
    parser.add_argument('--batch-time-padding-multiple', type=int, default=128)
    parser.add_argument('--audio-backend', default=None)
    parser.add_argument('--text-config', default='configs/ru_text_config.json')
    parser.add_argument('--text-pipelines', nargs='+', default=['char_legacy'])
    parser.add_argument('--val-config', default='configs/ru_val_config.json')
    parser.add_argument('--vocab', default='data/vocab_word_list.txt')
    parser.add_argument('--word-tags', default='data/word_tags.json',
                        help='extra word-tag json merged with the val config')
    parser.add_argument('--lang', default='ru')
    parser.add_argument('--analyze', nargs='*', default=None)
    parser.add_argument('--analyze-num-workers', type=int, default=0)
    parser.add_argument('--optimizer', default='NovoGrad',
                        choices=['SGD', 'AdamW', 'NovoGrad', 'FusedNovoGrad'])
    parser.add_argument('--lr', type=float, default=1e-2)
    parser.add_argument('--weight-decay', type=float, default=1e-3)
    parser.add_argument('--momentum', type=float, default=0.5)
    parser.add_argument('--nesterov', action='store_true')
    parser.add_argument('--betas', nargs=2, type=float, default=[0.9, 0.999])
    parser.add_argument('--max-norm', type=float, default=100.0)
    parser.add_argument('--scheduler', default='', choices=['', 'MultiStepLR', 'PolynomialDecayLR'])
    parser.add_argument('--decay-gamma', type=float, default=0.1)
    parser.add_argument('--decay-milestones', nargs='*', type=int, default=[25000, 50000])
    parser.add_argument('--decay-power', type=float, default=2.0)
    parser.add_argument('--decay-begin', type=int, default=0)
    parser.add_argument('--decay-steps', type=int, default=100000)
    parser.add_argument('--decay-end-lr', '--decay-lr', type=float, default=0.0)
    parser.add_argument('--warmup-steps', type=int, default=0)
    parser.add_argument('--epochs', type=int, default=5)
    parser.add_argument('--iterations', type=int, default=0)
    parser.add_argument('--train-batch-size', type=int, default=64)
    parser.add_argument('--val-batch-size', type=int, default=64)
    parser.add_argument('--train-batch-accumulate-iterations', type=int, default=1)
    parser.add_argument('--steps-per-dispatch', type=int, default=1,
                        help='kept for the JAX CLI\'s command lines; only 1')
    parser.add_argument('--device-transport', choices=['float32', 'int16', 'mulaw'],
                        default='int16',
                        help='audio rides to the device as int16 PCM (half the bytes) or '
                             '8-bit mu-law (a quarter) and is decoded there')
    parser.add_argument('--device-cache', action='store_true', help='not yet ported')
    parser.add_argument('--num-workers', type=int, default=4,
                        help='audio-decode prefetch threads (0 = synchronous)')
    parser.add_argument('--timeout', type=float, default=0.0,
                        help='per-batch dataloader watchdog seconds (0 = off)')
    parser.add_argument('--log-iteration-interval', type=int, default=100)
    parser.add_argument('--val-iteration-interval', type=int, default=2500)
    parser.add_argument('--seed', type=int, default=1)
    parser.add_argument('--bf16', default=True,
                        type=lambda v: str(v).lower() in ('1', 'true', 'yes'))
    parser.add_argument('--dropout', type=float, default=0.2)
    parser.add_argument('--ctc-blank-penalty', type=float, default=0.0,
                        help='add this weight times the mean valid-frame blank '
                             'probability to the loss (a peaky-CTC remedy)')
    parser.add_argument('--spec-augment', action='store_true', help='not yet ported')
    parser.add_argument('--remat', action='store_true', help='not yet ported')
    parser.add_argument('--bpe-only', action='store_true')
    parser.add_argument('--freeze-backbone', type=int, default=0,
                        help='freeze the first N backbone blocks')
    parser.add_argument('--freeze-decoder', action='store_true',
                        help='freeze the char decoder head')
    parser.add_argument('--freeze-frontend', action='store_true',
                        help='freeze a learned frontend during training')
    parser.add_argument('--exphtml', action='store_true', help='not yet ported')
    parser.add_argument('--tensorboard', action='store_true', help='not yet ported')
    parser.add_argument('--log-weight-histograms', '--log-weight-distribution',
                        action='store_true', help='not yet ported')
    parser.add_argument('--adapt-bn', action='store_true', help='not yet ported')
    parser.add_argument('--replace-blank-series', type=int, default=8)
    parser.add_argument('--seed-sampler', type=int, default=0,
                        help='epoch offset for the sampler shuffle seed')
    parser.add_argument('--experiment-dir', default='{experiments_dir}/{experiment_id}')
    parser.add_argument('--args', default='args.json',
                        help='filename for the persisted flag set')
    parser.add_argument('--val-transcripts-format',
                        default='transcripts_{val_dataset_name}_epoch{epoch:02d}_iter{iteration:07d}')
    parser.add_argument('--train-transcripts-format',
                        default='transcripts_{val_dataset_name}_epoch{epoch:02d}_iter{iteration:07d}')
    parser.add_argument('--checkpoint-format',
                        default='checkpoint_epoch{epoch:02d}_iter{iteration:07d}',
                        help='checkpoint file name template (.pt is appended)')
    parser.add_argument('--csv-sep', default=',')
    parser.add_argument('--csv-columns', nargs='+',
                        default=['labels_name', 'audio_path', 'audio_name',
                                 'ref', 'hyp', 'cer', 'wer', 'loss', 'entropy'])
    parser.add_argument('--logits', nargs='?', const='data/logits_{val_dataset_name}.npz',
                        default=None, help='not yet ported')
    parser.add_argument('--decoder', default='GreedyDecoder',
                        choices=['GreedyDecoder', 'BeamSearchDecoder', 'BeamSearchDecoderDevice',
                                 'BeamSearchDecoderDeviceLM'],
                        help='validation decoder')
    parser.add_argument('--decoder-topk', type=int, default=1,
                        help='oracle error rates over top-k beam hypotheses')
    parser.add_argument('--lm', default=None, help='ARPA LM for the beam decoders')
    parser.add_argument('--beam-width', type=int, default=32)
    parser.add_argument('--beam-alpha', type=float, default=0.4)
    parser.add_argument('--beam-beta', type=float, default=1.0)
    parser.add_argument('--beam-cutoff-top-n', type=int, default=16)
    parser.add_argument('--beam-rescore', action='store_true',
                        help='with --decoder BeamSearchDecoder --lm: rescore the top complete '
                             'hypotheses with the word LM instead of fusing it per frame')
    parser.add_argument('--beam-max-len', type=int, default=0,
                        help='hybrid-decoder hypothesis-buffer cap (0 = frames+1, exact)')
    parser.add_argument('--onnx', default=None, help='not yet ported')
    parser.add_argument('--vis-errors-audio', action='store_true', help='not yet ported')
    parser.add_argument('--dump-model-config', action='store_true', help='not yet ported')
    parser.add_argument('--forward-x-only', action='store_true',
                        help='eval forward without xlen masks (masking debug)')
    parser.add_argument('--verbose', action='store_true')
    parser.add_argument('--dry', action='store_true',
                        help='build everything, run one batch, then exit')
    parser.add_argument('--skip-on-epoch-end-evaluation', action='store_true')
    parser.add_argument('--output-json', action='store_true')
    parser.add_argument('--output-csv', action='store_true')
    return parser


if __name__ == '__main__':
    main(build_parser().parse_args())
