"""Traffic kind `transcribe`: batch transcription on the port's greedy path,
as the transcribe CLI runs it in `batched_transcript` mode: one batch a
call of its segments, the audio cast to int16 and dispatched to
`forward.fused_i16` by a worker thread up to two batches ahead, the packed
argmax fetched, then `GreedyCTCGenerator.generate` on the host.

Parameters:
    corpus_seed         the seed of the pool's sizes, the same for every run
    calls               calls in the pool
    call_min_s, call_max_s             call durations, log-uniform
    seg_median_s, seg_sigma, seg_min_s, seg_max_s   segment durations,
                        log-normal, clipped
    padding_multiple    a batch is padded to a multiple of this many frames
    check_batches       batches the check samples besides the longest
    limits              the limit of each number `check` compares

The run seed draws the weights, the audio and the order of the pool; the
window cycles through the pool, every shape of which set-up has run once.
"""
import contextlib
import gc
import time

import numpy as np
import torch

from perfbench import inference, model_plan, signals, weights as weights_lib
from perfbench.reference import jasper as reference


def make_calls(p: dict, config: dict) -> list:
    """[segment durations (s)] a call, from `corpus_seed`."""
    g = signals.rng(p['corpus_seed'], 0)
    calls = []
    for _ in range(p['calls']):
        total = float(np.exp(g.uniform(np.log(p['call_min_s']), np.log(p['call_max_s']))))
        segs, at = [], 0.0
        while at < total:
            d = float(signals.lognormal_clipped(g, 1, p['seg_median_s'], p['seg_sigma'],
                                                p['seg_min_s'], p['seg_max_s'])[0])
            d = min(d, total - at)
            if d >= p['seg_min_s']:
                segs.append(d)
            at += d
        calls.append(segs)
    return calls


class Pool:
    """Host batches of the pool: x float32 (B, T), xlen, begin and end of
    each segment, and the work each batch carries."""

    def __init__(self, p: dict, config: dict, seed: int):
        fe = config['frontend']
        arch = weights_lib.arch_of(config)
        classes = [h['classes'] for h in config['heads']][:1]
        sr, hop = fe['sample_rate'], int(fe['window_stride'] * fe['sample_rate'])
        g = signals.rng(seed, 2)
        flops_frame = model_plan.conv_flops_per_frame(arch, classes)
        stft_frame = model_plan.stft_flops_per_frame(fe)
        self.batches = []
        calls = make_calls(p, config)
        for k in g.permutation(len(calls)):
            segs = calls[k]
            n = np.round(np.asarray(segs) * sr).astype(int)
            mult = p['padding_multiple'] * hop
            T = int(np.ceil(n.max() / mult)) * mult
            x = np.zeros((len(segs), T), np.float32)
            for r, m in enumerate(n):
                x[r, :m] = signals.speechlike(g, int(m), sr)
            xlen = (n / T).astype(np.float32)
            frames = model_plan.output_frames(arch, fe, T)
            olen = np.array([model_plan.valid_frames(frames, f) for f in xlen])
            begin = np.concatenate([[0.0], np.cumsum(segs)[:-1]])
            self.batches.append(dict(
                x=x, xlen=xlen, begin=begin, end=begin + np.asarray(segs),
                audio_s=float(n.sum()) / sr, frames=frames,
                fwd_flops=flops_frame * float(olen.sum()),
                padded_flops=flops_frame * frames * len(segs),
                stft_flops=stft_frame * model_plan.frontend_frames(fe, T) * len(segs)))


class Session:
    def __init__(self, run):
        self.p, self.config = run.params, run.config
        self.options = run.options
        self.seed = run.seed
        self.text_pipeline, self.model, self.forward, self.generator, self.args = \
            inference.setup(run)
        self.device = self.forward.device
        self.pool = Pool(self.p, self.config, run.seed)
        self.served = {}
        self.at = 0
        for k in range(len(self.pool.batches)):         # every shape, once
            self._decode(k, self._dispatch(k))
        self.served.clear()
        self._sync()

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _dispatch(self, k):
        b = self.pool.batches[k]
        xi = (np.clip(b['x'], -1.0, 1.0) * 32767.0).round().astype(np.int16)
        return self.forward.fused_i16(torch.from_numpy(xi), torch.from_numpy(b['xlen']))

    def _fetch(self, k, dev):
        packed = dev.cpu().numpy()
        if self.options.get('fault') == 'alter_token':
            ids = packed[..., 0]
            ids[:, ::7] = (ids[:, ::7] + 1) % self.config['heads'][0]['classes']
        return packed

    def _decode(self, k, packed_dev, run=None, record=True):
        b = self.pool.batches[k]
        span = run.span if run is not None else (lambda name, record: contextlib.nullcontext())
        with span('fetch', record):
            packed = self._fetch(k, packed_dev)
        with span('decode', record):
            idx = packed[..., 0].astype(np.int64)
            n_frames = packed.shape[1]
            olen = np.ceil(np.asarray(b['xlen'], np.float64) * n_frames).astype(np.int64)
            duration = b['x'].shape[-1] / self.config['frontend']['sample_rate']
            ts = duration * np.linspace(0, 1, n_frames)[None, :].repeat(b['x'].shape[0], axis=0)
            self.generator.generate(
                tokenizer=self.text_pipeline.tokenizer, log_probs=None, begin=b['begin'],
                end=b['end'], output_lengths=olen, time_stamps=ts, segment_text_key='hyp',
                most_probable_idx=idx)
        self.served[k] = packed

    def _loop(self, run, seconds, record):
        """The CLI's consumer loop: a worker thread casts and dispatches up to
        two batches ahead (`data/loader.prefetch_map`, one worker, as
        `cli/transcribe.main` runs it) while this thread fetches and decodes;
        batches are dispatched for `seconds` and every one is decoded."""
        from convasr_tpu_torch.data.loader import prefetch_map
        n = len(self.pool.batches)
        count, audio, fwd, padded, stft = 0, 0.0, 0.0, 0.0, 0.0
        t0 = time.perf_counter()

        def due():
            k = self.at
            while time.perf_counter() - t0 < seconds:
                yield k % n
                k += 1
            self.at = k

        def dispatch(k):
            with run.span('dispatch', record):
                return k, self._dispatch(k)

        for k, dev in prefetch_map(dispatch, due(), num_workers=1, lookahead=2):
            self._decode(k, dev, run, record)
            b = self.pool.batches[k]
            count, audio, fwd = count + 1, audio + b['audio_s'], fwd + b['fwd_flops']
            padded, stft = padded + b['padded_flops'], stft + b['stft_flops']
        return count, audio, time.perf_counter() - t0, fwd, padded, stft

    def window(self, run, seconds):
        count, audio, wall, fwd, _, _ = self._loop(run, seconds, True)
        run.values.update(kind='transcribe', batches=count, audio_s=audio, window_s=wall,
                          fwd_flops=fwd, attempted=count, failed=0)

    def traced_window(self, run, seconds):
        with torch.profiler.record_function('perfbench.window'):
            count, _, _, _, padded, stft = self._loop(run, seconds, False)
            self._sync()
        run.values.update(traced_batches=count, traced_conv_flops=padded,
                          traced_stft_flops=stft)

    def end_to_end(self, run):
        return dict(transcribe_audio_s_per_s=run.values['audio_s'] / run.values['window_s'])

    def check(self, run):
        """A sample of the window's batches, drawn from the seed, with the
        longest among them: each served frame's greedy id against the
        reference's log-probs (token_gap: how far below the reference's best
        the served class lies), and the served log-prob against the
        reference's of that class (lp_gap)."""
        self.model = self.forward = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        done = sorted(self.served)
        longest = max(done, key=lambda k: self.pool.batches[k]['x'].size)
        g = signals.rng(self.seed, 3)
        picks = [longest] + [int(k) for k in g.choice(
            [k for k in done if k != longest],
            size=min(self.p['check_batches'], len(done) - 1), replace=False)]
        start = weights_lib.draw(self.config, self.seed, self.device)
        numbers = dict(token_gap=0.0, lp_gap=0.0)
        control = dict(token_gap=0.0, lp_gap=0.0)
        for k in picks:
            b = self.pool.batches[k]
            xi = signals.to_int16(b['x'])
            ref, olen = reference.eval_log_probs(self.config, start, xi, b['xlen'], self.device)
            served = self.served[k]
            _merge(numbers, gaps(ref, olen, served[..., 0].astype(np.int64), served[..., 1]))
            if self.options.get('control'):
                low, _ = reference.eval_log_probs(self.config, start, xi, b['xlen'], self.device,
                                                  self.options['control'])
                best = low.max(dim=-1)
                _merge(control, gaps(ref, olen, best.indices.numpy(), best.values.numpy()))
        if self.options.get('control'):
            run.values['control_readings'] = control
        run.values['readings'] = numbers
        limits = self.p['limits']
        return [dict(name=k, value=v, limit=limits[k], ok=bool(v <= limits[k]))
                for k, v in numbers.items()]


def gaps(ref, olen, ids, values) -> dict:
    """token_gap: the widest gap by which a served class's reference
    log-prob lies below the reference's best, over the valid frames;
    lp_gap: the widest gap between the served log-prob and the reference's
    log-prob of that class."""
    ref = ref.numpy()
    assert ref.shape[:2] == ids.shape, (ref.shape, ids.shape)
    valid = np.arange(ref.shape[1])[None, :] < np.asarray(olen)[:, None]
    at = np.take_along_axis(ref, ids[..., None], axis=-1)[..., 0]
    token = np.where(valid, ref.max(axis=-1) - at, 0.0)
    lp = np.where(valid, np.abs(np.asarray(values, np.float64) - at), 0.0)
    return dict(token_gap=float(token.max()), lp_gap=float(lp.max()))


def _merge(into, new):
    for k, v in new.items():
        into[k] = max(into[k], v)


def setup(run):
    return Session(run)
