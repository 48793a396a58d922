"""Traffic kind `train`: train steps of the port as its train CLI runs them.

The step path is the CLI's: a host float32 batch, `cli/train.transport_cast`
to the transport, `cli/train.put_batch` (pinned, non-blocking), then
`train/loop.make_train_step`'s step with the CLI's NovoGrad, clip and
dropout generator; the step's metrics are read back one step late at the
CLI's log interval.

Parameters (the cell file's `params`):
    corpus_seed              the seed of the mix's sizes, the same for every run
    batch                    rows a step
    steps_per_epoch          steps in the fixed cycle of shapes
    median_s, sigma, min_s, max_s   log-normal utterance durations, clipped
    padding_multiple         frames a bucket spans (the CLI's
                             --batch-time-padding-multiple); a batch is padded
                             to its bucket's longest frame count
    chars_per_s              [lo, hi] char labels a second of audio
    bpe_per_char             BPE labels a char label (a second head's)
    log_interval             the CLI's --log-iteration-interval
    card_cycles              whole cycles of the step shapes run under the
                             profiler after the measured window of an
                             untraced run (0 or absent: none), for
                             `train_card_ms_per_audio_s`
    limits                   the limit of each number `check` compares

Sizes (durations, label lengths, bucket order, a step of the longest bucket
among the first three) come from `corpus_seed`; the run seed draws the
weights, the audio, the labels, the dropout generator, and which rows of a
bucket share a step.
"""
import gc
import math
import time

import numpy as np
import torch

from perfbench import measure, model_plan, signals, weights as weights_lib
from perfbench.reference import jasper as reference

SEED_DROPOUT = 1 << 40


def make_steps(p: dict, config: dict) -> list:
    """The cycle of steps: dict(bucket, durations (s), char label lengths)
    each, in the fixed order of `corpus_seed`, with a step of the longest
    bucket among the first three."""
    g = signals.rng(p['corpus_seed'], 0)
    fe = config['frontend']
    stride, mult = fe['window_stride'], p['padding_multiple']

    def bucket(d):
        return np.ceil((d / stride + 1) / mult).astype(int)

    sample = signals.lognormal_clipped(g, 200_000, p['median_s'], p['sigma'], p['min_s'],
                                       p['max_s'])
    buckets = bucket(sample)
    ids, freq = np.unique(buckets, return_counts=True)
    share = freq / freq.sum() * p['steps_per_epoch']
    counts = np.maximum(np.floor(share).astype(int), 1)
    for i in np.argsort(-(share - np.floor(share))):
        if counts.sum() >= p['steps_per_epoch']:
            break
        counts[i] += 1
    steps = []
    for b, n in zip(ids, counts):
        pool = sample[buckets == b]
        for _ in range(n):
            durs = g.choice(pool, size=p['batch'], replace=False)
            chars = np.maximum(np.round(durs * g.uniform(*p['chars_per_s'], size=p['batch'])), 1)
            steps.append(dict(bucket=int(b), durations=durs, chars=chars.astype(int)))
    steps = [steps[i] for i in g.permutation(len(steps))]
    # the steps the check compares (the first three) hold the longest rows
    # and labels: where the order has no step of the longest bucket among
    # them, its first such step leads the cycle
    if ids.max() not in [s['bucket'] for s in steps[:3]]:
        first = next(i for i, s in enumerate(steps) if s['bucket'] == ids.max())
        steps.insert(0, steps.pop(first))
    return steps


class Batches:
    """Host batches of one run: x float32 (B, T), xlen, y (B, H, L), ylen
    (B, H), padded to the bucket's shape, with the work each one carries."""

    def __init__(self, p: dict, config: dict, seed: int):
        fe, heads = config['frontend'], config['heads']
        arch = weights_lib.arch_of(config)
        classes = [h['classes'] for h in heads]
        hop = int(fe['window_stride'] * fe['sample_rate'])
        steps = make_steps(p, config)
        g = signals.rng(seed, 1)
        # rows of one bucket change steps with the run seed; the shapes and
        # the sum of each bucket's work stay
        by_bucket = {}
        for i, s in enumerate(steps):
            by_bucket.setdefault(s['bucket'], []).append(i)
        rows = {}
        for b, idx in by_bucket.items():
            durs = np.concatenate([steps[i]['durations'] for i in idx])
            chars = np.concatenate([steps[i]['chars'] for i in idx])
            perm = g.permutation(len(durs))
            for k, i in enumerate(idx):
                sel = perm[k * p['batch']:(k + 1) * p['batch']]
                rows[i] = (durs[sel], chars[sel])
        flops_frame = model_plan.conv_flops_per_frame(arch, classes)
        self.host, self.work = [], []
        pad_l = {b: int(math.ceil(max(c for i in idx for c in rows[i][1]) / 128.0)) * 128
                 for b, idx in by_bucket.items()}
        for i, s in enumerate(steps):
            durs, chars = rows[i]
            T = s['bucket'] * p['padding_multiple'] * hop
            n = np.round(durs * fe['sample_rate']).astype(int)
            x = np.zeros((p['batch'], T), np.float32)
            lens = [chars]
            if len(classes) > 1:
                lens.append(np.maximum(np.round(chars * p['bpe_per_char']), 1).astype(int))
            L = pad_l[s['bucket']]
            y = np.zeros((p['batch'], len(classes), L), np.int64)
            ylen = np.stack(lens, axis=1).astype(np.int64)
            for r in range(p['batch']):
                x[r, :n[r]] = signals.speechlike(g, int(n[r]), fe['sample_rate'])
                for h, c in enumerate(classes):
                    y[r, h, :ylen[r, h]] = signals.labels(g, int(ylen[r, h]), c)
            xlen = (n / T).astype(np.float32)
            frames = model_plan.output_frames(arch, fe, T)
            olen = np.array([model_plan.valid_frames(frames, f) for f in xlen])
            assert (olen >= 2 * ylen.max(axis=1) + 1).all(), 'a row would be infeasible'
            ctc = [measure.ctc_counts(olen, ylen[:, h], frames, c) for h, c in enumerate(classes)]
            self.host.append(dict(x=x, xlen=xlen, y=y, ylen=ylen))
            self.work.append(dict(
                bucket=s['bucket'], audio_s=float(n.sum()) / fe['sample_rate'],
                train_flops=3.0 * flops_frame * float(olen.sum()),
                ctc={k: sum(c[k] for c in ctc) for k in ctc[0]}))


def _find(tree, key):
    if isinstance(tree, dict):
        if key in tree:
            return tree[key]
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for t in tree:
            found = _find(t, key)
            if found is not None:
                return found
    return None


class Session:
    """The program's train step at the cell's configuration, its first
    three steps kept for the reference."""

    REFERENCE_STEPS = 3

    def __init__(self, run):
        from convasr_tpu_torch.cli.train import put_batch, transport_cast
        from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
        from convasr_tpu_torch.models.zoo import create_model
        from convasr_tpu_torch.train.loop import (init_train_state, make_optimizer_with_accum,
                                                  make_train_step)
        from convasr_tpu_torch.train.optim import make_optimizer, noop_lr

        p, config, dev = run.params, run.config, torch.device(run.device)
        self.p, self.config, self.device = p, config, dev
        self.options = run.options
        self.batches = Batches(p, config, run.seed)
        fe, opt = config['frontend'], config['train']
        arch = dict(config['architecture'])
        frontend = LogFilterBankFrontend(
            out_channels=fe['num_input_features'], sample_rate=fe['sample_rate'],
            window_size=fe['window_size'], window_stride=fe['window_stride'],
            window=fe['window'], dither=fe['dither'], dither0=0.0)
        classes = tuple(h['classes'] for h in config['heads'])
        dtype = dict(bfloat16=torch.bfloat16, float32=torch.float32)[config['dtype']]
        model = create_model(config['model'], num_input_features=fe['num_input_features'],
                             num_classes=classes, frontend=frontend,
                             decoder_type='bpe' if len(classes) > 1 else None,
                             dropout=arch.pop('dropout'), remat=False, dtype=dtype, **arch)
        model.to(dev)
        drawn = weights_lib.draw(config, run.seed, dev)
        weights_lib.load_into(model, drawn)
        self.start = {n: w.cpu() for n, w in drawn.items()}
        del drawn
        optimizer = make_optimizer_with_accum(
            make_optimizer(opt['optimizer'], noop_lr(opt['lr']), weight_decay=opt['weight_decay'],
                           betas=tuple(opt['betas']), eps=opt['eps']),
            max_grad_norm=opt['max_norm'], accumulate_steps=1)
        self.model, self.state = model, init_train_state(model, optimizer)
        self.step_fn = make_train_step(model, optimizer)
        self.names = [n for n, _ in model.named_parameters()]
        self.transport = opt['transport']
        self._put, self._cast = put_batch, transport_cast
        self.rng = torch.Generator(device=dev).manual_seed(
            (run.seed + SEED_DROPOUT) & 0xFFFF_FFFF_FFFF_FFFF)
        self.rng_start = self.rng.get_state()
        self.nonfinite = torch.zeros((), device=dev)
        self.at = 0
        self.pending = None

        # the first steps, through the window's own feed and call
        first = []
        for k in range(self.REFERENCE_STEPS):
            metrics = self._step(self.batches.host[k])
            first.append(metrics['loss'].detach().clone())
            if k == 0:
                # NovoGrad's state after one step holds the clipped gradient
                # g as its EMA (sum g^2) and momentum (g / sqrt(EMA + eps)
                # + weight decay x the start)
                opt = self.config['train']
                ema = _find(self.state.opt_state, 'grads_ema').double().cpu()
                momentum = _find(self.state.opt_state, 'momentum')
                self.first_grads = {
                    n: ((m.detach().cpu().double() - opt['weight_decay'] * self.start[n].double())
                        * torch.sqrt(e + opt['eps'])).float()
                    for n, m, e in zip(self.names, momentum, ema)}
        self.losses = [float(v) for v in first]
        self.after = {n: q.detach().cpu().clone() for n, q in model.named_parameters()}
        # every other shape of the cycle, once
        done = self.batches.work if self.options.get('no_warmup') else \
            self.batches.work[:self.REFERENCE_STEPS]
        seen = {w['bucket'] for w in done}
        for k, w in enumerate(self.batches.work):
            if w['bucket'] not in seen:
                seen.add(w['bucket'])
                self._step(self.batches.host[k])
        self.at = self.REFERENCE_STEPS
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    def _feed(self, host):
        batch = self._put(self._cast(host, self.transport), self.device)
        if self.options.get('fault') == 'half_batch':
            half = batch['x'].shape[0] // 2
            batch = {k: v[:half] for k, v in batch.items()}
        return batch

    def _step(self, host):
        batch = self._feed(host)
        before = None
        if self.options.get('fault') == 'stale_state':
            before = [q.detach().clone() for q in self.model.parameters()]
        metrics = self.step_fn(self.state, batch, self.rng)
        if before is not None:
            with torch.no_grad():
                for q, b in zip(self.model.parameters(), before):
                    q.copy_(b)
        return metrics

    def _loop(self, run, seconds, record, count=None):
        """Steps over the cycle for `seconds` of host time (or `count`
        steps), then a synchronize; returns (steps, audio s, wall s, train
        FLOPs, CTC work)."""
        n = len(self.batches.host)
        steps, audio, flops = 0, 0.0, 0.0
        ctc = dict(fwd_ops=0.0, fwd_bytes=0.0, bwd_ops=0.0, bwd_bytes=0.0)
        interval = self.p['log_interval']
        t0 = time.perf_counter()
        while (steps < count) if count is not None else (time.perf_counter() - t0 < seconds):
            k = self.at % n
            with run.span('dispatch', record):
                metrics = self._step(self.batches.host[k])
            self.nonfinite += 1.0 - metrics['finite']
            if self.pending is not None:
                with run.span('log', record):
                    float(self.pending['loss'])          # the CLI's late log read
                self.pending = None
            if self.state.step % interval == 0:
                self.pending = metrics
            w = self.batches.work[k]
            steps, audio, flops = steps + 1, audio + w['audio_s'], flops + w['train_flops']
            for key in ctc:
                ctc[key] += w['ctc'][key]
            self.at += 1
        with run.span('sync', record):
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
        return steps, audio, time.perf_counter() - t0, flops, ctc

    def window(self, run, seconds):
        steps, audio, wall, flops, _ = self._loop(run, seconds, True)
        run.values.update(kind='train', steps=steps, audio_s=audio, window_s=wall,
                          train_flops=flops, attempted=steps,
                          failed=int(round(float(self.nonfinite))))
        if not run.trace and self.p.get('card_cycles'):
            self.card_window(run)

    def card_window(self, run):
        """Whole cycles of the step shapes (`card_cycles`), from wherever the
        measured window left the cycle, under the profiler: the card's busy
        seconds in them (the union of its kernel, copy and memset
        intervals) and the audio seconds they trained. A whole cycle is the
        same work in every run, whatever the host's speed."""
        from perfbench import trace as trace_lib
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        count = len(self.batches.host) * int(self.p['card_cycles'])
        with trace_lib.profiled() as reduced:
            with torch.profiler.record_function('perfbench.window'):
                _, audio, _, _, _ = self._loop(run, None, False, count)
        run.values.update(card_busy_s=reduced['busy_s'], card_audio_s=audio)

    def traced_window(self, run, seconds):
        with torch.profiler.record_function('perfbench.window'):
            steps, _, _, _, ctc = self._loop(run, seconds, False)
        run.values.update(traced_steps=steps, traced_ctc=ctc)

    def end_to_end(self, run):
        v = run.values
        out = dict(train_audio_s_per_s=v['audio_s'] / v['window_s'])
        if v.get('card_busy_s'):            # none where no operation ran on a card
            out['train_card_ms_per_audio_s'] = 1e3 * v['card_busy_s'] / v['card_audio_s']
        return out

    def check(self, run):
        """The first three steps against the reference: each step's loss, the
        norm of each leaf's first gradient as the optimizer got it (NovoGrad's
        EMA after one step is its square), and the norm of each leaf's change
        over the three steps."""
        self.model = self.state = self.step_fn = self.pending = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        ref = self.reference('float32')
        prog = dict(losses=self.losses, first_grads=self.first_grads, start=self.start,
                    after=self.after)
        run.values['worst'], numbers = compare(prog, ref)
        if self.options.get('control'):
            # the reference in the program's place, a precision lower
            _, run.values['control_readings'] = compare(
                self.reference(self.options['control']), ref)
        run.values['readings'] = numbers
        limits = self.p['limits']
        return [dict(name=k, value=numbers[k], limit=v, ok=bool(numbers[k] <= v))
                for k, v in limits.items()]

    def reference(self, precision):
        gen = torch.Generator(device=self.device)
        gen.set_state(self.rng_start)
        first = [dict(h, x=signals.to_int16(h['x']))
                 for h in self.batches.host[:self.REFERENCE_STEPS]]
        return reference.train_steps(self.config, self.start, first, gen, self.device, precision)


def compare(prog: dict, ref: dict):
    """(the worst leaves, the numbers): each run's first gradients (as the optimizer got them), parameters
    before and after, and losses, against the reference's:
    loss_gap        the largest relative gap of a step's loss;
    grad_gap, change_gap             the worst leaf's gap between the
                    program's norm of its first gradient (of its change over
                    the steps) and the reference's;
    grad_median_gap, change_median_gap   the median leaf's;
    grad_diff, change_diff           the median leaf's norm of the
                    difference of the two;
    each over the larger of the reference's norm of that leaf and of the
    median leaf. Leaves whose reference gradient is under a thousandth of
    the median leaf's (round-off alone moves them) are left out."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog['losses'], ref['losses']))

    def norms(tensors):
        return {n: float(torch.linalg.vector_norm(t.double())) for n, t in tensors.items()}

    gr = norms(ref['first_grads'])
    med = float(np.median(list(gr.values())))
    kept = [n for n in gr if gr[n] >= 1e-3 * med]
    change = {n: ref['after'][n] - ref['start'][n] for n in kept}
    cr = norms(change)

    def scaled(values, refs):
        m = float(np.median([refs[n] for n in kept]))
        return {n: values[n] / max(refs[n], m) for n in kept}

    gp = norms({n: prog['first_grads'][n] for n in kept})
    cp = norms({n: prog['after'][n] - prog['start'][n] for n in kept})
    grad = scaled({n: abs(gp[n] - gr[n]) for n in kept}, gr)
    chg = scaled({n: abs(cp[n] - cr[n]) for n in kept}, cr)
    grad_diff = scaled(norms({n: prog['first_grads'][n] - ref['first_grads'][n] for n in kept}), gr)
    chg_diff = scaled(norms({n: prog['after'][n] - ref['after'][n] for n in kept}), cr)
    worst = dict(grad=max(grad, key=grad.get), change=max(chg, key=chg.get),
                 grad_diff=max(grad_diff, key=grad_diff.get),
                 change_diff=max(chg_diff, key=chg_diff.get),
                 grad_diff_worst=max(grad_diff.values()), change_diff_worst=max(chg_diff.values()))
    return worst, dict(loss_gap=loss, grad_gap=max(grad.values()), change_gap=max(chg.values()),
                grad_median_gap=float(np.median(list(grad.values()))),
                change_median_gap=float(np.median(list(chg.values()))),
                grad_diff=float(np.median(list(grad_diff.values()))),
                change_diff=float(np.median(list(chg_diff.values()))))



def setup(run):
    return Session(run)
