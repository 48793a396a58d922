"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. build: compiles every kernel in convasr_tpu_torch/csrc/ (one nvcc each,
   all at once) into build/kernels/;
2. transcribe: the port's `cli/transcribe.main` with --align on CUDA, at the
   full width of JasperNetBig (random weights from a seed, 64 log-mel
   features, ru char_legacy head) over synthetic 8 kHz audio with Russian
   reference segments; every kernel's launch count is set to 0 just before
   and read just after, and each kernel of the path must have launched;
3. kernels: the alignment kernel against its plain PyTorch version on the
   card, on the inputs the transcribe run gave it and at two further seeded
   shapes: results bit-equal, times by CUDA events, and the least time the
   card could take (bytes over 3.35 TB/s, operations over the float32 rate);
4. check: the model's log-probs on the card against the same model on the
   CPU on a short input;
5. train: the port's `cli/train.main` on CUDA at full JasperNetBig width
   (bf16, NovoGrad lr 1e-2, dropout 0.2) on a seeded synthetic corpus of
   Russian segments of 4-10 s: 8 steps of 32 rows, one validation pass over
   16 segments and a checkpoint, which is loaded back; the launch counts are
   set to 0 just before and read just after, and both CTC loss kernels must
   have launched; three more steps under torch.profiler give the step's
   kernel time by kind and the card's idle share;
6. kernels: the CTC loss kernels against their plain versions on the card,
   on the inputs the train run gave them and at two seeded shapes, with
   torch.nn.functional.ctc_loss timed beside them as the library yardstick;
7. check: one float32 train step of JasperNetBig on the card against the
   same step on the CPU.

Prints the card's name and power limit, one JSON line of kernels, and as the
last line {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA device or the port is not beside this script; any
failing phase raises.
"""
import copy
import json
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
WORK = ROOT / 'build' / 'chip_smoke'
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # float32 outside the tensor cores
SR = 8000
WORDS = ('привет мир раз два три доброе утро город река солнце небо поле лес '
         'дорога окно стол книга время слово голос вода земля').split()


def log(*a):
    print('[chip_smoke]', *a, flush=True)


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def viterbi_bound_ms(log_probs, targets, xlen):
    """Least time for the alignment on these inputs: the valid frames of
    log_probs, the targets and lengths read once, char frames and final alpha
    written once (bytes); ~6 float32 operations per lattice state and valid
    frame (operations). Returns (ms, 'bytes' | 'operations')."""
    B, T, C = log_probs.shape
    L = targets.shape[1]
    S = 2 * L + 1
    frames = int(xlen.clamp(max=T).sum())
    nbytes = frames * C * 4 + B * L * 4 + 2 * B * 4 + B * L * 4 + B * S * 4
    ops = 6 * frames * S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def ctc_loss_bound_ms(xlen, B, T, C, L):
    """Least time for each CTC loss kernel on these inputs -> dict of
    (ms, 'bytes' | 'operations') for 'alpha' and 'beta_grad'. Bytes: the valid
    log-prob frames, targets and lengths read once; the loss written once
    (alpha), the (B, T, C) gradient written once (beta_grad); alpha between
    the two is an intermediate. Operations: ~12 float32 operations (4 of them
    transcendentals, counted at the plain float32 rate) per lattice state and
    valid frame."""
    frames = int(xlen.clamp(0, T).sum())
    S = 2 * L + 1
    small = B * L * 4 + 3 * B * 4
    nbytes = dict(alpha=frames * C * 4 + small + B * 4,
                  beta_grad=frames * C * 4 + small + B * 4 + B * T * C * 4)
    t_ops = 12 * frames * S / FP32_OPS_PER_S * 1e3
    out = {}
    for name, n in nbytes.items():
        t_bytes = n / HBM_BYTES_PER_S * 1e3
        out[name] = (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')
    return out


def random_words(rng, n_chars):
    words = []
    while len(' '.join(words)) < n_chars:
        words.append(WORDS[rng.randint(len(WORDS))])
    return ' '.join(words)


def speechlike(rng, n):
    t = np.arange(n) / SR
    tone = np.sin(2 * np.pi * (300 + 200 * np.sin(2 * np.pi * 0.5 * t)) * t)
    return (0.05 * rng.randn(n) + 0.2 * tone * (rng.rand(n // 800 + 1).repeat(800)[:n] > 0.3))


def train_corpus(name, num_segments, seed):
    """One wav per segment (the train dataset reads whole files), 4-10 s long,
    each with ~11 Russian characters a second of reference text."""
    from convasr_tpu_torch.audio import write_audio
    rng = np.random.RandomState(seed)
    entries, total = [], 0.0
    for k in range(num_segments):
        seconds = round(float(rng.uniform(4.0, 10.0)), 2)
        path = str(WORK / f'{name}{k:03d}.wav')
        write_audio(path, speechlike(rng, int(SR * seconds)).astype(np.float32)[None], SR)
        entries.append(dict(audio_path=path, ref=random_words(rng, int(11 * seconds)),
                            begin=0.0, end=seconds))
        total += seconds
    manifest = str(WORK / f'{name}.json')
    with open(manifest, 'w') as fh:
        json.dump(entries, fh, ensure_ascii=False)
    return manifest, total


def synthetic_corpus(num_files=2, segments=8, seconds=6.0, seed=0):
    from convasr_tpu_torch.audio import write_audio
    rng = np.random.RandomState(seed)
    entries, total = [], 0.0
    for f in range(num_files):
        n = int(SR * seconds * segments)
        path = str(WORK / f'utt{f}.wav')
        write_audio(path, speechlike(rng, n).astype(np.float32)[None], SR)
        total += n / SR
        for k in range(segments):
            entries.append(dict(audio_path=path, ref=random_words(rng, 75),
                                begin=k * seconds, end=(k + 1) * seconds - 0.01))
    corpus = str(WORK / 'corpus.json')
    with open(corpus, 'w') as fh:
        json.dump(entries, fh, ensure_ascii=False)
    return corpus, total, len(entries)


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is visible', file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from convasr_tpu_torch.cli import train as train_cli  # noqa: F401 (the port is here)
        from convasr_tpu_torch.cli import transcribe
        from convasr_tpu_torch.models.zoo import create_model
        from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
        from convasr_tpu_torch.ops import align, build, ctc_loss
        from convasr_tpu_torch.ops.ctc import ctc_alignment
        from convasr_tpu_torch.train.checkpoints import save_checkpoint
    except ImportError as e:
        print(f'chip_smoke: the port is not beside this script ({e})', file=sys.stderr)
        return 1
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    device = torch.device('cuda')
    WORK.mkdir(parents=True, exist_ok=True)
    log('card:', card, '| torch', torch.__version__, 'cuda', torch.version.cuda)

    # 1. build
    tic = time.perf_counter()
    names = build.build_all()
    log(f'build: {names} in {time.perf_counter() - tic:.2f} s')
    for name, info in build.BUILD_LOG.items():
        regs = [line.split('ptxas info    : ')[-1] for line in info['ptxas'].splitlines()
                if 'registers' in line]
        log(f'build {name}: nvcc {info["seconds"]:.2f} s; ' + ' | '.join(regs))

    # 2. transcribe --align at full JasperNetBig width
    corpus, audio_seconds, num_segments = synthetic_corpus()
    text_args = dict(text_config=str(ROOT / 'configs' / 'ru_text_config.json'),
                     text_pipelines=['char_legacy'])
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = create_model('JasperNetBig', num_input_features=64, num_classes=(38,),
                             frontend=LogFilterBankFrontend(64, SR, 0.02, 0.01, dither=0.0))
    ckpt = str(WORK / 'jasper_big_random.pt')
    save_checkpoint(ckpt, model, dict(model='JasperNetBig', sample_rate=SR, window_size=0.02,
                                      window_stride=0.01, window='hann_window',
                                      num_input_features=64, **text_args))
    log(f'checkpoint: JasperNetBig, {sum(p.numel() for p in model.parameters()) / 1e6:.1f} M '
        f'parameters, seed 0; corpus {num_segments} segments, {audio_seconds:.0f} s of audio')

    seen, calls = {}, []
    setup, kernel = transcribe.setup, align.ctc_alignment_kernel

    def spy_setup(args):
        tic = time.perf_counter()
        out = setup(args)
        seen['model'], seen['setup_s'] = out[2], time.perf_counter() - tic
        return out

    def spy_kernel(*a, **kw):
        calls.append(([t.clone() if torch.is_tensor(t) else t for t in a], dict(kw)))
        return kernel(*a, **kw)

    transcribe.setup, align.ctc_alignment_kernel = spy_setup, spy_kernel
    out_dir = str(WORK / 'transcribe')
    args = transcribe.build_parser().parse_args(
        ['--checkpoint', ckpt, '-i', corpus, '-o', out_dir, '--device', 'cuda', '--align',
         '--output-json', '--output-csv', '--mono', '--profile-phases'])
    align.KERNEL_LAUNCHES = ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = 0
    torch.cuda.synchronize()
    tic = time.perf_counter()
    transcribe.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(ctc_viterbi_align=align.KERNEL_LAUNCHES)
    transcribe.setup, align.ctc_alignment_kernel = setup, kernel

    params = list(seen['model'].parameters())
    assert params and all(p.is_cuda for p in params), 'model parameters are not on CUDA'
    assert all(n > 0 for n in launches.values()), f'a kernel of the path never ran: {launches}'
    outputs = sorted(os.listdir(out_dir))
    assert 'transcripts.csv' in outputs and sum(o.endswith('.json') for o in outputs) == 2, outputs
    segments = [s for o in outputs if o.endswith('.json')
                for s in json.load(open(os.path.join(out_dir, o)))]
    assert len(segments) == num_segments and all(
        np.isfinite([s['begin'], s['end'], s['cer']]).all() for s in segments), segments[:2]
    decode = wall - seen['setup_s']
    log(f'transcribe --align: {wall:.2f} s wall for {audio_seconds:.0f} s of audio = '
        f'{audio_seconds / wall:.1f} audio-seconds/s; of it setup (checkpoint load, model '
        f'to the card) {seen["setup_s"]:.2f} s, the rest {decode:.2f} s = '
        f'{audio_seconds / decode:.1f} audio-seconds/s; launches {launches}; '
        f'{len(segments)} segments written')

    # 3. kernels against their plain versions, at the main path's inputs first
    rng = np.random.RandomState(1)

    def seeded_inputs(B, T, L, C=38, blank=37):
        lp = torch.log_softmax(torch.from_numpy(rng.randn(B, T, C).astype(np.float32) * 3), -1)
        y = torch.from_numpy(rng.randint(0, blank, size=(B, L)))
        xlen = torch.full((B,), T, dtype=torch.int32)
        xlen[1] = T * 2 // 3                                   # a row with xlen < T
        ylen = torch.from_numpy(rng.randint(L // 2, L + 1, size=B).astype(np.int32))
        ylen[-1] = 0                                           # a row with no targets
        return [t.to(device) for t in (lp, y, xlen, ylen)], dict(blank=blank)

    a, kw = calls[0]
    cases = [('main path', a, kw), ('B8 T300 L80', *seeded_inputs(8, 300, 80)),
             ('B64 T1500 L400', *seeded_inputs(64, 1500, 400))]
    records = []
    for label, a, kw in cases:
        frames, final = kernel(*a, return_final=True, **kw)
        ref_frames, ref_final = ctc_alignment(*a, return_final=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(frames, ref_frames), f'{label}: char frames differ from the plain version'
        assert torch.equal(final, ref_final), f'{label}: final alpha differs from the plain version'
        err = float((final - ref_final).abs().max())
        ms = cuda_ms(lambda: kernel(*a, **kw), reps=20)
        plain_ms = cuda_ms(lambda: ctc_alignment(*a, **kw), reps=2)
        bound, bound_by = viterbi_bound_ms(a[0], a[1], a[2])
        B, T, C = a[0].shape
        log(f'ctc_viterbi_align [{label}] B={B} T={T} C={C} L={a[1].shape[1]}: bit-equal; '
            f'kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound:.5f} ms ({bound_by}); '
            f'int8 backpointers {B * T * (2 * a[1].shape[1] + 1) / 1e6:.2f} MB')
        records.append((label, ms, plain_ms, bound, bound_by, err))
    _, ms, plain_ms, bound, bound_by, err = records[0]
    kernels = [dict(name='ctc_viterbi_align', route='cuda',
                    source='convasr_tpu_torch/csrc/ctc_viterbi.cu',
                    replaces='convasr_tpu/ops/align_pallas.py:28',
                    launches=launches['ctc_viterbi_align'], max_abs_err=err, ms=ms,
                    plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by, library_ms=None)]

    # 4. the model on the card against the same model on the CPU, float32
    cpu_model = create_model('JasperNetBig', num_input_features=64, num_classes=(38,),
                             frontend=LogFilterBankFrontend(64, SR, 0.02, 0.01, dither=0.0))
    cpu_model.load_state_dict(torch.load(ckpt, weights_only=True)['model_state_dict'])
    cpu_model.eval()
    card_model = copy.deepcopy(cpu_model).to(device)
    x = torch.from_numpy((0.1 * np.random.RandomState(2).randn(2, SR)).astype(np.float32))
    xlen = torch.tensor([1.0, 0.7])
    with torch.inference_mode():
        on_card = card_model(x.to(device), xlen=xlen.to(device))['log_probs'][0].cpu()
        on_cpu = cpu_model(x, xlen=xlen)['log_probs'][0]
    diff = float((on_card - on_cpu).abs().max())
    assert torch.isfinite(on_card).all() and on_card.shape == (2, 51, 38), on_card.shape
    assert diff < 1e-3, f'card vs CPU log-probs differ by {diff}'
    log(f'check: JasperNetBig float32 log-probs card vs CPU max |diff| {diff:.2e} (< 1e-3)')

    kernels += train_phases(device)

    print(card)
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps(dict(ok=True, device=dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                                               count=torch.cuda.device_count()))))
    return 0


def profile_train_step(device, model, batch, loop, optim):
    """Where a train step's card time goes: after one warm-up step, three
    steps of the trained model on the run's last batch timed as they are,
    then three under torch.profiler; kernel time summed by kind, and the
    card's idle share of each window."""
    from torch.profiler import ProfilerActivity, profile
    tx = loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', optim.noop_lr(1e-2), weight_decay=1e-3),
        max_grad_norm=100.0)
    state = loop.init_train_state(model, tx)
    step = loop.make_train_step(model, tx)
    gen = torch.Generator(device=device).manual_seed(0)
    step(state, batch, gen)
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(3):
        step(state, batch, gen)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - tic) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(3):
            step(state, batch, gen)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) * 1e3
    kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total}
    kinds = {}
    for key, ms in kernels.items():
        name = key.lower()
        kind = ('ctc loss kernels' if 'ctc_alpha' in name or 'ctc_beta_grad' in name else
                'batch norm' if any(k in name for k in ('batch_norm', 'batchnorm', 'bn_')) else
                'optimizer (foreach)' if 'foreach' in name or 'multi_tensor' in name else
                'convolutions' if any(k in name for k in ('conv', 'gemm', 'xmma', 'cutlass',
                                                          'cudnn', 'implicit', 'sm90')) else
                'other')
        kinds[kind] = kinds.get(kind, 0.0) + ms
    busy = sum(kinds.values())
    if not busy:
        log('profile: torch.profiler recorded no kernel time on the card; not measured')
        return
    log(f'profile: 3 steps of {tuple(batch["x"].shape)} in {plain_wall_ms:.1f} ms wall '
        f'({wall_ms:.1f} ms under the profiler); kernel ms '
        + ', '.join(f'{k} {v:.1f} ({v / busy:.1%})'
                    for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
        + f'; card idle {max(0.0, 1 - busy / plain_wall_ms):.1%} of the wall without the '
        f'profiler ({max(0.0, 1 - busy / wall_ms):.1%} under it); top kernels: '
        + '; '.join(f'{k[:70]} {v:.1f}' for k, v in sorted(kernels.items(),
                                                           key=lambda kv: -kv[1])[:8]))


def train_phases(device):
    """Phases 5-7; returns the JSON records of the two CTC loss kernels."""
    import torch.nn.functional as F
    from convasr_tpu_torch.cli import train as train_cli
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.ops import align, ctc_loss
    from convasr_tpu_torch.train import loop, optim
    from convasr_tpu_torch.train.checkpoints import load_train_checkpoint

    # 5. train at full JasperNetBig width
    train_json, train_seconds = train_corpus('train', 96, seed=3)
    val_json, _ = train_corpus('val', 16, seed=4)
    exp_dir = WORK / 'train'
    seen, steps, k1_calls = {}, [], []
    make_step, beta_grad = train_cli.make_train_step, ctc_loss.beta_grad_kernel

    def spy_make_step(model, *a, **kw):
        seen['model'] = model
        seen['initial'] = [p.detach().clone() for p in model.parameters()]
        step = make_step(model, *a, **kw)

        def timed(state, batch, generator=None):
            seen['batch'] = batch
            torch.cuda.synchronize()
            tic = time.perf_counter()
            metrics = step(state, batch, generator)
            torch.cuda.synchronize()
            audio = float(batch['xlen'].sum()) * batch['x'].shape[1] / SR
            steps.append((time.perf_counter() - tic, audio, tuple(batch['x'].shape)))
            return metrics
        return timed

    def spy_beta_grad(*a, **kw):
        if not k1_calls:
            k1_calls.append([t.clone() if torch.is_tensor(t) else t for t in a])
        return beta_grad(*a, **kw)

    train_cli.make_train_step, ctc_loss.beta_grad_kernel = spy_make_step, spy_beta_grad
    args = train_cli.build_parser().parse_args(
        ['--train-data-path', train_json, '--val-data-path', val_json,
         '--experiments-dir', str(exp_dir), '--experiment-id', 'jasper_big',
         '--train-batch-size', '32', '--val-batch-size', '16', '--iterations', '8',
         '--val-iteration-interval', '8', '--log-iteration-interval', '1', '--epochs', '3',
         '--skip-on-epoch-end-evaluation', '--num-workers', '4',
         '--text-config', str(ROOT / 'configs' / 'ru_text_config.json'),
         '--val-config', str(ROOT / 'configs' / 'ru_val_config.json')])
    assert args.device == 'cuda' and args.model == 'JasperNetBig' and args.bf16
    align.KERNEL_LAUNCHES = ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    train_cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                    ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES)
    train_cli.make_train_step, ctc_loss.beta_grad_kernel = make_step, beta_grad
    peak = torch.cuda.max_memory_allocated()

    model = seen['model']
    params = list(model.parameters())
    assert params and all(p.is_cuda for p in params), 'model parameters are not on CUDA'
    assert len(steps) == 8, f'{len(steps)} train steps ran'
    val_batches = 1
    assert launches['ctc_loss_beta_grad'] == 8 and \
        launches['ctc_loss_alpha'] == 8 + val_batches, f'CTC loss kernel launches {launches}'
    logged = [json.loads(line) for line in open(exp_dir / 'jasper_big' / 'log.json')]
    assert [m['iteration'] for m in logged] == list(range(1, 9)), logged
    assert all(np.isfinite(m['loss']) and m['finite'] == 1.0 for m in logged), logged
    moved = sum(float((p.detach() - p0).abs().max()) > 0 for p, p0 in zip(params, seen['initial']))
    assert moved > 0.9 * len(params), f'only {moved} of {len(params)} parameters moved'
    ckpt_path = sorted((exp_dir / 'jasper_big').glob('checkpoint_epoch*_iter0000008.pt'))[-1]
    ckpt = load_train_checkpoint(str(ckpt_path), device)
    fresh = copy.deepcopy(model)
    fresh.load_state_dict(ckpt['model_state_dict'])
    assert ckpt['step'] == 8 and all(torch.equal(a, b) for a, b in zip(
        fresh.state_dict().values(), model.state_dict().values())), 'checkpoint does not load back'
    times = [t for t, _, _ in steps]
    median = statistics.median(times[2:])
    audio = statistics.mean(a for _, a, _ in steps[2:])
    log(f'train: JasperNetBig {sum(p.numel() for p in params) / 1e6:.1f} M parameters, bf16, '
        f'8 steps of 32 rows, batch shapes {sorted(set(s for _, _, s in steps))}; wall '
        f'{wall:.1f} s incl. setup, validation and checkpoint ({train_seconds:.0f} s of train '
        f'audio in the corpus); first step {times[0] * 1e3:.1f} ms, median of steps 3-8 '
        f'{median * 1e3:.1f} ms = {audio / median:.1f} audio-seconds trained per second '
        f'({audio:.1f} s of audio a step); step ms {[round(t * 1e3, 1) for t in times]}; '
        f'losses {[round(m["loss"], 3) for m in logged]}; '
        f'max_memory_allocated {peak / 2 ** 30:.2f} GiB; launches {launches}; checkpoint '
        f'{ckpt_path.name} loads back')

    profile_train_step(device, model, seen['batch'], loop, optim)

    # 6. the CTC loss kernels against their plain versions
    rng = np.random.RandomState(5)

    def seeded(B, T, L, C=38, blank=37):
        lp = torch.log_softmax(torch.from_numpy(rng.randn(B, T, C).astype(np.float32) * 3), -1)
        y = torch.from_numpy(rng.randint(0, blank, size=(B, L)))
        xlen = torch.full((B,), T, dtype=torch.int32)
        ylen = torch.from_numpy(rng.randint(L // 2, L // 2 + L // 4 + 1, size=B).astype(np.int32))
        xlen[1] = T * 2 // 3                                   # a row with xlen < T
        ylen[-1] = 0                                           # a row with no targets
        xlen[2], ylen[2] = L // 2, L                           # an infeasible row
        g = torch.full((B,), 1.0 / B)
        return [t.to(device) for t in (lp, y, xlen, ylen)] + [blank, g.to(device)]

    lp, y, xlen, ylen, alpha_in, ll_in, g, blank = k1_calls[0]
    cases = [('train path', [lp, y, xlen, ylen, blank, g]),
             ('B16 T300 L80', seeded(16, 300, 80)), ('B64 T500 L160', seeded(64, 500, 160))]
    records = []
    for label, (lp, y, xlen, ylen, blank, g) in cases:
        alpha, ll = ctc_loss.alpha_kernel(lp, y, xlen, ylen, blank)
        grad = ctc_loss.beta_grad_kernel(lp, y, xlen, ylen, alpha, ll, g, blank)
        ref_alpha, ref_ll = ctc_loss.alpha_plain(lp, y, xlen, ylen, blank)
        ref_grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, ref_alpha, ref_ll, g, blank)
        torch.cuda.synchronize()
        feasible = ref_ll > -5e29
        assert torch.equal(ll > -5e29, feasible), f'{label}: feasible rows differ'
        loss_err = float(((ll - ref_ll).abs() / ref_ll.abs().clamp(min=1))[feasible].max())
        loss_abs_err = float((ll - ref_ll).abs()[feasible].max())
        grad_err = float((grad - ref_grad).abs().max())
        assert loss_err < 1e-5, f'{label}: loss differs from the plain version by {loss_err}'
        # gamma in [0, 1], summed per class with shared-memory atomics
        assert torch.allclose(grad, ref_grad, rtol=1e-3, atol=1e-4), \
            f'{label}: gradient differs from the plain version by {grad_err}'
        if label == 'train path':
            assert bool(feasible.all()), 'an infeasible row on the train path'
        B, T, C = lp.shape
        L = y.shape[1]
        fwd_ms = cuda_ms(lambda: ctc_loss.alpha_kernel(lp, y, xlen, ylen, blank), reps=20)
        bwd_ms = cuda_ms(lambda: ctc_loss.beta_grad_kernel(lp, y, xlen, ylen, alpha, ll, g,
                                                           blank), reps=20)

        def pair():
            a, l_ = ctc_loss.alpha_kernel(lp, y, xlen, ylen, blank)
            ctc_loss.beta_grad_kernel(lp, y, xlen, ylen, a, l_, g, blank)
        pair_ms = cuda_ms(pair, reps=20)
        plain_fwd_ms = cuda_ms(lambda: ctc_loss.alpha_plain(lp, y, xlen, ylen, blank), reps=2)
        plain_bwd_ms = cuda_ms(lambda: ctc_loss.beta_grad_plain(
            lp, y, xlen, ylen, ref_alpha, ref_ll, g, blank), reps=2)
        # the library yardstick: F.ctc_loss on (T, B, C), checked first
        lp_tbc = lp.transpose(0, 1).contiguous()
        lib = F.ctc_loss(lp_tbc, y.long(), xlen.long(), ylen.long(), blank=blank,
                         reduction='none')
        ok = feasible & torch.isfinite(lib)
        lib_err = float(((lib - (-ll)).abs() / lib.abs().clamp(min=1))[ok].max())
        assert lib_err < 1e-4 and bool((~torch.isfinite(lib) == ~feasible).all()), \
            f'{label}: F.ctc_loss disagrees with the kernels ({lib_err})'
        lib_fwd_ms = cuda_ms(lambda: F.ctc_loss(lp_tbc, y.long(), xlen.long(), ylen.long(),
                                                blank=blank, reduction='none'), reps=20)
        leaf = lp_tbc.detach().requires_grad_()

        def lib_pair():
            out = F.ctc_loss(leaf, y.long(), xlen.long(), ylen.long(), blank=blank,
                             reduction='none')
            torch.autograd.grad(out, leaf, g)
        lib_pair_ms = cuda_ms(lib_pair, reps=20)
        bounds = ctc_loss_bound_ms(xlen, B, T, C, L)
        log(f'ctc_loss [{label}] B={B} T={T} C={C} L={L}: loss rel err {loss_err:.2e}, grad '
            f'max abs err {grad_err:.2e}; kernels fwd {fwd_ms:.4f} ms, bwd {bwd_ms:.4f} ms, '
            f'pair {pair_ms:.4f} ms; plain fwd {plain_fwd_ms:.2f} ms, bwd {plain_bwd_ms:.2f} ms; '
            f'F.ctc_loss fwd {lib_fwd_ms:.4f} ms, fwd+bwd {lib_pair_ms:.4f} ms (rel err '
            f'{lib_err:.2e}); bound fwd {bounds["alpha"][0]:.5f} ms ({bounds["alpha"][1]}), '
            f'bwd {bounds["beta_grad"][0]:.5f} ms ({bounds["beta_grad"][1]}); alpha '
            f'{B * T * (2 * L + 1) * 4 / 1e6:.1f} MB')
        records.append(dict(alpha=(fwd_ms, plain_fwd_ms, *bounds['alpha'], lib_fwd_ms,
                                   loss_abs_err),
                            beta_grad=(bwd_ms, plain_bwd_ms, *bounds['beta_grad'], lib_pair_ms,
                                       grad_err)))

    kernels = []
    for name, key, line in (('ctc_loss_alpha', 'alpha', 36), ('ctc_loss_beta_grad', 'beta_grad', 63)):
        ms, plain_ms, bound, bound_by, lib_ms, err = records[0][key]
        kernels.append(dict(name=name, route='cuda', source='convasr_tpu_torch/csrc/ctc_loss.cu',
                            replaces=f'convasr_tpu/ops/ctc_pallas_v2.py:{line}',
                            launches=launches[name], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound, bound_by=bound_by, library_ms=lib_ms))

    # 7. one float32 train step on the card against the same step on the CPU
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False     # TF32 keeps ~3 digits; the check wants float32
    try:
        def build():
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(7)
                return create_model('JasperNetBig', num_input_features=64, num_classes=(38,),
                                    dropout=0.0, frontend=LogFilterBankFrontend(
                                        64, SR, 0.02, 0.01, dither=0.0))
        batch_rng = np.random.RandomState(8)
        host = dict(x=(0.1 * batch_rng.randn(2, SR)).astype(np.float32),
                    xlen=np.array([1.0, 0.8], np.float32),
                    y=batch_rng.randint(0, 37, size=(2, 1, 12)).astype(np.int64),
                    ylen=np.array([[12], [9]], np.int64))
        results = []
        for dev in (device, torch.device('cpu')):
            m = build().to(dev)
            tx = loop.make_optimizer_with_accum(
                optim.make_optimizer('NovoGrad', optim.noop_lr(1e-2), weight_decay=1e-3),
                max_grad_norm=100.0)
            state = loop.init_train_state(m, tx)
            before = [p.detach().clone() for p in m.parameters()]
            metrics = loop.make_train_step(m, tx)(
                state, {k: torch.from_numpy(v).to(dev) for k, v in host.items()})
            delta = [(p.detach() - b).cpu() for p, b in zip(m.parameters(), before)]
            results.append((float(metrics['loss']), delta, [n for n, _ in m.named_parameters()]))
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    (card_loss, card_delta, names), (cpu_loss, cpu_delta, _) = results
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    # per tensor, |update on the card - update on the CPU| / |update on the CPU|;
    # the 1x1 residual convs' biases feed a batch norm that cancels them, so
    # their gradients and updates are rounding noise and are left out
    update_rel = max(float((a - b).norm() / b.norm()) for a, b, n in
                     zip(card_delta, cpu_delta, names)
                     if not ('conv_residual' in n and n.endswith('.bias')) and b.norm() > 0)
    assert np.isfinite(card_loss) and loss_rel < 1e-4, \
        f'card vs CPU train-step loss {card_loss} vs {cpu_loss}'
    assert update_rel < 1e-2, f'card vs CPU parameter updates differ by {update_rel:.2e}'
    log(f'check: JasperNetBig float32 train step (B=2, 1 s, TF32 off) card vs CPU: loss '
        f'{card_loss:.6f} vs {cpu_loss:.6f} (rel {loss_rel:.2e} < 1e-4); largest relative '
        f'difference of a tensor\'s update {update_rel:.2e} (< 1e-2)')
    return kernels


if __name__ == '__main__':
    sys.exit(main())
