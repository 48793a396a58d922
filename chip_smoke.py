"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. build: compiles every kernel in convasr_tpu_torch/csrc/ (one nvcc each,
   all at once) into build/kernels/, and beside them the host C++ beam
   (native/ctc_beam.cpp, g++) into build/native/;
2. transcribe: the port's `cli/transcribe.main` with --align on CUDA, at the
   full width of JasperNetBig (random weights from a seed, 64 log-mel
   features, ru char_legacy head) over synthetic 8 kHz audio with Russian
   reference segments; every kernel's launch count is set to 0 just before
   and read just after, and each kernel of the path must have launched;
   (the warp alignment kernel on every batch, the block pair never);
3. kernels: both alignment kernels (the warp kernel, the block pair) against
   their plain PyTorch version on the card, on the inputs the transcribe run
   gave them, at two further seeded shapes (B8 T300 L80, B64 T1500 L400) and
   at each shape of the route's sweep (B8 T301 and B32 T500 at S 257, 513,
   801, 1023): char frames and final alpha bit-equal, times by CUDA events in
   turns, the least time the card could take (bytes over 3.35 TB/s,
   operations over the float32 rate), the block pair's forward and
   backtrace apart (torch.profiler), the route each shape takes and whether
   it is the faster kernel's;
4. check: the model's log-probs on the card against the same model on the
   CPU on a short input;
5. train: the port's `cli/train.main` on CUDA at full JasperNetBig width
   (bf16, NovoGrad lr 1e-2, dropout 0.2) on a seeded synthetic corpus of
   Russian segments of 4-10 s: 8 steps of 32 rows, one validation pass over
   16 segments and a checkpoint, which is loaded back; the launch counts are
   set to 0 just before and read just after: the forward kernel must have
   launched 9 times, the warp backward kernel 8 times and the block one
   never; three more steps under torch.profiler give the step's kernel time
   by kind and the card's idle share;
6. kernels: the CTC loss kernels (forward, warp backward, block backward)
   against their plain versions on the card, on the inputs the train run gave
   them and at two seeded shapes (the forward's alpha itself, its ll and
   feasible set, at the path's ring depth and at each depth of the sweep),
   with torch.nn.functional.ctc_loss timed beside them as the library
   yardstick; the forward timed at each ring depth (2, 4, 8, 16, 32 frames,
   in turns); the warp backward timed against the block one at S 321, 513, 769
   and 1023 (B32 T500), where the route's crossover lies; the block kernel's
   route (a lattice past the warp kernel's reach) through ctc_loss_auto,
   counted apart (the kernels line gives every kernel its launches on the
   train path);
7. check: one float32 train step of JasperNetBig on the card against the
   same step on the CPU;
8. transcribe --quantize int8 --align: the port's `cli/transcribe.main` on
   CUDA over the corpus of phase 2, on the checkpoint of phase 2, calibrating
   on one batch into a fresh activation-scales cache; the launch counts are
   set to 0 just before and read just after: the wgmma int8 conv must have
   launched 32 times a batch, the mma.sync conv loop never, the wgmma GEMM
   12 times a batch (K 256-4096), the mma.sync whole-K and K-tiled GEMMs
   never, the warp alignment kernel once (the block pair never), and the
   weights packed once per tree
   (32 conv packs; phase 10 counts the one-tap weights the GEMM rule takes);
9. kernels: the int8 conv and GEMM kernels against their plain versions
   (float64 on the card, exact) on inputs the int8 run gave them and at the
   TPU probes' shapes: results bit-equal, times by CUDA events, the bound
   (int8 operations over 1,979 TOPS or bytes over 3.35 TB/s), and as library
   yardsticks torch._int_mm for the GEMMs (N padded to a multiple of 8) and
   cuDNN's bf16 F.conv1d at the conv's shape; the port calls neither. Every
   GEMM of a batch is held against the plain version; at each distinct path
   GEMM shape, at M4096 K1792 N4096 and at 4096^3 the wgmma GEMM is timed
   beside the mma.sync kernel of that depth and torch._int_mm, by events and
   queued; the whole-K and K-tiled kernels' routes (K % 16 != 0: K 1000, K
   1800) are driven through int8_matmul_auto, counted apart (the kernels line
   gives every kernel its launches on the int8 path of phase 8). The wgmma conv is timed beside the
   mma.sync loop at block 10's and the probe's shape, and must beat the loop
   at both; then each of the 32 path convs of a batch, on its captured
   inputs, beside the mma.sync loop and bf16 cuDNN (CUDA events), and the
   two kernels' own time per conv with every launch queued before the first
   runs, with the sums;
10. check: the int8 JasperNetBig forward on the card against the same
   quantized tree on the CPU on a short input, and its agreement with the
   float32 model;
11. beam transcribe: the port's `cli/transcribe.main` on CUDA (bf16) over the
   corpus and checkpoint of phase 2 with each beam decoder, on LMs trained in
   the run from WORDS with the port's ngram_lm: BeamSearchDecoderDevice
   (width 16, top 8 chars, a char bigram fused on the card),
   BeamSearchDecoderDeviceLM (width 16, its hypotheses rescored with a word
   trigram) and BeamSearchDecoder (the host C++ beam, width 64, the word
   trigram fused); wall time, audio-seconds/s and decode seconds per batch;
   a spy asserts that the device beam's inputs are CUDA tensors;
12. check: the device beam on the card against the same call on the CPU, on
   phase 11's log-probs: tokens and lengths bit-equal, scores within 1e-4;
   the card call's kernel launches per frame and busy share by
   torch.profiler;
13. kernels: the whole-T CTC loss (K2f/K2b, ctc_loss_whole_t: no CLI path
   reaches it) driven forward and backward on phase 5's captured train batch
   with its launch counts set to 0 just before and read just after (K2b on
   K1b's warp kernel, the whole-T block kernel never), then once past the
   warp rule (S 601) on the whole-T block kernel, counted apart, against the
   plain version on the CPU; both K2b kernels and K2f held against their plain
   versions on the train batch and at phase 6's two seeded shapes, timed in
   turns beside K1 and torch.nn.functional.ctc_loss.

Prints the card's name and power limit, one JSON line of kernels, and as the
last line {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA device or the port is not beside this script; any
failing phase raises.
"""
import concurrent.futures
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
INT8_OPS_PER_S = 1979e12       # dense int8 on the tensor cores
DEPTHS = (2, 4, 8, 16, 32)     # the CTC forward's ring depths, swept in phase 6
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


def queued_ms(fn, reps):
    """The card's own time for one call of fn: as cuda_ms, but the stream is
    held by a spin kernel until the host has queued all `reps` calls, so the
    wrapper's host work between launches is not in the time. None if the
    spin ended before the last call was queued, four times over."""
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(4):
        torch.cuda._sleep(10_000_000 << attempt)     # ~5 ms of clock cycles, doubled each try
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(stop) / reps
    return None


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
        from convasr_tpu_torch.native import build as native_build
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
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(native_build.build_library, 'ctc_beam.cpp')
        names = build.build_all()
        native = native.result()
    log(f'build: {names} and {native.name} (g++) in {time.perf_counter() - tic:.2f} s')
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
    align.WARP_LAUNCHES = align.BLOCK_LAUNCHES = 0
    ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0
    torch.cuda.synchronize()
    tic = time.perf_counter()
    transcribe.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(ctc_viterbi_align_warp=align.WARP_LAUNCHES,
                    ctc_viterbi_align=align.BLOCK_LAUNCHES)
    transcribe.setup, align.ctc_alignment_kernel = setup, kernel

    params = list(seen['model'].parameters())
    assert params and all(p.is_cuda for p in params), 'model parameters are not on CUDA'
    # the path's lattice (L 128, S 257) is inside the warp kernel's rule: every
    # batch on it, the block pair never
    assert launches == dict(ctc_viterbi_align_warp=len(calls), ctc_viterbi_align=0) and calls, \
        f'alignment launches {launches} for {len(calls)} batches'
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

    # 3. the alignment kernels against their plain version, at the main path's
    # inputs first: both kernels bit-equal wherever they reach, timed in turns
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
    # the route's sweep: the path's lattice, K1b's crossover, the seeded
    # B64 T1500 lattice and the warp kernel's reach
    sweep = [(f'B{B} T{T} S{2 * L + 1}', *seeded_inputs(B, T, L))
             for B, T in ((8, 301), (32, 500)) for L in (128, 256, 400, 511)]
    records, faster = {}, []
    for n, (label, a, kw) in enumerate(cases + sweep):
        B, T, C = a[0].shape
        L = a[1].shape[1]
        route = align.viterbi_route(L, C)
        spill_words = align._library().ctc_viterbi_warp_spill_words(T, L, C)
        ref_frames, ref_final = ctc_alignment(*a, return_final=True, **kw)
        for other in ('warp', 'block'):
            frames, final = align._alignment_route(*a, route=other, return_final=True, **kw)
            torch.cuda.synchronize()
            assert torch.equal(frames, ref_frames), \
                f'{label}: the {other} kernel\'s char frames differ from the plain version'
            assert torch.equal(final, ref_final), \
                f'{label}: the {other} kernel\'s final alpha differs from the plain version'
        err = float((final - ref_final).abs().max())
        # by CUDA events, and queued (the card's own time, without the
        # wrappers' host work, which the warp kernel's short launches can
        # outlast; the events' time where the spin ended too soon)
        turns = {r: [] for r in ('block', 'warp')}
        queued = {r: [] for r in ('block', 'warp')}
        for r in ('block', 'warp', 'warp', 'block'):
            turns[r].append(cuda_ms(lambda: align._alignment_route(*a, route=r, **kw), reps=20))
            own = queued_ms(lambda: align._alignment_route(*a, route=r, **kw), reps=20)
            queued[r].append(turns[r][-1] if own is None else own)
        warp_ms, block_ms = min(turns['warp']), min(turns['block'])
        warp_own, block_own = min(queued['warp']), min(queued['block'])
        bound, bound_by = viterbi_bound_ms(a[0], a[1], a[2])
        text = (f'ctc_viterbi [{label}] B={B} T={T} C={C} S={2 * L + 1}: both kernels bit-equal; '
                f'warp {warp_ms:.4f}-{max(turns["warp"]):.4f} ms (queued {warp_own:.4f}-'
                f'{max(queued["warp"]):.4f}), block pair {block_ms:.4f}-{max(turns["block"]):.4f} '
                f'ms (queued {block_own:.4f}-{max(queued["block"]):.4f}), bound {bound:.5f} ms '
                f'({bound_by}); route: {route}; the warp kernel\'s backpointers '
                + (f'spill, {B * spill_words * 4 / 1e6:.2f} MB' if spill_words else
                   'in shared memory')
                + f' (the block pair\'s int8: {B * T * (2 * L + 1) / 1e6:.2f} MB)')
        if n < len(cases):
            plain_ms = cuda_ms(lambda: ctc_alignment(*a, **kw), reps=2)
            split = kernel_split_ms(lambda: align._alignment_route(*a, route='block', **kw),
                                    ('viterbi_forward', 'viterbi_backtrace'))
            text += (f'; plain {plain_ms:.2f} ms; the block pair under torch.profiler: forward '
                     f'{split["viterbi_forward"]:.4f} ms, backtrace '
                     f'{split["viterbi_backtrace"]:.4f} ms')
            records[label] = (warp_ms, block_ms, plain_ms, bound, bound_by, err)
        else:
            faster.append((2 * L + 1, B, T, route, 'warp' if warp_own < block_own else 'block'))
        log(text)
    agree = all(route == won for *_, route, won in faster)
    log(f'ctc_viterbi route: the faster kernel (queued) at (S, B, T) '
        f'{[(S, B, T, won) for S, B, T, _, won in faster]}; the route sends S <= '
        f'{align.WARP_S_MAX} to the warp kernel; route and faster kernel agree: {agree}')
    warp_ms, block_ms, plain_ms, bound, bound_by, err = records['main path']
    kernels = [dict(name=name, route='cuda', source='convasr_tpu_torch/csrc/ctc_viterbi.cu',
                    replaces='convasr_tpu/ops/align_pallas.py:28', launches=launches[name],
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                    bound_by=bound_by, library_ms=None)
               for name, ms in (('ctc_viterbi_align_warp', warp_ms),
                                ('ctc_viterbi_align', block_ms))]

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

    train_kernels, loss_cases = train_phases(device)
    kernels += train_kernels
    kernels += int8_phases(device, ckpt, corpus, audio_seconds, num_segments, cpu_model,
                           bf16_run=dict(wall=wall, decode=decode))
    beam_phases(device, ckpt, corpus, audio_seconds, num_segments)
    kernels += whole_t_phases(loss_cases)

    print(card)
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps(dict(ok=True, device=dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                                               count=torch.cuda.device_count()))))
    return 0


def kernel_split_ms(run, names, reps=10):
    """Card time a call of `run` spends in the kernels whose names contain each
    of `names`, by torch.profiler over `reps` calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    split = {name: sum(e.self_device_time_total for e in prof.key_averages()
                       if name in e.key) / 1e3 / reps for name in names}
    assert all(ms > 0 for ms in split.values()), f'no device time for {names}: {split}'
    return split


def profile_kinds(label, run, classify):
    """Where the card time of `run` goes: after one warm-up call, three calls
    timed as they are, then three under torch.profiler; kernel time summed by
    classify(kernel name), and the card's idle share of each window."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - tic) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - tic) * 1e3
    kernels = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total}
    kinds = {}
    for key, ms in kernels.items():
        kind = classify(key.lower())
        kinds[kind] = kinds.get(kind, 0.0) + ms
    busy = sum(kinds.values())
    if not busy:
        log(f'profile {label}: torch.profiler recorded no kernel time on the card; not measured')
        return
    log(f'profile: 3 {label} in {plain_wall_ms:.1f} ms wall ({wall_ms:.1f} ms under the '
        'profiler); kernel ms '
        + ', '.join(f'{k} {v:.1f} ({v / busy:.1%})'
                    for k, v in sorted(kinds.items(), key=lambda kv: -kv[1]))
        + f'; card idle {max(0.0, 1 - busy / plain_wall_ms):.1%} of the wall without the '
        f'profiler ({max(0.0, 1 - busy / wall_ms):.1%} under it); top kernels: '
        + '; '.join(f'{k[:70]} {v:.1f}' for k, v in sorted(kernels.items(),
                                                           key=lambda kv: -kv[1])[:8]))


def profile_train_step(device, model, batch, loop, optim):
    """profile_kinds of train steps of the trained model on the run's last batch."""
    tx = loop.make_optimizer_with_accum(
        optim.make_optimizer('NovoGrad', optim.noop_lr(1e-2), weight_decay=1e-3),
        max_grad_norm=100.0)
    state = loop.init_train_state(model, tx)
    step = loop.make_train_step(model, tx)
    gen = torch.Generator(device=device).manual_seed(0)

    def classify(name):
        return ('ctc loss kernels' if 'ctc_alpha' in name or 'ctc_beta_grad' in name else
                'batch norm' if any(k in name for k in ('batch_norm', 'batchnorm', 'bn_')) else
                'optimizer (foreach)' if 'foreach' in name or 'multi_tensor' in name else
                'convolutions' if any(k in name for k in ('conv', 'gemm', 'xmma', 'cutlass',
                                                          'cudnn', 'implicit', 'sm90')) else
                'other')
    profile_kinds(f'steps of {tuple(batch["x"].shape)}', lambda: step(state, batch, gen),
                  classify)


def train_phases(device):
    """Phases 5-7; returns the JSON records of the two CTC loss kernels and
    phase 6's cases (label, [log_probs, targets, xlen, ylen, blank, g])."""
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
    ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    train_cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                    ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
                    ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES)
    train_cli.make_train_step, ctc_loss.beta_grad_kernel = make_step, beta_grad
    peak = torch.cuda.max_memory_allocated()

    model = seen['model']
    params = list(model.parameters())
    assert params and all(p.is_cuda for p in params), 'model parameters are not on CUDA'
    assert len(steps) == 8, f'{len(steps)} train steps ran'
    val_batches = 1
    # the backward on the warp kernel (L 128 is inside its rule), the block one never
    assert launches == dict(ctc_loss_alpha=8 + val_batches, ctc_loss_beta_grad_warp=8,
                            ctc_loss_beta_grad=0), f'CTC loss kernel launches {launches}'
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
        assert ctc_loss.beta_grad_warp_fits(y.shape[1], lp.shape[2]), label
        alpha, ll = ctc_loss.alpha_kernel(lp, y, xlen, ylen, blank)
        depth_alpha = {d: ctc_loss._alpha_depth(lp, y, xlen, ylen, blank, d) for d in DEPTHS}
        grad = ctc_loss.beta_grad_kernel(lp, y, xlen, ylen, alpha, ll, g, blank)   # the warp kernel
        block_grad = ctc_loss._beta_grad_route(lp, y, xlen, ylen, alpha, ll, g, blank, 'block')
        ref_alpha, ref_ll = ctc_loss.alpha_plain(lp, y, xlen, ylen, blank)
        ref_grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, ref_alpha, ref_ll, g, blank)
        torch.cuda.synchronize()
        feasible = ref_ll > -5e29
        # the forward at the path's depth and at each depth of the sweep: alpha
        # itself, the feasible set and the feasible rows' ll
        alpha_err = {}
        for d, (a_d, ll_d) in [(ctc_loss.ALPHA_DEPTH, (alpha, ll))] + list(depth_alpha.items()):
            assert torch.equal(ll_d > -5e29, feasible), f'{label} D{d}: feasible rows differ'
            assert torch.allclose(a_d, ref_alpha, rtol=1e-5, atol=1e-3), \
                f'{label} D{d}: alpha differs from the plain version'
            d_err = float(((ll_d - ref_ll).abs() / ref_ll.abs().clamp(min=1))[feasible].max())
            assert d_err < 1e-5, f'{label} D{d}: loss differs from the plain version by {d_err}'
            assert bool((ll_d[xlen == 0] == -1e30).all()), f'{label} D{d}: a row with xlen 0'
            alpha_err[d] = float((a_d - ref_alpha).abs().max())
        loss_err = float(((ll - ref_ll).abs() / ref_ll.abs().clamp(min=1))[feasible].max())
        loss_abs_err = float((ll - ref_ll).abs()[feasible].max())
        grad_err = float((grad - ref_grad).abs().max())
        block_err = float((block_grad - ref_grad).abs().max())
        # gamma in [0, 1], summed per class (by the block kernel with shared-memory atomics)
        for name, got, err in (('warp', grad, grad_err), ('block', block_grad, block_err)):
            assert torch.allclose(got, ref_grad, rtol=1e-3, atol=1e-4), \
                f'{label}: the {name} kernel\'s gradient differs from the plain version by {err}'
        if label == 'train path':
            assert bool(feasible.all()), 'an infeasible row on the train path'
        B, T, C = lp.shape
        L = y.shape[1]
        fwd_ms = cuda_ms(lambda: ctc_loss.alpha_kernel(lp, y, xlen, ylen, blank), reps=20)
        # the ring-depth sweep, in turns: each depth, four rounds
        sweep = {d: [] for d in DEPTHS}
        for _ in range(4):
            for d in DEPTHS:
                sweep[d].append(cuda_ms(lambda: ctc_loss._alpha_depth(lp, y, xlen, ylen, blank,
                                                                      d), reps=20))
        fastest = min(DEPTHS, key=lambda d: statistics.median(sweep[d]))
        log(f'ctc_loss_alpha ring depths [{label}]: '
            + ', '.join(f'D{d} {min(v):.4f}-{max(v):.4f} (median {statistics.median(v):.4f}) ms'
                        for d, v in sweep.items())
            + f'; the path\'s D{ctc_loss.ALPHA_DEPTH} {fwd_ms:.4f} ms; fastest by the median '
            f'D{fastest}; alpha max abs err '
            + ', '.join(f'D{d} {e:.2e}' for d, e in alpha_err.items()))

        def warp():
            return ctc_loss.beta_grad_kernel(lp, y, xlen, ylen, alpha, ll, g, blank)

        def block():
            return ctc_loss._beta_grad_route(lp, y, xlen, ylen, alpha, ll, g, blank, 'block')
        # in turns: the warp kernel, the block kernel, the warp kernel
        bwd_ms, block_ms, bwd_ms2 = (cuda_ms(fn, reps=20) for fn in (warp, block, warp))

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
        log(f'ctc_loss [{label}] B={B} T={T} C={C} L={L}: loss rel err {loss_err:.2e}, alpha '
            f'max abs err {alpha_err[ctc_loss.ALPHA_DEPTH]:.2e}, grad '
            f'max abs err warp {grad_err:.2e}, block {block_err:.2e}; kernels fwd {fwd_ms:.4f} '
            f'ms, bwd warp {bwd_ms:.4f} / {bwd_ms2:.4f} ms, bwd block {block_ms:.4f} ms (warp faster: {max(bwd_ms, bwd_ms2) < block_ms}), pair '
            f'(fwd + warp bwd) {pair_ms:.4f} ms; plain fwd {plain_fwd_ms:.2f} ms, bwd '
            f'{plain_bwd_ms:.2f} ms; F.ctc_loss fwd {lib_fwd_ms:.4f} ms, fwd+bwd '
            f'{lib_pair_ms:.4f} ms (rel err {lib_err:.2e}); bound fwd {bounds["alpha"][0]:.5f} ms '
            f'({bounds["alpha"][1]}), bwd {bounds["beta_grad"][0]:.5f} ms '
            f'({bounds["beta_grad"][1]}); alpha {B * T * (2 * L + 1) * 4 / 1e6:.1f} MB')
        records.append(dict(alpha=(fwd_ms, plain_fwd_ms, *bounds['alpha'], lib_fwd_ms,
                                   loss_abs_err),
                            beta_grad_warp=(bwd_ms, plain_bwd_ms, *bounds['beta_grad'],
                                            lib_pair_ms, grad_err),
                            beta_grad=(block_ms, plain_bwd_ms, *bounds['beta_grad'], lib_pair_ms,
                                       block_err)))

    # the backward's route: the warp kernel against the block kernel, in
    # turns, at lattices between the train path's and the warp kernel's reach
    # (B32 T500); the route sends to the warp kernel the lattices of at most
    # WARP_S_MAX states, the largest S at which it won in every run
    won = []
    for L in (160, 256, 384, 511):
        lp, y, xlen, ylen, blank, g = seeded(32, 500, L)
        alpha, ll = ctc_loss.alpha_kernel(lp, y, xlen, ylen, blank)
        ref_grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, alpha, ll, g, blank)
        times = dict(warp=[], block=[])
        for route in ('warp', 'block'):
            got = ctc_loss._beta_grad_route(lp, y, xlen, ylen, alpha, ll, g, blank, route)
            assert torch.allclose(got, ref_grad, rtol=1e-3, atol=1e-4), \
                f'the {route} backward at L {L} differs by {float((got - ref_grad).abs().max())}'
        for route in ('warp', 'block', 'warp', 'block'):
            times[route].append(cuda_ms(lambda: ctc_loss._beta_grad_route(
                lp, y, xlen, ylen, alpha, ll, g, blank, route), reps=20))
        S = 2 * L + 1
        if max(times['warp']) < min(times['block']):
            won.append(S)
        log(f'ctc_loss_beta_grad [B32 T500 L{L} S{S}]: warp '
            f'{min(times["warp"]):.4f}-{max(times["warp"]):.4f} ms, block '
            f'{min(times["block"]):.4f}-{max(times["block"]):.4f} ms (warp faster: '
            f'{S in won}); route: {"warp" if ctc_loss.beta_grad_warp_fits(L, 38) else "block"}')
    log(f'ctc_loss_beta_grad: the warp kernel faster at S {won} of 321, 513, 769, 1023; the '
        f'route sends S <= {ctc_loss.WARP_S_MAX} to it')

    # the block kernel's route, through ctc_loss_auto: a lattice past the warp
    # kernel's rule (L 520, S 1041). A check of the route only: the kernels
    # line gives each kernel its launches on the train path above
    lp, y, xlen, ylen, blank, g = seeded(4, 1100, 520)
    assert not ctc_loss.beta_grad_warp_fits(520, lp.shape[2])
    x = lp.detach().clone().requires_grad_()
    ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0
    torch.cuda.synchronize()
    (got,) = torch.autograd.grad(ctc_loss.ctc_loss_auto(x, y, xlen, ylen, blank=blank), x, g)
    torch.cuda.synchronize()
    block_launches = dict(ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                          ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
                          ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES)
    assert block_launches == dict(ctc_loss_alpha=1, ctc_loss_beta_grad_warp=0,
                                  ctc_loss_beta_grad=1), block_launches
    ref_alpha, ref_ll = ctc_loss.alpha_plain(lp, y, xlen, ylen, blank)
    ref_grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, ref_alpha, ref_ll, g, blank)
    assert torch.allclose(got, ref_grad, rtol=1e-3, atol=1e-4), \
        f'the block kernel past the rule differs by {float((got - ref_grad).abs().max())}'
    log(f'ctc_loss_auto past the warp rule (B4 T1100 L520): launches {block_launches}; '
        f'gradient max abs err {float((got - ref_grad).abs().max()):.2e}')

    kernels = []
    for name, key in (('ctc_loss_alpha', 'alpha'), ('ctc_loss_beta_grad_warp', 'beta_grad_warp'),
                      ('ctc_loss_beta_grad', 'beta_grad')):
        ms, plain_ms, bound, bound_by, lib_ms, err = records[0][key]
        line = 36 if key == 'alpha' else 63
        kernels.append(dict(name=name, route='cuda', source='convasr_tpu_torch/csrc/ctc_loss.cu',
                            replaces=f'convasr_tpu/ops/ctc_pallas_v2.py:{line}',
                            launches=launches[name], max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                            library_ms=lib_ms))

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
    return kernels, cases


def int8_bound_ms(ops, nbytes):
    """The least time for `ops` int8 operations on `nbytes` of inputs and
    outputs -> (ms, 'bytes' | 'operations')."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def int8_phases(device, ckpt, corpus, audio_seconds, num_segments, cpu_model, bf16_run):
    """Phases 8-10; returns the JSON records of the three int8 kernel variants."""
    import torch.nn.functional as F
    from convasr_tpu_torch.cli import transcribe
    from convasr_tpu_torch.models import quantized
    from convasr_tpu_torch.ops import align, int8

    # 8. transcribe --quantize int8 --align at full JasperNetBig width
    cache = WORK / 'act_scales.npz'
    cache.unlink(missing_ok=True)
    seen, captured, path_convs, path_gemms = {}, {}, [], []
    setup, conv_kernel, gemm_kernel = transcribe.setup, int8.int8_conv1d, int8.int8_matmul

    def spy_setup(args):
        tic = time.perf_counter()
        out = setup(args)
        seen['model'], seen['setup_s'] = out[2], time.perf_counter() - tic
        forward = seen['forward'] = out[3]
        calibrate = forward.calibrate

        def timed_calibrate(*a, **kw):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            calibrate(*a, **kw)
            torch.cuda.synchronize()
            seen['calibrate_s'] = time.perf_counter() - tic
        forward.calibrate = timed_calibrate
        return out

    calibrate_forward = quantized.calibrate

    def spy_calibrate(*a, **kw):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        out = calibrate_forward(*a, **kw)
        seen['calibrate_forward_s'] = time.perf_counter() - tic
        return out

    def spy_conv(x, w, *a, **kw):
        if len(path_convs) < 32:                               # the first batch's 32 convs
            path_convs.append((x.clone(), w, a, kw))
        if tuple(w.shape) == (25, 640, 768):                   # block 10's convs
            captured.setdefault('conv', (x.clone(), w, a, kw))
        return conv_kernel(x, w, *a, **kw)

    def spy_gemm(a, b, b_packed=None):
        if len(path_gemms) < 12:                               # the first batch's 12 GEMMs
            path_gemms.append((a.clone(), b, b_packed))
        return gemm_kernel(a, b, b_packed=b_packed)

    transcribe.setup, int8.int8_conv1d, int8.int8_matmul = spy_setup, spy_conv, spy_gemm
    quantized.calibrate = spy_calibrate
    out_dir = str(WORK / 'transcribe_int8')
    args = transcribe.build_parser().parse_args(
        ['--checkpoint', ckpt, '-i', corpus, '-o', out_dir, '--device', 'cuda', '--align',
         '--quantize', 'int8', '--calibration-batches', '1', '--calibration-cache', str(cache),
         '--output-json', '--output-csv', '--mono', '--profile-phases'])
    int8.CONV_LAUNCHES = int8.GEMM_WHOLE_K_LAUNCHES = int8.GEMM_K_TILED_LAUNCHES = 0
    int8.CONV_MMA_SYNC_LAUNCHES = int8.CONV_WEIGHT_PACKS = 0
    int8.GEMM_WGMMA_LAUNCHES = int8.GEMM_WEIGHT_PACKS = 0
    align.WARP_LAUNCHES = align.BLOCK_LAUNCHES = 0
    torch.cuda.synchronize()
    tic = time.perf_counter()
    try:
        transcribe.main(args)
        torch.cuda.synchronize()
    finally:
        transcribe.setup, int8.int8_conv1d, int8.int8_matmul = setup, conv_kernel, gemm_kernel
        quantized.calibrate = calibrate_forward
    wall = time.perf_counter() - tic
    launches = dict(int8_conv_wgmma=int8.CONV_LAUNCHES,
                    int8_gemm_wgmma=int8.GEMM_WGMMA_LAUNCHES,
                    ctc_viterbi_align_warp=align.WARP_LAUNCHES)
    block_align_launches = align.BLOCK_LAUNCHES
    mma_sync_launches, packs = int8.CONV_MMA_SYNC_LAUNCHES, int8.CONV_WEIGHT_PACKS
    whole_k_launches, gemm_packs = int8.GEMM_WHOLE_K_LAUNCHES, int8.GEMM_WEIGHT_PACKS
    k_tiled_launches = int8.GEMM_K_TILED_LAUNCHES
    assert all(n > 0 for n in launches.values()), f'a kernel of the path never ran: {launches}'
    batches = launches['ctc_viterbi_align_warp']
    # per batch: 32 convs with taps, all on the wgmma kernel; 12 wgmma GEMMs
    # (block1.res0, the fused residual GEMMs of blocks 2-10, K 512-4096, the
    # one-tap epilogue block, the head); the weights packed once, when the
    # tree went to the card (phase 10 counts the one-tap weights the GEMM rule
    # takes)
    assert launches == dict(int8_conv_wgmma=32 * batches, int8_gemm_wgmma=12 * batches,
                            ctc_viterbi_align_warp=batches), launches
    assert block_align_launches == 0, f'the block alignment pair ran {block_align_launches} times'
    assert mma_sync_launches == 0, f'the mma.sync conv loop ran {mma_sync_launches} times'
    assert whole_k_launches == 0, f'the mma.sync whole-K GEMM ran {whole_k_launches} times'
    assert k_tiled_launches == 0, f'the K-tiled GEMM ran {k_tiled_launches} times'
    assert packs == 32, f'{packs} conv weight packs in the run (32: once per tree)'
    assert len(path_convs) == 32 and all(kw.get('w_packed') is not None
                                         for _, _, _, kw in path_convs)
    assert len(path_gemms) == 12 and all(p is not None for _, _, p in path_gemms)
    outputs = sorted(os.listdir(out_dir))
    assert 'transcripts.csv' in outputs and sum(o.endswith('.json') for o in outputs) == 2, outputs
    segments = [s for o in outputs if o.endswith('.json')
                for s in json.load(open(os.path.join(out_dir, o)))]
    assert len(segments) == num_segments and all(
        np.isfinite([s['begin'], s['end'], s['cer']]).all() for s in segments), segments[:2]
    model = seen['model']
    scales = quantized.load_act_scales(str(cache))
    want = {'features'} | {f'block{i}.r{r}' for i, b in enumerate(model._block_plan())
                           for r in range(b['kwargs'].get('repeat', 1))}
    assert set(scales) == want and all(np.isfinite(v) and v > 0 for v in scales.values()), \
        sorted(set(scales) ^ want)
    decode = wall - seen['setup_s'] - seen['calibrate_s']
    log(f'transcribe --quantize int8 --align: {wall:.2f} s wall for {audio_seconds:.0f} s of '
        f'audio = {audio_seconds / wall:.1f} audio-seconds/s; of it setup {seen["setup_s"]:.2f} '
        f's, calibration on 1 batch {seen["calibrate_s"]:.2f} s (its folded float32 forward '
        f'{seen["calibrate_forward_s"]:.2f} s, the rest folding and quantizing the weights on '
        f'the host and putting them on the card), the rest {decode:.2f} s = '
        f'{audio_seconds / decode:.1f} audio-seconds/s (phase 2, bf16: {bf16_run["wall"]:.2f} s '
        f'wall = {audio_seconds / bf16_run["wall"]:.1f} audio-s/s, without setup '
        f'{bf16_run["decode"]:.2f} s = {audio_seconds / bf16_run["decode"]:.1f} audio-s/s); '
        f'launches {launches}, mma.sync conv loop {mma_sync_launches}, mma.sync whole-K GEMM '
        f'{whole_k_launches}, K-tiled GEMM {k_tiled_launches}, weight packs: conv {packs}, GEMM '
        f'{gemm_packs}; {len(scales)} '
        f'activation scales cached; {len(segments)} segments written')

    # where an int8 forward's card time goes, at the path's batch shape
    signal = torch.from_numpy(np.stack([speechlike(np.random.RandomState(20 + k), 6 * SR)
                                        for k in range(8)]).astype(np.float32))

    def classify(name):
        return ('int8 conv (wgmma)' if 'int8_conv_wgmma' in name else
                'int8 conv (mma.sync loop)' if 'int8_conv' in name else
                'int8 GEMM (wgmma)' if 'int8_gemm_wgmma' in name else
                'int8 GEMM whole-K' if 'int8_gemm_whole_k' in name else
                'int8 GEMM K-tiled' if 'int8_gemm_k_tiled' in name else
                'cuDNN/cuBLAS (frontend)' if any(k in name for k in (
                    'conv', 'gemm', 'xmma', 'cutlass', 'cudnn', 'sm90')) else
                'elementwise, reductions and copies')
    profile_kinds(f'int8 forwards of {tuple(signal.shape)}',
                  lambda: seen['forward'](signal, torch.ones(8)), classify)

    # 9. the int8 kernels against their plain versions
    rng = np.random.RandomState(9)

    def seeded(*shape):
        return torch.from_numpy(rng.randint(-127, 128, size=shape).astype(np.int8)).to(device)

    def conv_bound(x, w, T_out, stride):
        B, _, Cin = x.shape
        K, _, Cout = w.shape
        ops = 2 * B * T_out * Cout * K * Cin
        return (ops, *int8_bound_ms(ops, x.numel() + w.numel() + 4 * B * T_out * Cout))

    def cudnn_ms(x, w, stride, dilation, reps, timer=cuda_ms):
        """bf16 cuDNN F.conv1d at the conv's shape (a yardstick, not int8)."""
        K = w.shape[0]
        xb = x.transpose(1, 2).to(torch.bfloat16).contiguous()
        wb = w.permute(2, 1, 0).to(torch.bfloat16).contiguous()
        return timer(lambda: F.conv1d(xb, wb, stride=stride, padding=dilation * K // 2,
                                      dilation=dilation), reps=reps)

    def conv_case(label, x, w, stride=1, dilation=1, w_packed=None):
        w_packed = int8.pack_conv_weight(w) if w_packed is None else w_packed
        got = conv_kernel(x, w, stride, dilation, w_packed=w_packed)
        ref = int8.int8_conv1d_plain(x, w, stride, dilation)
        loop = int8._int8_conv1d_mma_sync(x, w, stride, dilation)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), f'int8_conv [{label}]: differs from the plain version'
        assert torch.equal(loop, ref), f'int8_conv mma.sync [{label}]: differs from the plain'
        B, T, Cin = x.shape
        K, _, Cout = w.shape
        reps = 20 if B * T < 10000 else 5
        # the wgmma kernel, the mma.sync loop, the wgmma kernel again
        ms = cuda_ms(lambda: conv_kernel(x, w, stride, dilation, w_packed=w_packed), reps=reps)
        loop_ms = cuda_ms(lambda: int8._int8_conv1d_mma_sync(x, w, stride, dilation),
                          reps=reps)
        ms2 = cuda_ms(lambda: conv_kernel(x, w, stride, dilation, w_packed=w_packed), reps=reps)
        plain_ms = cuda_ms(lambda: int8.int8_conv1d_plain(x, w, stride, dilation), reps=2)
        lib_ms = cudnn_ms(x, w, stride, dilation, reps)
        ops, bound, bound_by = conv_bound(x, w, got.shape[1], stride)
        bn = int8.wgmma_conv_bn(B, got.shape[1], Cout)
        log(f'int8_conv [{label}] B={B} T={T} {Cin}->{Cout} K={K} stride={stride}: bit-equal '
            f'(both kernels); wgmma (BM 128 BN {bn}) {ms:.4f} / {ms2:.4f} ms = '
            f'{ops / ms / 1e9:.1f} TOPS; mma.sync loop {loop_ms:.4f} ms; plain (float64) '
            f'{plain_ms:.2f} ms; bound {bound:.5f} ms ({bound_by}); bf16 cuDNN F.conv1d '
            f'(yardstick, not int8) {lib_ms:.4f} ms')
        assert max(ms, ms2) < loop_ms, \
            f'int8_conv [{label}]: the wgmma kernel is not faster than the mma.sync loop'
        return ms, plain_ms, bound, bound_by, lib_ms, float((got - ref).abs().max())

    def dev(ms):
        return 'not measured' if ms is None else f'{ms:.4f} ms'

    def gemm_case(label, a, b, b_packed=None):
        """The wgmma GEMM, the mma.sync kernel for that depth (whole-K or
        K-tiled, the routes of K % 16 != 0) and torch._int_mm
        (N padded to a multiple of 8) on one input: bit-equal to the float64
        plain version; CUDA events (wgmma, mma.sync, _int_mm, wgmma) and queued."""
        M, K = a.shape
        N = b.shape[1]
        b_packed = int8.pack_gemm_weight(b) if b_packed is None else b_packed
        old_route = 'whole_k' if K <= int8.WHOLE_K_MAX else 'k_tiled'
        fns = dict(wgmma=lambda: int8._int8_matmul_wgmma(a, b_packed),
                   old=lambda: int8._launch_gemm(a, b, None, N, old_route))
        ref = int8.int8_matmul_plain(a, b)
        got = {key: fn() for key, fn in fns.items()}
        b_lib = b if N % 8 == 0 else F.pad(b, (0, 8 - N % 8))
        if M > 16 and K % 8 == 0:
            fns['lib'] = lambda: torch._int_mm(a, b_lib)
            got['lib'] = fns['lib']()[:, :N]
        torch.cuda.synchronize()
        for key, out in got.items():
            assert torch.equal(out, ref), f'int8_matmul {key} [{label}]: differs from the plain'
        reps = 20 if M * N * K < 2 ** 33 else 5
        ms = {key: cuda_ms(fn, reps=reps) for key, fn in fns.items()}
        ms['wgmma2'] = cuda_ms(fns['wgmma'], reps=reps)
        queued = {key: queued_ms(fn, reps=reps) for key, fn in fns.items()}
        plain_ms = cuda_ms(lambda: int8.int8_matmul_plain(a, b), reps=2)
        ops = 2 * M * N * K
        bound, bound_by = int8_bound_ms(ops, a.numel() + b.numel() + 4 * M * N)
        lib = (f'torch._int_mm{"" if b_lib is b else f" (N padded to {b_lib.shape[1]})"} '
               f'{ms["lib"]:.4f} ms (queued {dev(queued["lib"])})' if 'lib' in ms else
               'torch._int_mm refuses the shape (needs M > 16, K % 8 == 0)')
        log(f'int8_matmul [{label}] M={M} K={K} N={N}: bit-equal (all); wgmma (BN '
            f'{int8.wgmma_gemm_bn(M, N)}) {ms["wgmma"]:.4f} / {ms["wgmma2"]:.4f} ms = '
            f'{ops / ms["wgmma"] / 1e9:.1f} TOPS (queued {dev(queued["wgmma"])}); mma.sync '
            f'{old_route} {ms["old"]:.4f} ms (queued {dev(queued["old"])}); {lib}; plain '
            f'(float64) {plain_ms:.2f} ms; bound {bound:.5f} ms ({bound_by})')
        return dict(ms=ms, queued=queued, plain_ms=plain_ms, bound=bound, bound_by=bound_by,
                    err=float((got['wgmma'] - ref).abs().max()),
                    old_err=float((got['old'] - ref).abs().max()))

    # every GEMM of a batch on its captured inputs, by the route
    for a, b, b_packed in path_gemms:
        got = gemm_kernel(a, b, b_packed=b_packed)
        assert torch.equal(got, int8.int8_matmul_plain(a, b)), \
            f'int8_matmul {tuple(a.shape)} x {tuple(b.shape)}: differs from the plain version'
    shapes = {}
    for a, b, b_packed in path_gemms:
        shapes.setdefault(tuple(b.shape), (a, b, b_packed))
    log(f'int8_matmul: the 12 GEMMs of a batch bit-equal to the plain version; '
        f'{len(shapes)} distinct (K, N): {sorted(shapes)}')
    gemms = {(K, N): gemm_case(f'path K{K} N{N}', *shapes[(K, N)]) for K, N in sorted(shapes)}
    for name, deep in (('P1', False), ('P2', True)):
        sums = {key: sum(r['queued'][key] or float('nan') for (K, N), r in gemms.items()
                         if (K > int8.WHOLE_K_MAX) == deep) for key in ('wgmma', 'old')}
        count = sum((K > int8.WHOLE_K_MAX) == deep for K, N in gemms)
        log(f'int8_matmul: the {count} {name} GEMMs of a batch (K {">" if deep else "<="} '
            f'{int8.WHOLE_K_MAX}), queued: wgmma {sums["wgmma"]:.4f} ms, mma.sync '
            f'{"K-tiled" if deep else "whole-K"} {sums["old"]:.4f} ms')
    probe = gemm_case('probe 4096x1792x4096', seeded(4096, 1792), seeded(1792, 4096))
    p2_probe = gemm_case('P2 probe 4096^3', seeded(4096, 4096), seeded(4096, 4096))
    block6, block10 = gemms[(1792, 512)], gemms[(4096, 768)]
    log(f'int8_matmul P2 route (wgmma) against the K-tiled kernel and torch._int_mm: block 10 '
        f'by events {block10["ms"]["wgmma"]:.4f} vs {block10["ms"]["old"]:.4f} and '
        f'{block10["ms"]["lib"]:.4f} ms, queued {dev(block10["queued"]["wgmma"])} vs '
        f'{dev(block10["queued"]["old"])} and {dev(block10["queued"]["lib"])}; 4096^3 by events '
        f'{p2_probe["ms"]["wgmma"]:.4f} vs {p2_probe["ms"]["old"]:.4f} and '
        f'{p2_probe["ms"]["lib"]:.4f} ms, queued {dev(p2_probe["queued"]["wgmma"])} vs '
        f'{dev(p2_probe["queued"]["old"])} and {dev(p2_probe["queued"]["lib"])}')
    log(f'int8_matmul wgmma against torch._int_mm: probe 4096x1792x4096 by events '
        f'{probe["ms"]["wgmma"]:.4f} vs {probe["ms"]["lib"]:.4f} ms (faster: '
        f'{probe["ms"]["wgmma"] < probe["ms"]["lib"]}); block 6 queued '
        f'{dev(block6["queued"]["wgmma"])} vs mma.sync {dev(block6["queued"]["old"])} and '
        f'_int_mm {dev(block6["queued"]["lib"])}')

    # the mma.sync kernels' routes, through int8_matmul_auto: K % 16 != 0, up
    # to WHOLE_K_MAX (whole-K) and past it (K-tiled). A check of the routes
    # only: the kernels line gives each kernel its launches on the int8
    # transcribe path (phase 8)
    for K, N, route in ((1000, 38, 'int8_gemm_whole_k'), (1800, 768, 'int8_gemm_k_tiled')):
        a, b = seeded(2408, K), seeded(K, N)
        int8.GEMM_WGMMA_LAUNCHES = int8.GEMM_WHOLE_K_LAUNCHES = int8.GEMM_K_TILED_LAUNCHES = 0
        got = int8.int8_matmul_auto(a, b)
        torch.cuda.synchronize()
        counted = dict(int8_gemm_wgmma=int8.GEMM_WGMMA_LAUNCHES,
                       int8_gemm_whole_k=int8.GEMM_WHOLE_K_LAUNCHES,
                       int8_gemm_k_tiled=int8.GEMM_K_TILED_LAUNCHES)
        assert counted == {name: int(name == route) for name in counted}, counted
        assert torch.equal(got, int8.int8_matmul_plain(a, b))
        log(f'int8_matmul_auto at K {K} (M 2408, N {N}): launches {counted}, bit-equal')

    x, w, (stride, dilation, _), kw = captured['conv']
    conv_records = [conv_case('path block10 K25 640->768', x, w, stride, dilation,
                              kw['w_packed']),
                    conv_case('probe B256 T304 768->768 K25', seeded(256, 304, 768),
                              seeded(25, 768, 768))]
    records = dict(
        int8_conv_wgmma=(conv_records[0], launches['int8_conv_wgmma'],
                         'int8_conv.cu', 'scripts/int8_conv_probe.py:47'),
        int8_gemm_wgmma=((block6['ms']['wgmma'], block6['plain_ms'], block6['bound'],
                          block6['bound_by'], block6['ms']['lib'], block6['err']),
                         launches['int8_gemm_wgmma'], 'int8_gemm.cu', 'scripts/int8_probe.py:55'),
        int8_gemm_whole_k=((block6['ms']['old'], block6['plain_ms'], block6['bound'],
                            block6['bound_by'], block6['ms']['lib'], block6['old_err']),
                           whole_k_launches, 'int8_gemm.cu', 'scripts/int8_probe.py:55'),
        int8_gemm_k_tiled=((block10['ms']['old'], block10['plain_ms'], block10['bound'],
                            block10['bound_by'], block10['ms']['lib'], block10['old_err']),
                           k_tiled_launches, 'int8_gemm.cu', 'scripts/int8_probe.py:75'))
    kernels = []
    for name, ((ms, plain_ms, bound, bound_by, lib_ms, err), count, source,
               replaces) in records.items():
        kernels.append(dict(name=name, route='cuda', source=f'convasr_tpu_torch/csrc/{source}',
                            replaces=replaces, launches=count, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                            library_ms=lib_ms))

    # each of the 32 path convs of a batch on its captured inputs, the two conv
    # kernels and bf16 cuDNN by CUDA events, and the two kernels' own time
    # with all launches queued ahead (queued_ms: without the wrappers' host work)
    def path_conv_args(a):
        return (list(a) + [1, 1])[:2]

    def loop_call(x, w, a):
        return int8._int8_conv1d_mma_sync(x, w, *path_conv_args(a))

    sums = dict(wgmma=0.0, mma_sync=0.0, cudnn=0.0, bound=0.0, ops=0)
    device_sums = dict(wgmma=0.0, mma_sync=0.0, cudnn=0.0)
    for i, (x, w, a, kw) in enumerate(path_convs):
        stride, dilation = path_conv_args(a)
        ms = cuda_ms(lambda: conv_kernel(x, w, *a, **kw), reps=10)
        loop_ms = cuda_ms(lambda: loop_call(x, w, a), reps=10)
        own = dict(wgmma=queued_ms(lambda: conv_kernel(x, w, *a, **kw), reps=10),
                   mma_sync=queued_ms(lambda: loop_call(x, w, a), reps=10),
                   cudnn=cudnn_ms(x, w, stride, dilation, reps=10, timer=queued_ms))
        for key, v in own.items():
            device_sums[key] = None if v is None or device_sums[key] is None else \
                device_sums[key] + v
        lib_ms = cudnn_ms(x, w, stride, dilation, reps=10)
        T_out = int8.conv_output_length(x.shape[1], w.shape[0], stride, dilation)
        ops, bound, _ = conv_bound(x, w, T_out, stride)
        for key, v in (('wgmma', ms), ('mma_sync', loop_ms), ('cudnn', lib_ms),
                       ('bound', bound), ('ops', ops)):
            sums[key] += v
        log(f'int8_conv path conv {i:2d}: B={x.shape[0]} T={x.shape[1]} {x.shape[2]}->'
            f'{w.shape[2]} K={w.shape[0]} stride={stride}: wgmma {ms:.4f} ms = '
            f'{ops / ms / 1e9:.1f} TOPS (queued {dev(own["wgmma"])}), mma.sync loop '
            f'{loop_ms:.4f} ms (queued {dev(own["mma_sync"])}), bf16 cuDNN {lib_ms:.4f} ms '
            f'(queued {dev(own["cudnn"])}), bound {bound:.5f} ms')
    log(f'int8_conv: the 32 path convs of a batch: wgmma {sums["wgmma"]:.3f} ms '
        f'({sums["ops"] / sums["wgmma"] / 1e9:.1f} TOPS; queued {dev(device_sums["wgmma"])}), '
        f'mma.sync loop {sums["mma_sync"]:.3f} ms (queued {dev(device_sums["mma_sync"])}), '
        f'bf16 cuDNN {sums["cudnn"]:.3f} ms (queued {dev(device_sums["cudnn"])}), '
        f'bound {sums["bound"]:.4f} ms, '
        f'{sums["ops"] / 1e9:.1f} G int8 operations')

    # 10. the int8 forward on the card against the same quantized tree on the CPU
    qtree = quantized.quantize(cpu_model, None, act_scales=scales)
    one_tap = [L['wq'].shape[1] for L in qtree['layers'].values()
               if 'wq' in L and L['wq'].shape[0] == 1]
    fits = sum(map(int8.gemm_wgmma_fits, one_tap))
    assert gemm_packs == fits, f'{gemm_packs} GEMM weight packs in phase 8, {fits} one-tap ' \
        'weights the rule takes (once per tree)'
    log(f'check: phase 8 packed the {fits} of the tree\'s {len(one_tap)} one-tap weights whose '
        f'Cin the wgmma GEMM\'s rule takes, once each')
    card_model = copy.deepcopy(cpu_model).to(device)
    x = torch.from_numpy((0.1 * np.random.RandomState(2).randn(2, SR)).astype(np.float32))
    xlen = torch.tensor([1.0, 0.7])
    on_card = quantized.quantized_apply(card_model, quantized.to_device(qtree, device),
                                        x.to(device), xlen.to(device))['log_probs'][0].cpu()
    on_cpu = quantized.quantized_apply(cpu_model, qtree, x, xlen)['log_probs'][0]
    with torch.inference_mode():
        float32 = cpu_model(x, xlen=xlen)['log_probs'][0]
    assert torch.isfinite(on_card).all() and on_card.shape == (2, 51, 38), on_card.shape
    rel = float((on_card - on_cpu).norm() / on_cpu.norm())
    agree = float((on_card.argmax(-1) == on_cpu.argmax(-1)).float().mean())
    # the int8 products are exact on both; the float32 frontend, instance norm
    # and epilogue sum in another order, and a value within an ulp of a .5
    # requant boundary flips one int8 step, which propagates
    assert rel < 1e-2 and agree >= 0.98, f'int8 card vs CPU: relative L2 {rel}, ids {agree}'
    cos = float((on_card * float32).sum() / (on_card.norm() * float32.norm()))
    f_agree = float((on_card.argmax(-1) == float32.argmax(-1)).float().mean())
    log(f'check: int8 JasperNetBig log-probs card vs CPU on the same tree: relative L2 '
        f'{rel:.2e} (< 1e-2), max |diff| {float((on_card - on_cpu).abs().max()):.2e}, greedy '
        f'ids equal {agree:.4f} (>= 0.98); int8 vs the float32 model (random weights, '
        f'not a gate): cosine {cos:.6f}, greedy ids equal {f_agree:.4f}')
    return kernels


def beam_phases(device, ckpt, corpus, audio_seconds, num_segments):
    """Phases 11-12: transcribe with each beam decoder, and the device beam on
    the card against the CPU."""
    from torch.profiler import ProfilerActivity, profile
    from convasr_tpu_torch.cli import transcribe
    from convasr_tpu_torch.ops import align, beam_device, ctc_loss, ctc_loss_whole_t, int8
    from convasr_tpu_torch.text.ngram_lm import char_tokenize, save_arpa, train_ngram_lm

    # 11. beam transcribe at full JasperNetBig width, LMs trained in the run
    rng = np.random.RandomState(11)
    sentences = [random_words(rng, int(rng.randint(20, 120))) for _ in range(500)]
    char_lm = save_arpa(train_ngram_lm([char_tokenize(t) for t in sentences], order=2),
                        str(WORK / 'char2.arpa'))
    word_lm = save_arpa(train_ngram_lm([t.split() for t in sentences], order=3),
                        str(WORK / 'word3.arpa'))
    runs = [('BeamSearchDecoderDevice', ['--beam-width', '16', '--beam-cutoff-top-n', '8',
                                         '--lm', char_lm]),
            ('BeamSearchDecoderDeviceLM', ['--beam-width', '16', '--lm', word_lm]),
            ('BeamSearchDecoder', ['--beam-width', '64', '--lm', word_lm])]
    setup, search = transcribe.setup, beam_device.beam_search_device
    seen, beam_calls = {}, []

    def spy_setup(args):
        tic = time.perf_counter()
        out = setup(args)
        seen['setup_s'] = time.perf_counter() - tic
        decoder = out[5]
        decode = decoder.decode

        def timed_decode(*a, **kw):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            hyps = decode(*a, **kw)
            torch.cuda.synchronize()
            seen['decode_s'].append(time.perf_counter() - tic)
            return hyps
        decoder.decode = timed_decode
        return out

    def spy_search(log_probs, input_lengths, *a, **kw):
        beam_calls.append((log_probs.is_cuda and input_lengths.is_cuda,
                           log_probs.detach().clone(), input_lengths.clone(), a, dict(kw)))
        return search(log_probs, input_lengths, *a, **kw)

    def counts():
        return dict(ctc_viterbi_align_warp=align.WARP_LAUNCHES,
                    ctc_viterbi_align=align.BLOCK_LAUNCHES,
                    ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                    ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES,
                    ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
                    ctc_loss_whole_t_alpha=ctc_loss_whole_t.ALPHA_LAUNCHES,
                    ctc_loss_whole_t_beta_grad=ctc_loss_whole_t.BETA_GRAD_LAUNCHES,
                    ctc_loss_whole_t_beta_grad_warp=ctc_loss_whole_t.BETA_GRAD_WARP_LAUNCHES,
                    int8_conv_wgmma=int8.CONV_LAUNCHES,
                    int8_conv_mma_sync=int8.CONV_MMA_SYNC_LAUNCHES,
                    int8_gemm_wgmma=int8.GEMM_WGMMA_LAUNCHES,
                    int8_gemm_whole_k=int8.GEMM_WHOLE_K_LAUNCHES,
                    int8_gemm_k_tiled=int8.GEMM_K_TILED_LAUNCHES)

    first_call = None
    transcribe.setup, beam_device.beam_search_device = spy_setup, spy_search
    try:
        for decoder, flags in runs:
            out_dir = str(WORK / f'transcribe_{decoder}')
            args = transcribe.build_parser().parse_args(
                ['--checkpoint', ckpt, '-i', corpus, '-o', out_dir, '--device', 'cuda',
                 '--decoder', decoder, '--output-json', '--mono'] + flags)
            assert args.bf16
            seen['decode_s'], beam_calls[:] = [], []
            align.WARP_LAUNCHES = align.BLOCK_LAUNCHES = 0
            ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = 0
            ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0
            ctc_loss_whole_t.ALPHA_LAUNCHES = ctc_loss_whole_t.BETA_GRAD_LAUNCHES = 0
            ctc_loss_whole_t.BETA_GRAD_WARP_LAUNCHES = 0
            int8.CONV_LAUNCHES = int8.GEMM_WHOLE_K_LAUNCHES = int8.GEMM_K_TILED_LAUNCHES = 0
            int8.CONV_MMA_SYNC_LAUNCHES = int8.GEMM_WGMMA_LAUNCHES = 0
            torch.cuda.synchronize()
            tic = time.perf_counter()
            transcribe.main(args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - tic
            launches = counts()
            outputs = sorted(os.listdir(out_dir))
            segments = [seg for o in outputs if o.endswith('.json')
                        for seg in json.load(open(os.path.join(out_dir, o)))]
            assert len(segments) == num_segments and all(
                np.isfinite(seg['cer']) for seg in segments), segments[:2]
            batches = len(seen['decode_s'])
            assert batches == 2, f'{decoder}: {batches} decoded batches'
            on_card = decoder != 'BeamSearchDecoder'
            assert len(beam_calls) == (batches if on_card else 0), len(beam_calls)
            assert all(cuda for cuda, *_ in beam_calls), 'the device beam ran on host tensors'
            if first_call is None:
                first_call = beam_calls[0][1:]
            decode = wall - seen['setup_s']
            log(f'transcribe --decoder {decoder} {" ".join(flags[:-2])}: {wall:.2f} s wall for '
                f'{audio_seconds:.0f} s of audio = {audio_seconds / wall:.1f} audio-seconds/s; '
                f'setup {seen["setup_s"]:.2f} s, the rest {decode:.2f} s = '
                f'{audio_seconds / decode:.1f} audio-seconds/s; decode s per batch '
                f'{[round(t, 3) for t in seen["decode_s"]]}; device beam on CUDA tensors: '
                f'{on_card} ({len(beam_calls)} calls); mean cer '
                f'{statistics.mean(seg["cer"] for seg in segments):.3f} (random weights); '
                f'launches of the hand kernels {launches} (the path has none)')
    finally:
        transcribe.setup, beam_device.beam_search_device = setup, search

    # 12. the device beam on the card against the same call on the CPU
    lp, lengths, a, kw = first_call
    kw_cpu = dict(kw, lm_table=torch.as_tensor(kw['lm_table']).cpu())
    torch.cuda.synchronize()
    tic = time.perf_counter()
    card = search(lp, lengths, *a, **kw)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - tic
    tic = time.perf_counter()
    cpu = search(lp.cpu(), lengths.cpu(), *a, **kw_cpu)
    cpu_s = time.perf_counter() - tic
    assert torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1]), \
        'device beam tokens or lengths differ between the card and the CPU'
    score_err = float((card[2].cpu() - cpu[2]).abs().max())
    assert score_err < 1e-4, f'device beam scores differ by {score_err}'
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        search(lp, lengths, *a, **kw)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - tic
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_kernels = sum(e.count for e in events)
    B, T, C = lp.shape
    log(f'check: device beam (B={B} T={T} C={C} K={kw["beam_width"]} N='
        f'{kw["cutoff_top_n"]}, char bigram fused) card vs CPU: tokens and lengths bit-equal, '
        f'scores max |diff| {score_err:.2e} (< 1e-4); card {card_s * 1e3:.1f} ms, CPU '
        f'{cpu_s * 1e3:.1f} ms; under torch.profiler {prof_wall * 1e3:.1f} ms wall, '
        f'{n_kernels} kernels = {n_kernels / T:.1f} a frame, card busy {busy_ms:.1f} ms '
        f'({busy_ms / (prof_wall * 1e3):.1%} of the wall)')


def whole_t_phases(cases):
    """Phase 13; returns the JSON records of K2f and of K2b's two kernels."""
    import torch.nn.functional as F
    from convasr_tpu_torch.ops import ctc_loss, ctc_loss_whole_t as k2

    def counts():
        return dict(ctc_loss_whole_t_alpha=k2.ALPHA_LAUNCHES,
                    ctc_loss_whole_t_beta_grad_warp=k2.BETA_GRAD_WARP_LAUNCHES,
                    ctc_loss_whole_t_beta_grad=k2.BETA_GRAD_LAUNCHES)

    def drive(lp, y, xlen, ylen, blank, g):
        x = lp.detach().clone().requires_grad_()
        k2.ALPHA_LAUNCHES = k2.BETA_GRAD_LAUNCHES = k2.BETA_GRAD_WARP_LAUNCHES = 0
        torch.cuda.synchronize()
        loss = k2.ctc_loss_whole_t(x, y, xlen, ylen, blank=blank)
        (loss * g).sum().backward()
        torch.cuda.synchronize()
        return loss.detach(), x.grad, counts()

    # 13. the whole-T loss forward and backward on phase 5's captured batch:
    # K2b on K1b's warp kernel (L 128 is inside its rule)
    lp, y, xlen, ylen, blank, g = cases[0][1]
    loss, grad, train_launches = drive(lp, y, xlen, ylen, blank, g)
    assert train_launches == dict(ctc_loss_whole_t_alpha=1, ctc_loss_whole_t_beta_grad_warp=1,
                                  ctc_loss_whole_t_beta_grad=0), f'K2 launches {train_launches}'
    k1_loss = ctc_loss.ctc_loss_auto(lp, y, xlen, ylen, blank=blank)
    assert torch.isfinite(loss).all() and torch.isfinite(grad).all()
    k1_rel = float(((loss - k1_loss).abs() / k1_loss.abs()).max())
    assert k1_rel < 1e-5, f'K2 and K1 losses differ by {k1_rel} on rows with xlen > 0'
    log(f'ctc_loss_whole_t on the train batch {tuple(lp.shape)}: launches {train_launches}; loss '
        f'relative to K1 {k1_rel:.2e} (same math where xlen > 0)')

    # K2b's other route, the whole-T block kernel, past WARP_S_MAX (S 601),
    # with a row of xlen 0 that takes frame 0 (a finite loss, a zero gradient)
    rng = np.random.RandomState(13)
    B, T, L, C = 8, 300, 300, 38
    lp = torch.log_softmax(torch.from_numpy(rng.randn(B, T, C).astype(np.float32) * 3), -1)
    y = torch.from_numpy(rng.randint(0, C - 1, size=(B, L)).astype(np.int32))
    xlen = torch.from_numpy(rng.randint(T // 2, T + 1, size=B).astype(np.int32))
    ylen = torch.from_numpy(rng.randint(L // 4, L // 2, size=B).astype(np.int32))
    xlen[0], ylen[0] = 0, 1
    g = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32))
    assert k2.beta_grad_route(L, C) == 'block' and 2 * L + 1 > ctc_loss.WARP_S_MAX
    loss, grad, launches = drive(*(t.cuda() for t in (lp, y, xlen, ylen)), C - 1, g.cuda())
    assert launches == dict(ctc_loss_whole_t_alpha=1, ctc_loss_whole_t_beta_grad_warp=0,
                            ctc_loss_whole_t_beta_grad=1), f'K2 launches {launches}'
    x_cpu = lp.clone().requires_grad_()
    ref = k2.ctc_loss_whole_t(x_cpu, y, xlen, ylen, blank=C - 1)
    (ref * g).sum().backward()
    finite = torch.isfinite(ref)
    assert finite[0] and torch.equal(torch.isfinite(loss).cpu(), finite)
    loss_rel = float(((loss.cpu() - ref).abs() / ref.abs().clamp(min=1))[finite].max())
    grad_err = float((grad.cpu() - x_cpu.grad).abs().max())
    assert loss_rel < 1e-5, \
        f'K2 on the block route: loss differs from the plain version by {loss_rel}'
    assert torch.allclose(grad.cpu(), x_cpu.grad, rtol=1e-3, atol=1e-4), \
        f'K2b on the block route: gradient differs from the plain version by {grad_err}'
    assert (grad[0] == 0).all(), 'the row of xlen 0 has a gradient'
    log(f'ctc_loss_whole_t past the warp rule B={B} T={T} C={C} S={2 * L + 1}: launches '
        f'{launches}; loss rel err {loss_rel:.2e}, grad max abs err {grad_err:.2e} against the '
        f'plain version on the CPU; the row of xlen 0 has a finite loss and a zero gradient')

    records = []
    for label, (lp, y, xlen, ylen, blank, g) in cases:
        B, T, C = lp.shape
        L = y.shape[1]
        assert k2.smem_fits(T, L, C), f'{label}: T={T} does not fit the whole-T kernels'
        route = k2.beta_grad_route(L, C)
        alpha, ll = k2.alpha_kernel(lp, y, xlen, ylen, blank)
        ref_alpha, ref_ll = k2.alpha_whole_t_plain(lp, y, xlen, ylen, blank)
        ref_grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, ref_alpha, ref_ll, g, blank)
        feasible = ref_ll > -5e29
        assert torch.equal(ll > -5e29, feasible), f'{label}: feasible rows differ'
        loss_err = float(((ll - ref_ll).abs() / ref_ll.abs().clamp(min=1))[feasible].max())
        loss_abs_err = float((ll - ref_ll).abs()[feasible].max())
        assert loss_err < 1e-5, f'{label}: K2f loss differs from the plain version by {loss_err}'
        grad_errs = {}
        for r in ('warp', 'block'):
            grad = k2._beta_grad_route(lp, y, xlen, ylen, alpha, ll, g, blank, r)
            torch.cuda.synchronize()
            grad_errs[r] = float((grad - ref_grad).abs().max())
            # gamma in [0, 1], summed per class (the block kernel with atomics)
            assert torch.allclose(grad, ref_grad, rtol=1e-3, atol=1e-4), \
                f'{label}: K2b ({r}) gradient differs from the plain version by {grad_errs[r]}'
        fwd_ms = cuda_ms(lambda: k2.alpha_kernel(lp, y, xlen, ylen, blank), reps=20)
        turns = {r: [] for r in ('block', 'warp')}
        for r in ('block', 'warp', 'warp', 'block'):
            turns[r].append(cuda_ms(lambda: k2._beta_grad_route(lp, y, xlen, ylen, alpha, ll, g,
                                                                blank, r), reps=20))
        bwd_ms = {r: min(v) for r, v in turns.items()}
        k1_alpha, k1_ll = ctc_loss.alpha_kernel(lp, y, xlen, ylen, blank)
        k1_fwd_ms = cuda_ms(lambda: ctc_loss.alpha_kernel(lp, y, xlen, ylen, blank), reps=20)
        k1_bwd_ms = cuda_ms(lambda: ctc_loss.beta_grad_kernel(lp, y, xlen, ylen, k1_alpha, k1_ll,
                                                              g, blank), reps=20)
        plain_fwd_ms = cuda_ms(lambda: k2.alpha_whole_t_plain(lp, y, xlen, ylen, blank), reps=2)
        plain_bwd_ms = cuda_ms(lambda: ctc_loss.beta_grad_plain(
            lp, y, xlen, ylen, ref_alpha, ref_ll, g, blank), reps=2)
        lp_tbc = lp.transpose(0, 1).contiguous()
        lib_fwd_ms = cuda_ms(lambda: F.ctc_loss(lp_tbc, y.long(), xlen.long(), ylen.long(),
                                                blank=blank, reduction='none'), reps=20)
        leaf = lp_tbc.detach().requires_grad_()

        def lib_pair():
            out = F.ctc_loss(leaf, y.long(), xlen.long(), ylen.long(), blank=blank,
                             reduction='none')
            torch.autograd.grad(out, leaf, g)
        lib_pair_ms = cuda_ms(lib_pair, reps=20)
        bounds = ctc_loss_bound_ms(xlen, B, T, C, L)
        log(f'ctc_loss_whole_t [{label}] B={B} T={T} C={C} L={L}: loss rel err {loss_err:.2e}, '
            f'grad max abs err warp {grad_errs["warp"]:.2e}, block {grad_errs["block"]:.2e}; '
            f'K2 fwd {fwd_ms:.4f} ms, bwd on K1b\'s warp kernel {bwd_ms["warp"]:.4f}-'
            f'{max(turns["warp"]):.4f} ms, on the whole-T block kernel {bwd_ms["block"]:.4f}-'
            f'{max(turns["block"]):.4f} ms (route: {route}); K1 fwd {k1_fwd_ms:.4f} ms, bwd '
            f'{k1_bwd_ms:.4f} ms; plain fwd {plain_fwd_ms:.2f} ms, bwd {plain_bwd_ms:.2f} ms; '
            f'F.ctc_loss fwd {lib_fwd_ms:.4f} ms, fwd+bwd {lib_pair_ms:.4f} ms; bound fwd '
            f'{bounds["alpha"][0]:.5f} ms ({bounds["alpha"][1]}), bwd '
            f'{bounds["beta_grad"][0]:.5f} ms ({bounds["beta_grad"][1]}); shared memory a block '
            f'{k2.smem_bytes(T, L, C) / 1024:.1f} KiB')
        records.append(dict(
            alpha=(fwd_ms, plain_fwd_ms, *bounds['alpha'], lib_fwd_ms, loss_abs_err),
            **{f'beta_grad_{r}': (bwd_ms[r], plain_bwd_ms, *bounds['beta_grad'], lib_pair_ms,
                                  grad_errs[r]) for r in ('warp', 'block')}))

    kernels = []
    for name, key, source, line in (
            ('ctc_loss_whole_t_alpha', 'alpha', 'ctc_loss_whole_t.cu', 60),
            ('ctc_loss_whole_t_beta_grad_warp', 'beta_grad_warp', 'ctc_loss.cu', 83),
            ('ctc_loss_whole_t_beta_grad', 'beta_grad_block', 'ctc_loss_whole_t.cu', 83)):
        ms, plain_ms, bound, bound_by, lib_ms, err = records[0][key]
        kernels.append(dict(name=name, route='cuda', source=f'convasr_tpu_torch/csrc/{source}',
                            replaces=f'convasr_tpu/ops/ctc_pallas.py:{line}',
                            launches=train_launches[name], max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                            library_ms=lib_ms))
    return kernels


if __name__ == '__main__':
    sys.exit(main())
