"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. build: compiles every kernel in convasr_tpu_torch/csrc/ (one nvcc each,
   all at once) into build/kernels/;
2. transcribe: the port's `cli/transcribe.main` with --align on CUDA, at the
   full width of JasperNetBig (random weights from a seed, 64 log-mel
   features, ru char_legacy head) over synthetic 8 kHz audio with Russian
   reference segments; every kernel's launch count is set to 0 just before
   and read just after, and each kernel must have launched;
3. kernels: each kernel against its plain PyTorch version on the card, on
   the inputs the transcribe run gave it and at two further seeded shapes:
   results bit-equal, times by CUDA events, and the least time the card could
   take (bytes over 3.35 TB/s, operations over the float32 rate);
4. check: the model's log-probs on the card against the same model on the
   CPU on a short input.

Prints the card's name and power limit, one JSON line of kernels, and as the
last line {"ok": true, "device": {...}}. Exits non-zero, printing no result,
when there is no CUDA device or the port is not beside this script; any
failing phase raises.
"""
import copy
import json
import os
import pathlib
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


def synthetic_corpus(num_files=2, segments=8, seconds=6.0, seed=0):
    from convasr_tpu_torch.audio import write_audio
    rng = np.random.RandomState(seed)
    entries, total = [], 0.0
    for f in range(num_files):
        n = int(SR * seconds * segments)
        t = np.arange(n) / SR
        tone = np.sin(2 * np.pi * (300 + 200 * np.sin(2 * np.pi * 0.5 * t)) * t)
        signal = (0.05 * rng.randn(n) + 0.2 * tone * (rng.rand(n // 800 + 1).repeat(800)[:n] > 0.3))
        path = str(WORK / f'utt{f}.wav')
        write_audio(path, signal.astype(np.float32)[None], SR)
        total += n / SR
        for k in range(segments):
            words = []
            while len(' '.join(words)) < 75:
                words.append(WORDS[rng.randint(len(WORDS))])
            entries.append(dict(audio_path=path, ref=' '.join(words),
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
        from convasr_tpu_torch.cli import transcribe
        from convasr_tpu_torch.models.zoo import create_model
        from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
        from convasr_tpu_torch.ops import align, build
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
    align.KERNEL_LAUNCHES = 0
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

    print(card)
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps(dict(ok=True, device=dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                                               count=torch.cuda.device_count()))))
    return 0


if __name__ == '__main__':
    sys.exit(main())
