"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. build: compiles every kernel in convasr_tpu_torch/csrc/ (one nvcc each,
   all at once) into build/kernels/, and beside them the host C++ beam
   (native/ctc_beam.cpp, g++) into build/native/ and phase 21's BPE
   vocabulary (`cli/tools bpetrain`, host only);
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
   never, and the fused update's norm, update, stash and restore launches 8
   times each; three more steps under torch.profiler give the step's kernel
   time by kind and the card's idle share;
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
   train path); then NovoGrad's fused update (ops/novograd_update.py) at the
   train cells' two leaf sets (perfbench/configs jasper_big_char and
   jasper_big_bpe): 4 steps from one start against the chain it replaces
   (the first, above the clip's norm, below it, a non-finite loss), each leaf
   of the parameters, the momentum and the EMA within 1e-5 of its largest
   value, the state bit for bit after the non-finite step, the batch norms'
   stash and restore bit for bit; the two kernels queued and by
   torch.profiler beside the chain and the bound (6 float32 sets over 3.35
   TB/s) in the kernels line;
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
   reaches it) driven forward and backward on K2b's three routes with its
   launch counts set to 0 just before and read just after: phase 5's captured
   train batch (K2b on K1b's warp kernel), a seeded batch past the warp rule
   (S 601, the whole-T block kernel) and one past smem_fits (B4 T1600 S 601,
   K1b's block kernel), K2f on K1f's ring kernel on all three; the last two
   against the plain version on the CPU, and the two block kernels timed in
   turns where both reach; K2f's two kernels (the ring, the whole-T
   forward) and K2b's three held against their plain versions on the train
   batch and at phase 6's two seeded shapes, timed in turns beside K1 and
   torch.nn.functional.ctc_loss;
14. the rest of transcribe: the port's `cli/transcribe.main` on CUDA with
   --vad 3 --diarize --align --align-words --output-json --output-html
   --logits --audio-backend native over two seeded 48 s mixtures of two
   voices (turns between silences of 0.5-2 s) and phase 2's reference
   manifest, at full JasperNetBig width: in bf16, then under --quantize int8
   with --logits-topk 8, then int8 with dense logits on the mixtures (one
   calibration cache): the native reader bit-equal to scipy; every segment
   with a speaker and its word alignment, inside its VAD segment; the dumped
   logits finite, (olen, 38) a segment, decoding to the hyp; the top-8 dump
   equal to the dense one at its top 8; launches (the warp alignment kernel
   once a batch with references, the int8 kernels as phase 8 counts them);
   wall, audio-seconds/s and --profile-phases of each run;
15. benchmark: the port's `cli/benchmark.main` at full JasperNetBig width,
   the JAX CLI's defaults (-B 64 -T 6, 20 iterations after 3 of warmup): the
   bf16 forward chained and not (with a --profile trace), the same under
   --quantize int8 (one calibration cache), --backward (6 train steps), and
   the two --decoder branches on phase 11's word trigram at smaller batches
   (the host C++ beam at B16 width 64, 4 batches; the device beam at B8 width
   16, 2 batches); RTF, mean, p50 and min of each, launch counts set to 0
   just before each run and read just after (32 wgmma convs and 12 wgmma
   GEMMs a forward under int8; K1f and the warp K1b once a step on
   --backward; none elsewhere); the first int8 forward's 32 convs and 12
   GEMMs (B64 T601) bit-equal to their plain versions, the first --backward
   step's K1f loss and K1b gradient against theirs; one TSV for all runs;
16. train with the rest of its flags: the port's `cli/train.main` on phase
   5's corpus at full JasperNetBig width, 6 steps of 32 rows and one
   validation, with --spec-augment --remat --adapt-bn --exphtml --logits,
   then the same without --remat on the same batches (peak memory and median
   step time of each), and --dump-model-config (prints the architecture and
   exits); the CTC kernels' launches (6 K1b, 7 K1f with the val batch); one
   float32 step with remat against one without on the card, the same
   generator seed: loss within 1e-5, gradients within rtol 1e-5, atol 1e-6;
17. serve: the port's gRPC server (`serve/grpc_google_api.start`) on
   127.0.0.1 at a free port, at full JasperNetBig width on phase 2's
   checkpoint, in bf16 and then --quantize int8 (calibrated on phase 2's
   corpus), with --batch-window-ms 5, --streaming-slots 4 and --warmup-sec 6,
   through real gRPC channels: 20 Recognize requests of 6 s LINEAR16 at B1
   (the batcher set aside), one MULAW and one 16 kHz stereo (resampled), each
   transcript equal to its padded array put through forward.fused_i16
   directly; 8 concurrent requests twice through the batcher, each row's ids
   equal to its B1 forward's where the top-2 log-prob gap exceeds 1e-3;
   8 streams of the first 12 s of phase 14's two mixtures at 0.32 s chunks, 4 on the
   batched engine and 4 past its slots per stream; the fused tick's uint8
   ids against the argmax of the legacy tick's full-window log-probs, the
   tick's wall and card time at N4; under int8 every conv and GEMM of one
   served B1 forward and one N4 tick bit-equal to its plain version, and
   the int8 launches per served forward (added to the kernels line); then
   --decoder BeamSearchDecoder (the host beam for Recognize, beam finals
   from the engine's packed u8 top-k tail, carried device-beam interims,
   the mu-law transport) on two streams in real time; and
   `cli/benchmark_online` for 5 s at --rps 5 and with 16 batched streams;
18. export: the port's `cli/export.main` on the checkpoint of phase 2 at
   B8 x 6 s: the bf16 program with --validate, held against the eager
   forward on speech-like input (rtol 1e-1 / atol 1e-2) and timed beside it
   in turns; the int8 program on phase 8's activation scales with
   --validate, whose forward must launch the wgmma conv 32 times and the
   wgmma GEMM 12 times, as the live int8 forward on the same tree does, pack
   nothing, hold each conv and GEMM bit-equal to its plain version and give
   the live forward's argmax ids (timed beside it in turns); the host time
   of a registered op's call against the wrapper it calls; an int8 program
   traced on the CPU and loaded on the card (the same launches); then
   `cli/benchmark --stablehlo` on the bf16 program and
   `cli/benchmark_online --onnx` on the int8 one (its launches counted; all
   of the phase's int8 launches are added to the kernels line), and
   `cli/train --onnx --onnx-validate` on phase 2's checkpoint;
19. the device cache, several processes, the learned frontends, at full
   JasperNetBig width from phase 2's checkpoint on phase 5's corpus:
   `cli/train --device-cache` (replicated), with `--steps-per-dispatch 2`,
   against streaming, 6 float32 steps each in turns under cuDNN's
   deterministic algorithms (per-step losses within rtol 1e-5 / atol 1e-6,
   the streaming runs' own spread printed; the cache's
   bytes, build and upload seconds, the median steps); `--num-processes 2`
   with both ranks on cuda:0 over Gloo (one spawn of two processes, joined
   within 900 s), 3 float32 steps of 2 x 16 rows streaming and then with
   the sharded cache in the same processes, against one process (rtol 1e-4; dropout and dither off, which
   each rank draws for itself); NCCL at world 1 (an all_reduce and an
   allgather_bytes); `cli/transcribe --data-parallel` with --align and with
   the device beam over the one visible card, bit-equal to phases 2 and
   11, then over a device list that names the card three times (batches of
   8 padded to 9, one chunk of 3 a device, the sharded device beam): the
   first forward and beam bit-equal to their chunks run one by one; the
   forward's log-probs and argmax, the segments and the best beams measured
   against the whole batch's (cuDNN rounds a 3-row batch otherwise than an
   8-row one); the wav2vec frontend from
   a seeded fairseq-layout checkpoint (512 channels): 4 train steps, 2 with
   --freeze-frontend (its weights unchanged), transcribe --align (bf16),
   float32 log-probs card vs CPU within 1e-3, transcribe --quantize int8
   with every captured conv and GEMM bit-equal to its plain version, and
   its forward timed against the log-mel model's at B16 x 6 s in turns; the
   neural VAD trained on the card by its CLI (300 steps), beating the energy
   VAD's frame accuracy on seeded mixtures, then `transcribe --vad 3
   --vad-backend neural --diarize` over phase 14's mixtures (each segment
   inside a VAD cut). The first CTC forward and backward of the cached
   train, of each rank and of the wav2vec train, and the first alignment of
   each --data-parallel --align run and of the wav2vec --align run, are
   kept and held against their plain versions (phase 15's tolerances: the
   loss within 1e-5 relative, the gradient per unit of its upstream
   gradient; the char frames bit-equal, as in phase 3). Every CTC,
   alignment and int8 launch of the phase is added to the kernels line.
20. the tensor-parallel layout at full JasperNetBig width from phase 2's
   checkpoint: one process, then two Gloo ranks on cuda:0 as 1 data x 2
   model (every leaf of 256 channels or more sharded over the model group,
   `parallel/tensor_parallel.py`; one spawned process runs the one-process
   runs of 20.1 and 20.3 in turn, one spawn of two the two-rank runs), 3
   float32 steps of NovoGrad
   on the same 16 rows of phase 5's corpus: losses within rtol 1e-4 of one
   process's, the gathered parameters after the steps within rtol 1e-3 /
   atol 1e-5, each rank's parameter bytes half of one process's (0.49-0.51);
   parameter and optimizer bytes, max_memory_allocated and the median step
   of each printed. Then `python -m convasr_tpu_torch.parallel.dryrun
   --ranks 4` on cuda:0 (2 data x 2 model over Gloo), its five lines
   printed. The first K1f and K1b call of each 20.1 process is kept and held
   against the plain versions (phase 15's tolerances); every CTC launch of
   the phase is added to the kernels line. 20.3 (run after phase 21, whose
   vocabulary and dual-head checkpoint it takes): the dual head (char_legacy
   + a 5000-piece BPE head) in one process, then over two Gloo ranks on
   cuda:0 as 1 data x 2 model, each holding 2500 of the BPE head's classes,
   3 float32 steps of the same 16 rows: losses within rtol 1e-4 of one
   process's, the first K1f and K1b call at C 5000 of each process held
   against the plain versions;
21. the BPE head at full JasperNetBig width: a 5000-piece vocabulary trained
   by `cli/tools bpetrain --vocab-size 5000` on seeded Russian text (the
   count it reached printed; at least 1024), then `cli/train` with
   `--text-pipelines char_legacy bpe` (the dual head, 269.2 M parameters,
   bpe_conv1 (5000, 1024, 15)) for 4 steps of 32 rows of phase 5's corpus
   and a validation batch, and `--bpe-only --model JasperNetBigBpeOnly` for
   3 (its fresh weights drawn as the JAX CLI draws them, the draw's time
   printed): both heads' losses on K1f, both backwards on K1b's warp kernel
   (the BPE head's staging the lattice's L+1 classes a frame, not C-wide
   rows), each run's first BPE-head call held against the
   plain versions (loss within 1e-5 relative, gradient per unit of g rtol
   1e-3 / atol 1e-4 shrunk by 38 / C, each row's relative L2 within 1e-5:
   ops/ctc_loss.grad_agreement); `cli/transcribe` on phase 2's corpus with
   `--pipeline bpe`, `--pipeline char_legacy`, `--pipeline bpe --align`
   (K3 at C 5000 on the warp kernel, staging the lattice's L+1 classes a
   frame, the block pair never; bit-equal) and `--pipeline bpe
   --quantize int8` (34 wgmma convs a batch, bpe_conv1's Cout 5000 in a
   ragged last tile, and 12 wgmma GEMMs, the first batch's all bit-equal to
   float64); the dual head's float32 log-probs card vs CPU within 1e-3;
   then K1f and K1b at C 5000 (the train path's batch and B32 T446 L40; the
   warp kernel beside K1b's block kernel, every launch queued, each bound for
   whole rows and for the gathered lattice), K3 (the warp kernel and the
   block pair in turns, char frames and final alpha bit-equal, beside the
   gathered lattice's bound and whole rows') and the BPE head's convs and the forward's deepest and head GEMMs timed
   beside their plain versions, bounds and library calls (F.ctc_loss, bf16
   cuDNN, torch._int_mm). Every launch of the phase is added to the kernels
   line.

Each phase prints its wall time, and a line before the kernels line lists
them all beside the total. Prints the card's name and power limit, one
JSON line of kernels, and as the last line {"ok": true, "device": {...}}.
Exits non-zero, printing no result, when there is no CUDA device or the port
is not beside this script; any failing phase raises.
"""
import collections
import concurrent.futures
import contextlib
import copy
import gc
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
STREAM_SECONDS = 12            # phase 17: the mixtures' first seconds a stream carries
ONLINE_SECONDS = 5             # phase 17: cli/benchmark_online's --benchmark-duration
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


def viterbi_gathered_bound_ms(targets, xlen, ylen, blank, T, C):
    """viterbi_bound_ms where the kernel reads only the lattice's classes: a
    valid frame's 32-byte sectors that hold its blank and its row's ylen
    labels, read once (what this run's data needs). Returns (ms, 'bytes' |
    'operations')."""
    B, L = targets.shape
    S = 2 * L + 1
    sectors = 0
    for b in range(B):
        cols = torch.cat([torch.tensor([blank]), targets[b, :int(ylen[b])].long().cpu()])
        t = torch.arange(int(min(int(xlen[b]), T)))[:, None]
        idx = ((t * C + cols[None, :]) // 8).sort(dim=1).values
        sectors += int((idx.diff(dim=1) != 0).sum()) + idx.shape[0]
    frames = int(xlen.clamp(0, T).sum())
    nbytes = sectors * 32 + B * L * 4 + 2 * B * 4 + B * L * 4 + B * S * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 6 * frames * S / FP32_OPS_PER_S * 1e3
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


def ctc_loss_gathered_bound_ms(targets, xlen, ylen, blank, B, T, C):
    """ctc_loss_bound_ms where a kernel reads only the lattice's classes: a
    valid frame's 32-byte sectors that hold its blank and its row's ylen
    labels, read once (what this run's data needs); the gradient still
    written whole (beta_grad). Returns the same dict."""
    sectors = 0
    for b in range(B):
        cols = torch.cat([torch.tensor([blank]), targets[b, :int(ylen[b])].long().cpu()])
        t = torch.arange(int(min(int(xlen[b]), T)))[:, None]
        idx = ((t * C + cols[None, :]) // 8).sort(dim=1).values
        sectors += int((idx.diff(dim=1) != 0).sum()) + idx.shape[0]
    frames = int(xlen.clamp(0, T).sum())
    L = targets.shape[1]
    small = B * L * 4 + 3 * B * 4
    nbytes = dict(alpha=sectors * 32 + small + B * 4,
                  beta_grad=sectors * 32 + small + B * 4 + B * T * C * 4)
    t_ops = 12 * frames * (2 * L + 1) / FP32_OPS_PER_S * 1e3
    out = {}
    for name, n in nbytes.items():
        t_bytes = n / HBM_BYTES_PER_S * 1e3
        out[name] = (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')
    return out


def init_drawn(experiment_dir):
    """The train CLI's line on its fresh weights (models/jasper.init_as_flax:
    how many values, on which device, in how long), from its log."""
    with open(pathlib.Path(experiment_dir) / 'log.txt') as f:
        line = next((line for line in f if 'init: ' in line), None)
    assert line is not None, f'{experiment_dir}: no init line in the log'
    return 'fresh weights: ' + line.split('init: ', 1)[1].strip()


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
    started = time.perf_counter()
    log('card:', card, '| torch', torch.__version__, 'cuda', torch.version.cuda)

    # 1. build, and beside it phase 21's vocabulary, which needs no card
    tic = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        native = pool.submit(native_build.build_library, 'ctc_beam.cpp')
        bpe_vocab = pool.submit(bpe_vocabulary)
        names = build.build_all()
        native = native.result()
        build_s = time.perf_counter() - tic
        bpe_vocab = bpe_vocab.result()
    log(f'build: {names} and {native.name} (g++) in {build_s:.2f} s; phase 21\'s bpetrain '
        f'beside it, done {time.perf_counter() - tic:.2f} s after the build began')
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
        spill_words = align.spill_words(T, L, C)
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
            text += f'; plain {plain_ms:.2f} ms; the block pair under torch.profiler: ' + (
                'not measured (the profiler recorded no device time)' if split is None else
                f'forward {split["viterbi_forward"]:.4f} ms, backtrace '
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

    walls = {'1-4': time.perf_counter() - started}
    log(f'phases 1-4 wall: {walls["1-4"]:.1f} s')

    def timed(phases, fn, *a, **kw):
        tic = time.perf_counter()
        out = fn(*a, **kw)
        walls[phases] = time.perf_counter() - tic
        log(f'phase{"s" if "-" in phases else ""} {phases} wall: {walls[phases]:.1f} s')
        return out

    train_kernels, loss_cases = timed('5-7', train_phases, device)
    kernels += train_kernels
    kernels += timed('8-10', int8_phases, device, ckpt, corpus, audio_seconds, num_segments,
                     cpu_model, bf16_run=dict(wall=wall, decode=decode))
    timed('11-12', beam_phases, device, ckpt, corpus, audio_seconds, num_segments)
    kernels += timed('13', whole_t_phases, loss_cases)
    timed('14', product_phases, ckpt, corpus, audio_seconds, card,
          bf16_run=dict(wall=wall, decode=decode))
    timed('15', benchmark_phases, device, card)
    timed('16', train_flags_phase, device, card)
    # launches on the phases that follow, by kernel name
    later = [timed('17', serve_phases, ckpt, corpus, card),
             timed('18', export_phases, device, ckpt, card),
             timed('19', multi_phases, device, ckpt, corpus, card)]
    # phase 21 before 20: 20.3 takes 21's vocabulary and dual-head checkpoint
    bpe_launches, bpe = timed('21', bpe_phases, device, card, bpe_vocab)
    later += [bpe_launches, timed('20', tp_phases, device, ckpt, card, bpe)]
    for record in kernels:
        record['launches'] += sum(launches.get(record['name'], 0) for launches in later)
    log(f'phase walls (s): ' + ', '.join(f'{k} {v:.1f}' for k, v in walls.items()))
    log(f'chip_smoke wall: {time.perf_counter() - started:.1f} s; kernel splits by '
        f'torch.profiler not measured (no device time recorded): {SPLITS["unmeasured"]} of '
        f'{SPLITS["asked"]}')

    print(card)
    print(json.dumps(dict(kernels=kernels)))
    print(json.dumps(dict(ok=True, device=dict(platform='gpu', kind=torch.cuda.get_device_name(0),
                                               count=torch.cuda.device_count()))))
    return 0


# kernel_split_ms calls, and those of them the profiler gave no device time
# (the script's last summary line reports both)
SPLITS = dict(asked=0, unmeasured=0)


def kernel_split_ms(run, names, reps=10, per_launch=False):
    """Card time a call of `run` spends in the kernels whose names contain each
    of `names`, by torch.profiler over `reps` calls after one warm-up call;
    per_launch: the mean of a launch the profiler recorded instead (it can
    miss the first calls' kernels, which a sum over `reps` reads as less
    time); None where the profiler recorded no device time for one of them
    (CUPTI does not trace on every machine, as profile_kinds allows too),
    counted in SPLITS."""
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    split = {}
    for name in names:
        events = [e for e in prof.key_averages() if name in e.key]
        n = sum(e.count for e in events) if per_launch else reps
        split[name] = sum(e.self_device_time_total for e in events) / 1e3 / n if n else 0.0
    measured = all(ms > 0 for ms in split.values())
    SPLITS['asked'] += 1
    SPLITS['unmeasured'] += not measured
    return split if measured else None


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
                'optimizer (fused)' if any(k in name for k in ('norm_kernel', 'update_kernel',
                                                               'stash_kernel')) else
                'convolutions' if any(k in name for k in ('conv', 'gemm', 'xmma', 'cutlass',
                                                          'cudnn', 'implicit', 'sm90')) else
                'other')
    profile_kinds(f'steps of {tuple(batch["x"].shape)}', lambda: step(state, batch, gen),
                  classify)


FUSED_CONFIGS = ('jasper_big_char', 'jasper_big_bpe')  # perfbench/configs: the train cells
FUSED_RTOL = 1e-5   # per leaf, of its largest value: the sums of squares go in another order


def fused_leaf_sets(name):
    """A configuration's parameter and batch-norm statistic shapes, as the
    train cells build its model (on the meta device: no memory), and its
    optimizer settings."""
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models.jasper import BatchNorm
    from convasr_tpu_torch.models.zoo import create_model
    config = json.loads((ROOT / 'perfbench' / 'configs' / f'{name}.json').read_text())
    fe, arch = config['frontend'], dict(config['architecture'])
    classes = tuple(h['classes'] for h in config['heads'])
    with torch.device('meta'):
        frontend = LogFilterBankFrontend(
            out_channels=fe['num_input_features'], sample_rate=fe['sample_rate'],
            window_size=fe['window_size'], window_stride=fe['window_stride'])
        model = create_model(config['model'], num_input_features=fe['num_input_features'],
                             num_classes=classes, frontend=frontend,
                             decoder_type='bpe' if len(classes) > 1 else None,
                             dropout=arch.pop('dropout'), **arch)
    stats = [t.shape for m in model.modules() if isinstance(m, BatchNorm)
             for t in (m.running_mean, m.running_var)]
    return [p.shape for p in model.parameters()], stats, config['train']


def fused_update_phase(device, launches=None):
    """Phase 6's NovoGrad update (ops/novograd_update.py) at the train cells'
    two leaf sets: the fused update and the chain it replaces
    (train/loop.chain_update) from the same start for 4 steps (the first,
    one above the clip's norm, one below it, one whose loss is not finite),
    each leaf of the parameters, the momentum and the EMA within FUSED_RTOL
    of the chain's after every step, and after the non-finite one the state
    of each bit for bit as before it, grad_norm 0; the batch norms'
    statistics stashed and restored bit for bit; then the kernels timed:
    queued, each by torch.profiler, beside the chain's time and the bound
    (6 float32 sets of the parameters over HBM_BYTES_PER_S). Returns the
    kernels' records, `launches` (by record name) as their launches."""
    from convasr_tpu_torch.ops import novograd_update
    from convasr_tpu_torch.train import loop, optim
    launches = launches or {}
    measured = {}
    for name in FUSED_CONFIGS:
        shapes, stat_shapes, opt = fused_leaf_sets(name)
        tx = loop.make_optimizer_with_accum(
            optim.make_optimizer(opt['optimizer'], optim.noop_lr(opt['lr']),
                                 weight_decay=opt['weight_decay'], betas=tuple(opt['betas']),
                                 eps=opt['eps']),
            max_grad_norm=opt['max_norm'])
        assert tx.fused is not None and opt['max_norm'] > 0, name
        gen = torch.Generator(device=device).manual_seed(7)
        params = [0.05 * torch.randn(s, device=device, generator=gen) for s in shapes]
        chain_params = [p.clone() for p in params]
        state, chain_state = tx.init(params), tx.init(chain_params)
        scratch = novograd_update.Scratch([p.numel() for p in params], device)
        elements = sum(p.numel() for p in params)
        # gradients of deviation sigma have a norm near sigma sqrt(elements)
        sigma = opt['max_norm'] / elements ** 0.5
        worst = dict(params=0.0, momentum=0.0, ema=0.0, grad_norm=0.0, weight_norm=0.0)

        def rel(got, want):
            return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                       for a, b in zip(got, want))

        def bits(params_, state_):
            nv, schedule = tx.fused.parts(state_)
            return [t.clone() for t in [*params_, *nv['momentum'], nv['grads_ema'], nv['step'],
                                        schedule['count']]]

        for k, (what, scale) in enumerate((('first', 0.5), ('clipped', 4.0),
                                           ('unclipped', 0.25), ('nonfinite', 1.0))):
            grads = [scale * sigma * torch.randn(s, device=device, generator=gen)
                     for s in shapes]
            if what == 'nonfinite':      # the gradients of a loss that is not finite
                grads[0].view(-1)[0], grads[-1].view(-1)[-1] = float('nan'), float('inf')
            finite = torch.tensor(what != 'nonfinite', device=device)
            before, chain_before = bits(params, state), bits(chain_params, chain_state)
            grad_norm, weight_norm = tx.fused.step(grads, state, params, finite, scratch)
            chain_state, chain_grad_norm, chain_weight_norm = loop.chain_update(
                tx, grads, chain_state, chain_params, finite)
            torch.cuda.synchronize()
            nv, chain_nv = tx.fused.parts(state)[0], tx.fused.parts(chain_state)[0]
            if what == 'nonfinite':
                assert float(grad_norm) == float(chain_grad_norm) == 0.0, (name, what)
                assert all(torch.equal(a, b) for a, b in zip(bits(params, state), before)), \
                    f'{name}: the fused update changed the state on a non-finite step'
                assert all(torch.equal(a, b) for a, b in zip(bits(chain_params, chain_state),
                                                             chain_before)), name
            else:
                assert float(scratch.clip[1]) == float(what == 'clipped'), (name, what)
            errs = dict(params=rel(params, chain_params),
                        momentum=rel(nv['momentum'], chain_nv['momentum']),
                        ema=rel([nv['grads_ema']], [chain_nv['grads_ema']]),
                        grad_norm=rel([grad_norm], [chain_grad_norm]),
                        weight_norm=rel([weight_norm], [chain_weight_norm]))
            assert int(nv['step']) == int(chain_nv['step']) == min(k + 1, 3), (name, what)
            assert all(e <= FUSED_RTOL for e in errs.values()), (name, what, errs)
            worst = {key: max(worst[key], errs[key]) for key in worst}
        del chain_params, chain_state, chain_nv

        # the batch norms' statistics: stashed, changed as a forward does, put
        # back bit for bit where the flag is false and left where it is true
        stats = [torch.rand(s, device=device, generator=gen) for s in stat_shapes]
        kept = [t.clone() for t in stats]
        flat = novograd_update.stash(stats)
        torch._foreach_mul_(stats, 0.9)
        moved = [t.clone() for t in stats]
        novograd_update.restore(stats, flat, torch.tensor(True, device=device))
        assert all(torch.equal(a, b) for a, b in zip(stats, moved)), name
        novograd_update.restore(stats, flat, torch.tensor(False, device=device))
        assert all(torch.equal(a, b) for a, b in zip(stats, kept)), name

        # the times: the fused update queued and by kernel, the chain's wall and
        # kernels, from the state the steps left
        finite = torch.tensor(True, device=device)
        grads = [sigma * torch.randn(s, device=device, generator=gen) for s in shapes]

        def fused():
            tx.fused.step(grads, state, params, finite, scratch)

        def bn():
            novograd_update.stash(stats, flat)
            novograd_update.restore(stats, flat, finite)

        tic = time.perf_counter()
        for _ in range(10):
            fused()
        host_ms = (time.perf_counter() - tic) * 1e2
        torch.cuda.synchronize()
        chain = dict(state=state)

        def plain():
            chain['state'] = loop.chain_update(tx, grads, chain['state'], params, finite)[0]

        # one launch of each kernel a call
        split = kernel_split_ms(fused, ('norm_kernel', 'update_kernel'), per_launch=True) or {}
        stash_split = kernel_split_ms(bn, ('stash_kernel',), per_launch=True)
        sets = dict(norm=1, update=5)      # the gradient read; g, p, m read and p, m written
        measured[name] = dict(
            leaves=len(params), elements=elements, stats=len(stats), worst=worst,
            queued=queued_ms(fused, 20), host=host_ms,
            norm=split.get('norm_kernel'), update=split.get('update_kernel'),
            bound={k: v * 4 * elements / HBM_BYTES_PER_S * 1e3 for k, v in sets.items()},
            stash_queued=queued_ms(bn, 20),
            stash=2 * stash_split['stash_kernel'] if stash_split else None,  # 2 launches a call
            # the stash reads and writes each statistic; the restore of a finite
            # step returns at once
            stash_bound=2 * 4 * sum(t.numel() for t in stats) / HBM_BYTES_PER_S * 1e3,
            plain=cuda_ms(plain, 3),
            plain_kernels=(kernel_split_ms(plain, ('',), reps=3) or {}).get(''))
        m = measured[name]
        log(f'novograd_update [{name}] {m["leaves"]} leaves, {elements / 1e6:.1f} M elements, '
            f'{m["stats"]} statistics: 4 steps (first, clipped, unclipped, non-finite) against '
            f'the chain, worst of a leaf {worst} (<= {FUSED_RTOL}); the non-finite step and '
            f'the stash and restore bit for bit; queued {m["queued"]:.3f} ms (norm '
            f'{m["norm"]} + update {m["update"]} by torch.profiler) against a bound of '
            f'{sum(m["bound"].values()):.3f} ms; host {host_ms:.3f} ms a call; the chain '
            f'{m["plain"]:.2f} ms wall, {m["plain_kernels"]} ms of kernels; stash and '
            f'restore queued {m["stash_queued"]} ms, {m["stash"]} ms by torch.profiler')
        del params, grads, state, chain, stats, flat
        torch.cuda.empty_cache()

    # the records at the char cell's leaves; every leaf set's numbers beside them
    char = measured[FUSED_CONFIGS[0]]
    source = 'convasr_tpu_torch/csrc/novograd_update.cu'
    records = []
    for record, kernel, ms, plain, bound, err in (
            ('novograd_norm', 'norm', char['norm'], char['plain'], char['bound']['norm'],
             char['worst']['ema']),
            ('novograd_update', 'update', char['update'], char['plain'],
             char['bound']['update'], char['worst']['params']),
            ('novograd_stash', 'stash', char['stash'], None, char['stash_bound'], 0.0)):
        records.append(dict(
            name=record, route='cuda', source=source, replaces=None,
            launches=launches.get(record, 0), max_abs_err=None, max_rel_err=err, ms=ms,
            plain_ms=plain,
            bound_ms=bound, bound_by='bytes', library_ms=None,
            queued_ms=char['stash_queued'] if kernel == 'stash' else char['queued'],
            by_config={n: dict((k, v) for k, v in m.items() if k != 'worst')
                       for n, m in measured.items()}))
    return records


def train_phases(device):
    """Phases 5-7; returns the JSON records of the CTC loss kernels and the
    fused update's, and phase 6's cases (label, [log_probs, targets, xlen,
    ylen, blank, g])."""
    import torch.nn.functional as F
    from convasr_tpu_torch.cli import train as train_cli
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.ops import align, ctc_loss, novograd_update
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
    novograd_update.NORM_LAUNCHES = novograd_update.UPDATE_LAUNCHES = 0
    novograd_update.STASH_LAUNCHES = novograd_update.RESTORE_LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    train_cli.main(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = dict(ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                    ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
                    ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES,
                    novograd_norm=novograd_update.NORM_LAUNCHES,
                    novograd_update=novograd_update.UPDATE_LAUNCHES,
                    novograd_stash=novograd_update.STASH_LAUNCHES,
                    novograd_restore=novograd_update.RESTORE_LAUNCHES)
    train_cli.make_train_step, ctc_loss.beta_grad_kernel = make_step, beta_grad
    peak = torch.cuda.max_memory_allocated()

    model = seen['model']
    params = list(model.parameters())
    assert params and all(p.is_cuda for p in params), 'model parameters are not on CUDA'
    assert len(steps) == 8, f'{len(steps)} train steps ran'
    val_batches = 1
    # the backward on the warp kernel (L 128 is inside its rule), the block one never
    # the CLI's NovoGrad behind the clip: every step on the fused update, the
    # batch norms' statistics stashed and the restore launched (a no-op where
    # the loss is finite)
    assert launches == dict(ctc_loss_alpha=8 + val_batches, ctc_loss_beta_grad_warp=8,
                            ctc_loss_beta_grad=0, novograd_norm=8, novograd_update=8,
                            novograd_stash=8, novograd_restore=8), \
        f'CTC loss and update kernel launches {launches}'
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
        f'{ckpt_path.name} loads back; {init_drawn(exp_dir / "jasper_big")}')

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

    # 6. NovoGrad's fused update against the chain at the train cells' leaf sets
    kernels += fused_update_phase(device, dict(
        novograd_norm=launches['novograd_norm'], novograd_update=launches['novograd_update'],
        novograd_stash=launches['novograd_stash'] + launches['novograd_restore']))

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


# two seeded voices for phase 14: f0 and formants (as in
# tests/test_diarization_mono.py)
VOICES = (dict(f0=115.0, formants=((450, 150), (1400, 250))),
          dict(f0=235.0, formants=((900, 200), (2600, 350))))


def voice(rng, n, f0, formants):
    """A harmonic complex with a speaker's formant emphasis and a syllabic
    amplitude modulation."""
    t = np.arange(n) / SR
    sig = np.zeros(n)
    for h in range(1, 25):
        f = f0 * h
        if f > SR / 2 - 100:
            break
        amp = sum(np.exp(-0.5 * ((f - fc) / bw) ** 2) for fc, bw in formants) + 0.05
        sig += amp * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    sig *= 1.0 + 0.3 * np.sin(2 * np.pi * 3.0 * t)
    return 0.3 * sig / np.abs(sig).max()


def two_voice_wav(path, seed, seconds=48.0):
    """Turns of 1.5-4 s of the two voices in seeded order, separated by
    0.5-2 s of silence, over a noise floor."""
    from convasr_tpu_torch.audio import write_audio
    rng = np.random.RandomState(seed)
    pieces, n = [], 0
    while n < seconds * SR:
        gap = np.zeros(int(rng.uniform(0.5, 2.0) * SR))
        turn = voice(rng, int(rng.uniform(1.5, 4.0) * SR), **VOICES[rng.randint(2)])
        pieces += [gap, turn]
        n += len(gap) + len(turn)
    sig = np.concatenate(pieces)[:int(seconds * SR)]
    sig = (sig + 0.005 * rng.randn(len(sig))).astype(np.float32)
    write_audio(path, sig[None], SR)
    return len(sig) / SR


def product_phases(ckpt, corpus, corpus_seconds, card, bf16_run):
    """Phase 14: transcribe with --vad --diarize --align --align-words
    --output-json --output-html --logits --audio-backend native, in bf16 and
    under --quantize int8 (sparse top-k logits, then dense ones on the same
    calibration, to hold the one against the other)."""
    import contextlib
    import io
    from convasr_tpu_torch.audio import read_audio
    from convasr_tpu_torch.cli import transcribe
    from convasr_tpu_torch.data import transcripts
    from convasr_tpu_torch.decode.generators import GreedyCTCGenerator
    from convasr_tpu_torch.infra.utils import sparse_topk_todense
    from convasr_tpu_torch.ops import align, int8
    from convasr_tpu_torch.text import ProcessingPipeline

    # 14. the rest of transcribe: VAD-cut mixtures of two voices, and phase 2's
    # reference manifest (the VAD pipeline writes segments without references,
    # so --align aligns the manifest's batches only)
    vad_dir = WORK / 'vad_in'
    vad_dir.mkdir(parents=True, exist_ok=True)
    mix_seconds = sum(two_voice_wav(str(vad_dir / f'mix{k}.wav'), 140 + k) for k in range(2))
    audio_seconds = mix_seconds + corpus_seconds
    read_s = dict(native=[], scipy=[])
    for k in range(2):
        path = str(vad_dir / f'mix{k}.wav')
        native = read_audio(path, sample_rate=SR, mono=True, backend='native')[0]
        scipy_read = read_audio(path, sample_rate=SR, mono=True, backend='scipy')[0]
        assert native.dtype == np.float32 and np.array_equal(native, scipy_read), \
            f'mix{k}.wav: the native reader differs from scipy'
        for _ in range(5):          # in turns, the library built and the file cached
            for backend in ('native', 'scipy', 'scipy', 'native'):
                tic = time.perf_counter()
                read_audio(path, sample_rate=SR, mono=True, backend=backend)
                read_s[backend].append(time.perf_counter() - tic)
    log(f'check: the native wav reader is bit-equal to scipy on both mixtures '
        f'({mix_seconds:.0f} s); a read of one 48 s file, median of 20 in turns: native '
        f'{1e3 * statistics.median(read_s["native"]):.3f} ms, scipy '
        f'{1e3 * statistics.median(read_s["scipy"]):.3f} ms')
    pipeline = ProcessingPipeline.make(ProcessingPipeline.load_config(
        str(ROOT / 'configs' / 'ru_text_config.json')), 'char_legacy')
    generator = GreedyCTCGenerator(blank_amount_to_space=8)
    flags = ['--vad', '3', '--diarize', '--align', '--align-words', '--output-json',
             '--output-html', '--logits', '--audio-backend', 'native', '--mono',
             '--profile-phases', '--device', 'cuda']
    cache = WORK / 'act_scales_product.npz'
    cache.unlink(missing_ok=True)
    int8_flags = ['--quantize', 'int8', '--calibration-cache', str(cache)]

    conv_kernel, gemm_kernel = int8.int8_conv1d, int8.int8_matmul

    def run(name, inputs, extra, captured=None):
        """One transcribe run; where `captured` is a list, each int8 conv and
        GEMM of the run appends its inputs and its output to it."""
        out_dir = WORK / f'product_{name}'
        calls = []
        kernel = align.ctc_alignment_kernel

        def spy_kernel(*a, **kw):
            calls.append(a[0].shape[0])
            return kernel(*a, **kw)

        def spy_conv(x, w, *a, **kw):
            out = conv_kernel(x, w, *a, **kw)
            captured.append(('conv', x.clone(), w, a, kw, out.clone()))
            return out

        def spy_gemm(a, b, b_packed=None):
            out = gemm_kernel(a, b, b_packed=b_packed)
            captured.append(('gemm', a.clone(), b, (), dict(b_packed=b_packed), out.clone()))
            return out
        args = transcribe.build_parser().parse_args(
            ['--checkpoint', ckpt, '-i', *inputs, '-o', str(out_dir)] + flags + extra)
        align.ctc_alignment_kernel = spy_kernel
        if captured is not None:
            int8.int8_conv1d, int8.int8_matmul = spy_conv, spy_gemm
        align.WARP_LAUNCHES = align.BLOCK_LAUNCHES = 0
        int8.CONV_LAUNCHES = int8.GEMM_WGMMA_LAUNCHES = int8.CONV_MMA_SYNC_LAUNCHES = 0
        int8.GEMM_WHOLE_K_LAUNCHES = int8.GEMM_K_TILED_LAUNCHES = 0
        printed = io.StringIO()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                transcribe.main(args)
            torch.cuda.synchronize()
        finally:
            align.ctc_alignment_kernel = kernel
            int8.int8_conv1d, int8.int8_matmul = conv_kernel, gemm_kernel
        wall = time.perf_counter() - tic
        text = printed.getvalue()
        (WORK / f'product_{name}.log').write_text(text)
        batches = sum(line.startswith('Processing ') for line in text.splitlines())
        launches = dict(ctc_viterbi_align_warp=align.WARP_LAUNCHES,
                        ctc_viterbi_align=align.BLOCK_LAUNCHES,
                        int8_conv_wgmma=int8.CONV_LAUNCHES,
                        int8_gemm_wgmma=int8.GEMM_WGMMA_LAUNCHES,
                        int8_mma_sync=int8.CONV_MMA_SYNC_LAUNCHES + int8.GEMM_WHOLE_K_LAUNCHES
                        + int8.GEMM_K_TILED_LAUNCHES)
        phases = next((line for line in text.splitlines() if line.startswith('PHASES:')), '')
        return out_dir, wall, batches, len(calls), launches, phases

    def check_outputs(out_dir, topk, with_corpus):
        """Segments, speakers, word alignments and logits of one run ->
        {file name: per segment, the hyp its logits decode to, or its top-k
        values in descending order}."""
        files, worst_over = {}, 0.0
        names = [f'mix{k}.wav' for k in range(2)] + (sorted(
            {transcripts.audio_name(t['audio_path']) for t in json.load(open(corpus))})
            if with_corpus else [])
        n_segments, speakers, aligned = 0, set(), 0
        for name in names:
            segments = json.load(open(out_dir / f'{name}.json'))
            assert segments and (out_dir / f'{name}.html').exists(), name
            assert '<audio' in (out_dir / f'{name}.html').read_text(), name
            npz = np.load(out_dir / f'{name}.npz')
            rows = sorted(int(k.split('_')[1]) for k in npz.files if k.startswith('logits_')
                          and k.split('_')[1].isdigit() and (topk or k.count('_') == 1))
            rows = sorted(set(rows))
            olen = [int(npz[f'logits_{k}_shape'][0]) if topk else len(npz[f'logits_{k}'])
                    for k in rows]
            vad = [(t['begin'], t['end']) for t in json.load(open(
                out_dir / 'vad_segments' / f'{name}.json'))] if name.startswith('mix') else None
            if vad is not None:
                # the file is one batch, a row a VAD segment. Stamps lie on
                # the batch's frame grid, ts = duration * t / (n - 1), and a
                # row of d seconds ends at frame ceil(n d / duration) - 1, so
                # its last stamp passes its end by less than d / (n - 1) <=
                # (longest d) / (most frames of a row - 1); d is read in
                # whole samples, so it may pass e - b by one sample
                assert len(olen) == len(vad), (name, len(olen), len(vad))
                slack = max(e - b for b, e in vad) / (max(olen) - 1) + 1 / SR
                worst_over = max(worst_over, slack)
            for t in segments:
                assert isinstance(t['speaker'], int) and isinstance(t['words'], list) and \
                    'words_ref' in t and 'words_hyp' in t, sorted(t)
                speakers.add(t['speaker'])
                if vad is not None and t['hyp']:
                    assert any(b - 1e-6 <= t['begin'] <= t['end'] <= e + slack
                               for b, e in vad), f'{name}: a segment [{t["begin"]}, ' \
                        f'{t["end"]}] outside the VAD segments (+ {slack:.6f} s at the end)'
                if vad is None:
                    assert t['words_ref'] and all(np.isfinite([w['begin'], w['end']]).all()
                                                  for w in t['words_ref']), name
                    aligned += 1
            n_segments += len(segments)
            texts = []
            for k in rows:
                if topk:     # the stored top-k values, densified and taken back
                    values = npz[f'logits_{k}_values']
                    dense = sparse_topk_todense(dict(
                        indices=npz[f'logits_{k}_indices'], values=values, axis=-1,
                        shape=npz[f'logits_{k}_shape'].tolist(), fill_value=0.0,
                        dtype=str(values.dtype)))
                    assert dense.shape == (len(values), 38) and np.isfinite(dense).all()
                    texts.append(-np.sort(-np.take_along_axis(
                        dense, npz[f'logits_{k}_indices'].astype(np.int64), -1), -1))
                    continue
                dense = npz[f'logits_{k}']
                assert dense.ndim == 2 and dense.shape[1] == 38 and np.isfinite(dense).all()
                decoded = generator.generate(
                    tokenizer=pipeline.tokenizer, log_probs=dense[None], begin=[0.0], end=[0.0],
                    output_lengths=[len(dense)], time_stamps=np.zeros((1, len(dense))))[0][0]
                texts.append(transcripts.join(hyp=transcripts.map_text(pipeline.postprocess,
                                                                       hyp=decoded)))
            if not topk:
                assert ' '.join(' '.join(texts).split()) == ' '.join(str(npz['hyp']).split()), \
                    f'{name}: the dumped logits do not decode to the hyp'
            files[name] = texts
        assert n_segments and speakers - {transcripts.speaker_missing}, speakers
        log(f'check [{out_dir.name}]: {n_segments} segments of {len(names)} files with speaker, '
            f'words, words_ref and words_hyp, inside their VAD segments (the end within '
            f'{worst_over:.6f} s, one frame spacing of its batch); speakers '
            f'{sorted(speakers)}; {aligned} segments aligned to their references')
        return files

    results, captured = {}, []
    for name, inputs, extra, topk in (
            ('bf16', [str(vad_dir), corpus], [], 0),
            ('int8_top8', [str(vad_dir), corpus], int8_flags + ['--logits-topk', '8'], 8),
            ('int8_dense', [str(vad_dir)], int8_flags, 0)):
        # the dense int8 run (mixture batches only) keeps every conv's and
        # GEMM's inputs and output (its wall includes those copies)
        out_dir, wall, batches, aligned_batches, launches, phases = run(
            name, inputs, extra, captured if name == 'int8_dense' else None)
        dense_batches = batches
        results[name] = check_outputs(out_dir, topk, corpus in inputs)
        assert launches['ctc_viterbi_align_warp'] == aligned_batches == 2 * (len(inputs) - 1) \
            and launches['ctc_viterbi_align'] == 0, launches
        if '--quantize' in extra:
            # per batch, as phase 8 counts them: 32 wgmma convs, 12 wgmma GEMMs
            assert launches['int8_conv_wgmma'] == 32 * batches and \
                launches['int8_gemm_wgmma'] == 12 * batches and launches['int8_mma_sync'] == 0, \
                (launches, batches)
        seconds = audio_seconds if len(inputs) == 2 else mix_seconds
        log(f'transcribe --vad 3 --diarize --align --align-words --output-html --logits '
            f'--audio-backend native [{name}]: {wall:.2f} s wall for {seconds:.0f} s of audio = '
            f'{seconds / wall:.1f} audio-seconds/s in {batches} batches (phase 2, bf16 --align: '
            f'{bf16_run["wall"]:.2f} s for {corpus_seconds:.0f} s); launches {launches}; '
            f'{phases}; card: {card}')
    # each int8 conv and GEMM of the mixture batches, as the path computed it,
    # bit-equal to its plain version (float64 on the card) on its inputs
    shapes = collections.Counter()
    for kind, x, w, a, kw, out in captured:
        if kind == 'conv':
            ref = int8.int8_conv1d_plain(x, w, *a, **kw)
            K = (kw['w_packed'] if w is None else w).shape[0]
            shape = f'conv B{x.shape[0]} T{x.shape[1]} {x.shape[2]}->{out.shape[2]} K{K}'
        else:
            ref = int8.int8_matmul_plain(x, w, **kw)
            shape = f'GEMM M{x.shape[0]} K{x.shape[1]} N{out.shape[1]}'
        assert torch.equal(out, ref), f'int8 {shape} of a mixture batch differs from the plain'
        shapes[shape] += 1
    convs = sum(kind == 'conv' for kind, *_ in captured)
    assert convs == 32 * dense_batches and len(captured) - convs == 12 * dense_batches, \
        (convs, len(captured), dense_batches)
    log(f'check: the {convs} int8 convs and {len(captured) - convs} GEMMs of the '
        f'{dense_batches} mixture batches, as the path computed them, bit-equal to '
        f'their plain versions; {len(shapes)} shapes: {dict(shapes)}')
    del captured

    # the top-8 dump against the dense dump of the same int8 forward (one
    # calibration cache): the 8 largest logits of each frame, in order
    worst = 0.0
    for name in results['int8_dense']:
        for k, top in enumerate(results['int8_top8'][name]):
            logits = np.load(WORK / 'product_int8_dense' / f'{name}.npz')[f'logits_{k}']
            want = -np.sort(-logits, -1)[:, :8]
            assert top.shape == want.shape, (name, k)
            err = np.abs(top - want) / np.maximum(np.abs(want), 1e-6)
            worst = max(worst, float(err.max()))
    assert worst <= 2 ** -8, f'the top-8 dump differs from the dense one by {worst} (relative)'
    log(f'check: the top-8 logits dump, densified, equals the dense dump of the same int8 '
        f'forward at its top 8 within {worst:.2e} relative (bf16 rounding: {2 ** -8:.2e})')


def benchmark_phases(device, card):
    """Phase 15: the port's benchmark CLI at full JasperNetBig width."""
    import contextlib
    import io
    from convasr_tpu_torch.cli import benchmark
    from convasr_tpu_torch.ops import ctc_loss, int8

    out_dir = WORK / 'benchmark'
    out_dir.mkdir(parents=True, exist_ok=True)
    tsv, trace_dir = out_dir / 'bench.tsv', out_dir / 'profile'
    tsv.unlink(missing_ok=True)
    cache = out_dir / 'act_scales.npz'
    cache.unlink(missing_ok=True)
    word_lm = WORK / 'word3.arpa'            # phase 11's word trigram
    assert word_lm.exists(), word_lm
    common = ['--device', 'cuda', '-o', str(tsv)]
    int8_flags = ['--quantize', 'int8', '--calibration-cache', str(cache)]
    runs = [
        ('bf16 chained', ['-B', '64', '-T', '6']),
        ('bf16', ['-B', '64', '-T', '6', '--chained', 'false']),
        # the trace from a run of its own, so that no timed run pays the
        # profiler
        ('bf16 profile', ['-B', '64', '-T', '6', '--chained', 'false', '--profile',
                          str(trace_dir), '--iterations', '2', '--warmup-iterations', '1']),
        ('int8 chained', ['-B', '64', '-T', '6'] + int8_flags),
        ('int8', ['-B', '64', '-T', '6', '--chained', 'false'] + int8_flags),
        ('backward', ['-B', '64', '-T', '6', '--backward', '--iterations', '5',
                      '--warmup-iterations', '1']),
        # the beams at a smaller batch and few iterations: the device beam
        # takes about a second a batch (PERF.md section 5)
        ('host beam', ['-B', '16', '-T', '6', '--decoder', 'BeamSearchDecoder', '--beam-width',
                       '64', '--lm', str(word_lm), '--iterations', '4',
                       '--warmup-iterations', '1']),
        ('device beam', ['-B', '8', '-T', '6', '--decoder', 'BeamSearchDecoderDeviceLM',
                         '--beam-width', '16', '--lm', str(word_lm), '--iterations', '2',
                         '--warmup-iterations', '1'])]
    conv_kernel, gemm_kernel = int8.int8_conv1d, int8.int8_matmul
    alpha_kernel, beta_grad_kernel = ctc_loss.alpha_kernel, ctc_loss.beta_grad_kernel
    captured, ctc_calls, kinds = [], {}, []

    def spy_conv(x, w, *a, **kw):
        out = conv_kernel(x, w, *a, **kw)
        if len(captured) < 44:               # the first forward: 32 convs, 12 GEMMs
            captured.append(('conv', x.clone(), w, a, kw, out.clone()))
        return out

    def spy_gemm(a, b, b_packed=None):
        out = gemm_kernel(a, b, b_packed=b_packed)
        if len(captured) < 44:
            captured.append(('gemm', a.clone(), b, (), dict(b_packed=b_packed), out.clone()))
        return out

    def spy_alpha(*a):
        out = alpha_kernel(*a)
        if 'alpha' not in ctc_calls:
            ctc_calls['alpha'] = ([t.clone() if torch.is_tensor(t) else t for t in a],
                                  [t.clone() for t in out])
        return out

    def spy_beta_grad(*a):
        out = beta_grad_kernel(*a)
        if 'beta_grad' not in ctc_calls:
            ctc_calls['beta_grad'] = ([t.clone() if torch.is_tensor(t) else t for t in a],
                                      out.clone())
        return out

    for label, flags in runs:
        first_int8 = label == 'int8 chained'
        if first_int8:
            int8.int8_conv1d, int8.int8_matmul = spy_conv, spy_gemm
        ctc_loss.alpha_kernel, ctc_loss.beta_grad_kernel = spy_alpha, spy_beta_grad
        args = benchmark.build_parser().parse_args(common + flags)
        int8.CONV_LAUNCHES = int8.GEMM_WGMMA_LAUNCHES = int8.CONV_MMA_SYNC_LAUNCHES = 0
        int8.GEMM_WHOLE_K_LAUNCHES = int8.GEMM_K_TILED_LAUNCHES = 0
        ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0
        ctc_loss.BETA_GRAD_LAUNCHES = 0
        printed = io.StringIO()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        try:
            with contextlib.redirect_stdout(printed):
                result = benchmark.main(args)
            torch.cuda.synchronize()
        finally:
            int8.int8_conv1d, int8.int8_matmul = conv_kernel, gemm_kernel
            ctc_loss.alpha_kernel, ctc_loss.beta_grad_kernel = alpha_kernel, beta_grad_kernel
        wall = time.perf_counter() - tic
        launches = dict(int8_conv_wgmma=int8.CONV_LAUNCHES, int8_gemm_wgmma=int8.GEMM_WGMMA_LAUNCHES,
                        int8_mma_sync=int8.CONV_MMA_SYNC_LAUNCHES + int8.GEMM_WHOLE_K_LAUNCHES
                        + int8.GEMM_K_TILED_LAUNCHES, ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                        ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
                        ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES)
        text = printed.getvalue()
        (out_dir / f'{label.replace(" ", "_")}.log').write_text(text)
        lines = [line for line in text.splitlines()
                 if line.startswith(('batch ', f'{result["kind"]}:', 'RTF:', 'host '))]
        times = result['times']
        assert np.isfinite(times).all() and result['rtf'] > 0, (label, result)
        forwards = args.warmup_iterations + args.iterations
        if '--quantize' in flags:
            assert launches['int8_conv_wgmma'] == 32 * forwards and \
                launches['int8_gemm_wgmma'] == 12 * forwards and launches['int8_mma_sync'] == 0, \
                (label, launches)
        elif args.backward:
            steps = args.warmup_iterations + args.iterations
            # L 64 (S 129) is inside the warp backward's rule
            assert (launches['ctc_loss_alpha'], launches['ctc_loss_beta_grad_warp'],
                    launches['ctc_loss_beta_grad']) == (steps, steps, 0), launches
            assert np.isfinite(float(result['first'])), result['first']
        else:
            assert not any(launches.values()), (label, launches)
        if args.decoder:
            assert len(result['first']) == args.B and all(
                isinstance(t, list) for t in result['first']), result['first']
        else:
            first = result['first']
            assert first is None or bool(torch.isfinite(first).all()), label
        kinds.append(result['kind'])
        log(f'benchmark [{label}] {" ".join(flags)}: {" | ".join(lines)}; RTF {result["rtf"]:.1f}, '
            f'mean {times.mean() * 1e3:.2f} ms, p50 {np.percentile(times, 50) * 1e3:.2f} ms, '
            f'min {times.min() * 1e3:.2f} ms a batch; wall {wall:.1f} s; hand-kernel launches '
            f'{ {k: v for k, v in launches.items() if v} }; card: {card}')

    # the first int8 forward at B64 T601: every conv and GEMM as the path
    # computed it, bit-equal to its plain version (float64 on the card)
    shapes = collections.Counter()
    for kind, x, w, a, kw, out in captured:
        if kind == 'conv':
            ref = int8.int8_conv1d_plain(x, w, *a, **kw)
            K = (kw['w_packed'] if w is None else w).shape[0]
            shape = f'conv B{x.shape[0]} T{x.shape[1]} {x.shape[2]}->{out.shape[2]} K{K}'
        else:
            ref = int8.int8_matmul_plain(x, w, **kw)
            shape = f'GEMM M{x.shape[0]} K{x.shape[1]} N{out.shape[1]}'
        assert torch.equal(out, ref), f'benchmark int8 {shape} differs from the plain version'
        shapes[shape] += 1
    convs = sum(kind == 'conv' for kind, *_ in captured)
    assert (convs, len(captured) - convs) == (32, 12), (convs, len(captured))
    log(f'check: the benchmark\'s first int8 forward (B64 T601): its 32 convs and 12 GEMMs '
        f'bit-equal to their plain versions; shapes {dict(shapes)}')
    del captured

    # one --backward step's K1f loss and K1b gradient against the plain
    # versions, at phase 6's tolerances; the gradient per unit of its
    # upstream gradient g (here 1 / (B * ylen) = 2.4e-4, on which scale an
    # atol of 1e-4 would pass a kernel 40% off)
    (lp, y, xlen, ylen, blank), (alpha, ll) = ctc_calls['alpha']
    ref_alpha, ref_ll = ctc_loss.alpha_plain(lp, y, xlen, ylen, blank)
    feasible = ref_ll > -5e29
    assert torch.equal(ll > -5e29, feasible) and bool(feasible.all())
    assert torch.allclose(alpha, ref_alpha, rtol=1e-5, atol=1e-3), 'K1f alpha differs'
    loss_err = float(((ll - ref_ll).abs() / ref_ll.abs().clamp(min=1)).max())
    assert loss_err < 1e-5, f'K1f loss differs from the plain version by {loss_err}'
    (lp, y, xlen, ylen, a_in, ll_in, g, blank), grad = ctc_calls['beta_grad']
    ref_grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, a_in, ll_in, g, blank)
    assert bool((g > 0).all()), g
    unit = g.to(grad.dtype)[:, None, None]
    grad_err = float((grad - ref_grad).abs().max())
    unit_err = float(((grad - ref_grad) / unit).abs().max())
    assert torch.allclose(grad / unit, ref_grad / unit, rtol=1e-3, atol=1e-4), \
        f'K1b gradient differs from the plain version by {unit_err} per unit of g'
    log(f'check: the benchmark\'s first --backward step (B{lp.shape[0]} T{lp.shape[1]} '
        f'L{y.shape[1]}): K1f loss within {loss_err:.2e} relative of the plain version, K1b '
        f'gradient within {grad_err:.2e} ({unit_err:.2e} per unit of g, g in '
        f'[{float(g.min()):.3e}, {float(g.max()):.3e}])')

    rows = tsv.read_text().splitlines()
    assert rows[0] == 'model\tB\tT_sec\tkind\tmean_ms\trtf' and \
        [r.split('\t')[3] for r in rows[1:]] == kinds, rows
    trace = json.loads((trace_dir / 'trace.json').read_text())
    on_card = [e for e in trace['traceEvents'] if e.get('cat') == 'kernel']
    assert on_card, 'the --profile trace holds no kernel on the card'
    log(f'check: the TSV has the JAX header and a row per run ({len(rows) - 1}); the --profile '
        f'trace holds {len(on_card)} kernel events on the card')


def train_flags_phase(device, card):
    """Phase 16: the rest of train at full JasperNetBig width."""
    import contextlib
    import io
    from convasr_tpu_torch.cli import train as train_cli
    from convasr_tpu_torch.models.jasper import JasperNet
    from convasr_tpu_torch.ops import ctc_loss
    from convasr_tpu_torch.train.loop import compute_losses, undo_int16_transport

    exp_dir = WORK / 'train_flags'
    logits = exp_dir / 'logits_{val_dataset_name}.npz'
    base = ['--train-data-path', str(WORK / 'train.json'), '--val-data-path',
            str(WORK / 'val.json'), '--experiments-dir', str(exp_dir),
            '--train-batch-size', '32', '--val-batch-size', '16', '--iterations', '6',
            '--val-iteration-interval', '6', '--log-iteration-interval', '1', '--epochs', '3',
            '--skip-on-epoch-end-evaluation', '--num-workers', '4', '--checkpoint-skip',
            '--text-config', str(ROOT / 'configs' / 'ru_text_config.json'),
            '--val-config', str(ROOT / 'configs' / 'ru_val_config.json')]
    flags = ['--spec-augment', '--remat', '--adapt-bn', '--exphtml', '--logits', str(logits)]

    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        train_cli.main(train_cli.build_parser().parse_args(
            base + flags + ['--dump-model-config', '--experiment-id', 'dump']))
    config = json.loads(printed.getvalue())
    assert config['remat'] == 'True' and config['spec_augment'] == '(2, 50, 2, 13, 0)' and \
        config['base_width'] == '128', config
    log(f'check: --dump-model-config printed the architecture ({len(config)} fields: remat '
        f'{config["remat"]}, spec_augment {config["spec_augment"]}) and exited')

    make_step = train_cli.make_train_step
    results = {}
    plain = [f for f in flags if f != '--remat']
    # in turns on the same batches, so that neither side alone pays the
    # first sight of a shape
    for name, extra in (('remat', flags), ('no_remat', plain), ('no_remat_2', plain),
                        ('remat_2', flags)):
        seen, steps = {}, []

        def spy_make_step(model, *a, **kw):
            seen['model'] = model
            step = make_step(model, *a, **kw)

            def timed(state, batch, generator=None):
                seen.setdefault('batch', {k: v.clone() for k, v in batch.items()})
                torch.cuda.synchronize()
                tic = time.perf_counter()
                metrics = step(state, batch, generator)
                torch.cuda.synchronize()
                steps.append(time.perf_counter() - tic)
                return metrics
            return timed

        train_cli.make_train_step = spy_make_step
        args = train_cli.build_parser().parse_args(base + extra + ['--experiment-id', name])
        ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0
        ctc_loss.BETA_GRAD_LAUNCHES = 0
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # what earlier phases left allocated; each run's peak is taken above it
        baseline = torch.cuda.memory_allocated()
        try:
            train_cli.main(args)
        finally:
            train_cli.make_train_step = make_step
        torch.cuda.synchronize()
        launches = dict(ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                        ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
                        ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES)
        peak = torch.cuda.max_memory_allocated() - baseline
        logged = [json.loads(line) for line in open(exp_dir / name / 'log.json')]
        assert len(steps) == 6 and [m['iteration'] for m in logged] == list(range(1, 7)), logged
        assert all(np.isfinite(m['loss']) for m in logged), logged
        # 6 steps and one val batch of 16 (adapt-bn's forwards take no loss)
        assert launches == dict(ctc_loss_alpha=7, ctc_loss_beta_grad_warp=6,
                                ctc_loss_beta_grad=0), launches
        results[name] = (peak, statistics.median(steps[1:]), [m['loss'] for m in logged])
        assert results[name][2] == results['remat'][2], 'the runs did not see the same batches'
        if name == 'remat':
            # kept on the host, so that the later runs' peaks are their own
            first = dict(state={k: v.cpu() for k, v in seen['model'].state_dict().items()},
                         config=seen['model'].config,
                         batch={k: v.cpu() for k, v in seen['batch'].items()})
        del seen
        gc.collect()
        left = torch.cuda.memory_allocated() - baseline
        # the run's model, optimizer state and batches are all freed: a
        # leaked model alone would be 0.7 GiB
        assert left < 64 * 2 ** 20, f'{left} bytes outlive the {name} run'
        log(f'train {" ".join(extra[:-1])} [{name}]: JasperNetBig bf16, 6 steps of 32 rows, '
            f'median of steps 2-6 {statistics.median(steps[1:]) * 1e3:.1f} ms (step ms '
            f'{[round(t * 1e3, 1) for t in steps]}), max_memory_allocated '
            f'{peak / 2 ** 30:.2f} GiB above the {baseline / 2 ** 30:.3f} GiB allocated before '
            f'the run, {left / 2 ** 20:.1f} MiB left after it; losses {[round(m["loss"], 3) for m in logged]}; '
            f'launches {launches}; card: {card}')
    text = (exp_dir / 'remat' / 'log.txt').read_text()
    assert 'WER:' in text and (exp_dir / 'public' / 'index.html').exists(), 'no exphtml page'
    dump = np.load(str(logits).format(val_dataset_name='val.json'))
    rows = [k for k in dump.files if k.startswith('logits_')]
    assert len(rows) == 16 and all(np.isfinite(dump[k]).all() and dump[k].shape[1] == 38
                                   for k in rows), dump.files[:4]
    gib = {k: f'{v[0] / 2 ** 30:.2f}' for k, v in results.items()}
    ms = {k: f'{v[1] * 1e3:.1f}' for k, v in results.items()}
    log(f'check: log.txt, the exphtml page ({len(list((exp_dir / "events").glob("*.json")))} '
        f'events), the logits .npz ({len(rows)} utterances) written; peak memory GiB above the baseline {gib}; '
        f'median step ms {ms} (in turns, on the same batches)')

    # one float32 step with remat against one without, on the card: the
    # trained weights, phase 16's first batch, one generator seed
    batch = {k: v.to(device) for k, v in first['batch'].items()}
    outcome = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            model = JasperNet(**{k: v for k, v in first['config'].items()
                                 if k not in ('dtype', 'remat')}, remat=remat,
                              dtype=torch.float32).to(device).train()
            model.load_state_dict(first['state'])
            g = torch.Generator(device=device).manual_seed(7)
            x = undo_int16_transport(batch['x'])
            loss = compute_losses(model(x, xlen=batch['xlen'], generator=g), batch['y'],
                                  batch['ylen']).mean()
            grads = torch.autograd.grad(loss, list(model.parameters()))
            outcome.append((loss.detach(), [gr.detach() for gr in grads]))
            del model
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (loss0, grads0), (loss1, grads1) = outcome
    loss_err = abs(float(loss0) - float(loss1)) / abs(float(loss0))
    assert loss_err <= 1e-5, f'remat loss differs by {loss_err}'
    worst = 0.0
    for a, b in zip(grads0, grads1):
        assert torch.allclose(b, a, rtol=1e-5, atol=1e-6), 'a remat gradient differs'
        worst = max(worst, float((b - a).abs().max()))
    log(f'check: one float32 step of JasperNetBig (B{batch["x"].shape[0]}, dropout 0.2, '
        f'SpecAugment) with --remat against without: loss within {loss_err:.2e} relative, '
        f'gradients within {worst:.2e} (rtol 1e-5, atol 1e-6)')


def whole_t_phases(cases):
    """Phase 13; returns the JSON records of K2f's two kernels and of K2b's
    three."""
    import torch.nn.functional as F
    from convasr_tpu_torch.ops import ctc_loss, ctc_loss_whole_t as k2

    def counts():
        return dict(ctc_loss_whole_t_alpha=k2.ALPHA_LAUNCHES,
                    ctc_loss_whole_t_beta_grad_warp=k2.BETA_GRAD_WARP_LAUNCHES,
                    ctc_loss_whole_t_beta_grad=k2.BETA_GRAD_LAUNCHES,
                    ctc_loss_whole_t_beta_grad_k1_block=k2.BETA_GRAD_K1_BLOCK_LAUNCHES)

    def drive(lp, y, xlen, ylen, blank, g, route):
        """ctc_loss_whole_t forward and backward; asserts one launch of the
        ring forward and one of the backward kernel `route` names."""
        x = lp.detach().clone().requires_grad_()
        before = counts()
        torch.cuda.synchronize()
        loss = k2.ctc_loss_whole_t(x, y, xlen, ylen, blank=blank)
        (loss * g).sum().backward()
        torch.cuda.synchronize()
        added = {k: v - before[k] for k, v in counts().items()}
        want = {k: int(k in ('ctc_loss_whole_t_alpha', f'ctc_loss_whole_t_{route}'))
                for k in added}
        assert added == want, f'K2 launches {added} where {want} was due'
        return loss.detach(), x.grad

    def seeded(seed, B, T, L, C=38):
        """A seeded batch with a row of xlen 0 that takes frame 0 (a finite
        loss, a zero gradient)."""
        rng = np.random.RandomState(seed)
        lp = torch.log_softmax(torch.from_numpy(rng.randn(B, T, C).astype(np.float32) * 3), -1)
        y = torch.from_numpy(rng.randint(0, C - 1, size=(B, L)).astype(np.int32))
        xlen = torch.from_numpy(rng.randint(T // 2, T + 1, size=B).astype(np.int32))
        ylen = torch.from_numpy(rng.randint(L // 4, L // 2, size=B).astype(np.int32))
        xlen[0], ylen[0] = 0, 1
        g = torch.from_numpy(rng.uniform(0.5, 1.5, B).astype(np.float32))
        return lp, y, xlen, ylen, C - 1, g

    def against_plain(label, batch, loss, grad):
        lp, y, xlen, ylen, blank, g = batch
        x_cpu = lp.clone().requires_grad_()
        ref = k2.ctc_loss_whole_t(x_cpu, y, xlen, ylen, blank=blank)
        (ref * g).sum().backward()
        finite = torch.isfinite(ref)
        assert finite[0] and torch.equal(torch.isfinite(loss).cpu(), finite), label
        loss_rel = float(((loss.cpu() - ref).abs() / ref.abs().clamp(min=1))[finite].max())
        grad_err = float((grad.cpu() - x_cpu.grad).abs().max())
        assert loss_rel < 1e-5, f'K2f {label}: loss differs from the plain version by {loss_rel}'
        assert torch.allclose(grad.cpu(), x_cpu.grad, rtol=1e-3, atol=1e-4), \
            f'K2b {label}: gradient differs from the plain version by {grad_err}'
        assert (grad[0] == 0).all(), f'{label}: the row of xlen 0 has a gradient'
        return loss_rel, grad_err

    # 13. the whole-T loss forward and backward on K2b's three routes, the
    # counts set to 0 just before and read just after: phase 5's captured
    # train batch (L 128: K1b's warp kernel), a seeded batch past WARP_S_MAX
    # (S 601: the whole-T block kernel) and one past smem_fits (B4 T1600 S 601,
    # 248 KB a row: K1b's block kernel); the forward on the ring kernel on all three
    lp, y, xlen, ylen, blank, g = cases[0][1]
    over = seeded(13, 8, 300, 300)
    past = seeded(14, 4, 1600, 300)
    assert k2.smem_fits(300, 300, 38) and not k2.smem_fits(1600, 300, 38)
    k2.ALPHA_LAUNCHES = k2.BETA_GRAD_LAUNCHES = k2.BETA_GRAD_WARP_LAUNCHES = 0
    k2.BETA_GRAD_K1_BLOCK_LAUNCHES = 0
    loss, grad = drive(lp, y, xlen, ylen, blank, g, 'beta_grad_warp')
    over_out = drive(*(t.cuda() if torch.is_tensor(t) else t for t in over), 'beta_grad')
    past_out = drive(*(t.cuda() if torch.is_tensor(t) else t for t in past),
                     'beta_grad_k1_block')
    path_launches = counts()
    assert path_launches == dict(ctc_loss_whole_t_alpha=3, ctc_loss_whole_t_beta_grad_warp=1,
                                 ctc_loss_whole_t_beta_grad=1,
                                 ctc_loss_whole_t_beta_grad_k1_block=1), path_launches
    k1_loss = ctc_loss.ctc_loss_auto(lp, y, xlen, ylen, blank=blank)
    assert torch.isfinite(loss).all() and torch.isfinite(grad).all()
    k1_rel = float(((loss - k1_loss).abs() / k1_loss.abs()).max())
    assert k1_rel < 1e-5, f'K2 and K1 losses differ by {k1_rel} on rows with xlen > 0'
    log(f'ctc_loss_whole_t on the train batch {tuple(lp.shape)}: loss relative to K1 '
        f'{k1_rel:.2e} (same math where xlen > 0); launches on the three routes '
        f'{path_launches}')
    for label, batch, out in (('S 601 B8 T300', over, over_out),
                              ('past smem_fits B4 T1600 S 601', past, past_out)):
        (B, T, C), L = batch[0].shape, batch[1].shape[1]
        loss_rel, grad_err = against_plain(label, batch, *out)
        log(f'ctc_loss_whole_t {label} (route {k2.beta_grad_route(T, L, C)}, shared memory a '
            f'row {k2.smem_bytes(T, L, C) / 1024:.1f} KiB, fits: {k2.smem_fits(T, L, C)}): loss '
            f'rel err {loss_rel:.2e}, grad max abs err {grad_err:.2e} against the plain version '
            f'on the CPU; the row of xlen 0 has a finite loss and a zero gradient')

    # K2f and K2b at the BPE head's width (B4 T200 C 5000 L40): the ring
    # forward on the gathered staging with frame 0 taken by every row, and
    # K1b's warp kernel, against the plain versions on the card by K1's
    # checks at this width (rtol 1e-5; grad_agreement); counts nothing
    lp_, y_, xlen_, ylen_, blank_, g_ = (t.cuda() if torch.is_tensor(t) else t
                                          for t in seeded(15, 4, 200, 40, C=5000))
    assert ctc_loss.gathers(40, 5000, forward=True) and k2.beta_grad_route(200, 40, 5000) == 'warp'
    ref_alpha, ref_ll = k2.alpha_whole_t_plain(lp_, y_, xlen_, ylen_, blank_)
    ref_grad = ctc_loss.beta_grad_plain(lp_, y_, xlen_, ylen_, ref_alpha, ref_ll, g_, blank_)
    alpha, ll = k2._alpha_route(lp_, y_, xlen_, ylen_, blank_, 'ring')
    grad = k2._beta_grad_route(lp_, y_, xlen_, ylen_, alpha, ll, g_, blank_, 'warp')
    feasible = ref_ll > -5e29
    loss_rel = float(((ll - ref_ll).abs() / ref_ll.abs().clamp(min=1))[feasible].max())
    ok, unit_err, row_l2 = ctc_loss.grad_agreement(grad, ref_grad, g_)
    assert bool(feasible[0]) and torch.equal(ll > -5e29, feasible) and loss_rel < 1e-5, \
        f'K2f at C 5000: loss rel err {loss_rel} or feasible rows differ from the plain version'
    assert ok and bool((grad[0] == 0).all()), \
        f'K2b at C 5000: gradient off the plain version ({unit_err}, row L2 {row_l2})'
    log(f'ctc_loss_whole_t at the BPE head (B4 T200 C 5000 L40, gathered staging, route warp): '
        f'loss rel err {loss_rel:.2e}, grad max abs err {unit_err:.2e} per unit of g, row L2 '
        f'{row_l2:.2e} against the plain version on the card; the row of xlen 0 has a finite '
        f'loss and a zero gradient')

    # the backward's two block kernels in turns where both reach (S 601, T
    # 300), the time past smem_fits, and the forward there
    for label, batch in (('S 601 B8 T300', over), ('past smem_fits B4 T1600 S 601', past)):
        lp_, y_, xlen_, ylen_, blank_, g_ = (t.cuda() if torch.is_tensor(t) else t
                                              for t in batch)
        (B, T, C), L = lp_.shape, y_.shape[1]
        alpha, ll = k2.alpha_kernel(lp_, y_, xlen_, ylen_, blank_)
        routes = ('block', 'k1_block') if k2.smem_fits(T, L, C) else ('k1_block',)
        turns = {r: [] for r in routes}
        for r in routes + routes[::-1]:
            turns[r].append(cuda_ms(lambda: k2._beta_grad_route(
                lp_, y_, xlen_, ylen_, alpha, ll, g_, blank_, r), reps=10))
        fwd_ms = cuda_ms(lambda: k2.alpha_kernel(lp_, y_, xlen_, ylen_, blank_), reps=10)
        best = {r: min(v) for r, v in turns.items()}
        text = ', '.join(f'{r} {best[r]:.4f}-{max(turns[r]):.4f} ms' for r in routes)
        if len(routes) == 2:
            won = min(routes, key=best.get)
            text += (f'; faster: {won}, by {max(best.values()) / min(best.values()) - 1:.1%}; '
                     f'the route sends this lattice to {k2.beta_grad_route(T, L, C)}')
        log(f'ctc_loss_whole_t backward [{label}]: {text}; forward (ring) {fwd_ms:.4f} ms')

    records = []
    for label, (lp, y, xlen, ylen, blank, g) in cases:
        B, T, C = lp.shape
        L = y.shape[1]
        assert k2.smem_fits(T, L, C), f'{label}: T={T} does not fit the whole-T kernels'
        route = k2.beta_grad_route(T, L, C)
        ref_alpha, ref_ll = k2.alpha_whole_t_plain(lp, y, xlen, ylen, blank)
        ref_grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, ref_alpha, ref_ll, g, blank)
        feasible = ref_ll > -5e29
        loss_errs, loss_abs = {}, {}
        for r in ('ring', 'whole_t'):
            alpha, ll = k2._alpha_route(lp, y, xlen, ylen, blank, r)
            assert torch.equal(ll > -5e29, feasible), f'{label}: K2f ({r}) feasible rows differ'
            loss_errs[r] = float(((ll - ref_ll).abs() / ref_ll.abs().clamp(min=1))[feasible].max())
            loss_abs[r] = float((ll - ref_ll).abs()[feasible].max())
            assert loss_errs[r] < 1e-5, \
                f'{label}: K2f ({r}) loss differs from the plain version by {loss_errs[r]}'
        alpha, ll = k2.alpha_kernel(lp, y, xlen, ylen, blank)
        grad_errs = {}
        for r in ('warp', 'block', 'k1_block'):
            grad = k2._beta_grad_route(lp, y, xlen, ylen, alpha, ll, g, blank, r)
            torch.cuda.synchronize()
            grad_errs[r] = float((grad - ref_grad).abs().max())
            # gamma in [0, 1], summed per class (the block kernels with atomics)
            assert torch.allclose(grad, ref_grad, rtol=1e-3, atol=1e-4), \
                f'{label}: K2b ({r}) gradient differs from the plain version by {grad_errs[r]}'
        # K2f's two kernels and K1f in turns, in the same call, by events and
        # queued (the card's own time, without the wrappers' host work)
        fwd_turns = {r: [] for r in ('ring', 'whole_t', 'k1')}
        fwd_queued = {r: [] for r in fwd_turns}
        for r in ('whole_t', 'ring', 'k1', 'k1', 'ring', 'whole_t'):
            run = (lambda: ctc_loss.alpha_kernel(lp, y, xlen, ylen, blank)) if r == 'k1' else \
                (lambda: k2._alpha_route(lp, y, xlen, ylen, blank, r))
            fwd_turns[r].append(cuda_ms(run, reps=20))
            own = queued_ms(run, reps=20)
            fwd_queued[r].append(fwd_turns[r][-1] if own is None else own)
        fwd_ms = {r: min(v) for r, v in fwd_turns.items()}
        fwd_own = {r: min(v) for r, v in fwd_queued.items()}
        turns = {r: [] for r in ('block', 'warp', 'k1_block')}
        for r in ('block', 'warp', 'k1_block', 'k1_block', 'warp', 'block'):
            turns[r].append(cuda_ms(lambda: k2._beta_grad_route(lp, y, xlen, ylen, alpha, ll, g,
                                                                blank, r), reps=20))
        bwd_ms = {r: min(v) for r, v in turns.items()}
        k1_alpha, k1_ll = ctc_loss.alpha_kernel(lp, y, xlen, ylen, blank)
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
        log(f'ctc_loss_whole_t [{label}] B={B} T={T} C={C} L={L}: loss rel err ring '
            f'{loss_errs["ring"]:.2e}, whole-T {loss_errs["whole_t"]:.2e}; grad max abs err '
            + ', '.join(f'{r} {e:.2e}' for r, e in grad_errs.items())
            + '; by events (queued) in turns: K2f on the ring kernel '
            + ', the whole-T forward '.join(
                f'{fwd_ms[r]:.4f}-{max(fwd_turns[r]):.4f} ms ({fwd_own[r]:.4f}-'
                f'{max(fwd_queued[r]):.4f})' for r in ('ring', 'whole_t'))
            + f', K1f {fwd_ms["k1"]:.4f}-{max(fwd_turns["k1"]):.4f} ms ({fwd_own["k1"]:.4f}-'
            f'{max(fwd_queued["k1"]):.4f}); K2b on K1b\'s '
            f'warp kernel {bwd_ms["warp"]:.4f}-{max(turns["warp"]):.4f} ms, on the whole-T block '
            f'kernel {bwd_ms["block"]:.4f}-{max(turns["block"]):.4f} ms, on K1b\'s block kernel '
            f'{bwd_ms["k1_block"]:.4f}-{max(turns["k1_block"]):.4f} ms (route: {route}); K1b '
            f'{k1_bwd_ms:.4f} ms; plain fwd {plain_fwd_ms:.2f} ms, bwd {plain_bwd_ms:.2f} ms; '
            f'F.ctc_loss fwd {lib_fwd_ms:.4f} ms, fwd+bwd {lib_pair_ms:.4f} ms; bound fwd '
            f'{bounds["alpha"][0]:.5f} ms ({bounds["alpha"][1]}), bwd '
            f'{bounds["beta_grad"][0]:.5f} ms ({bounds["beta_grad"][1]}); shared memory a block '
            f'of the whole-T kernels {k2.smem_bytes(T, L, C) / 1024:.1f} KiB')
        records.append(dict(
            **{f'alpha_{r}': (fwd_ms[r], plain_fwd_ms, *bounds['alpha'], lib_fwd_ms, loss_abs[r])
               for r in ('ring', 'whole_t')},
            **{f'beta_grad_{r}': (bwd_ms[r], plain_bwd_ms, *bounds['beta_grad'], lib_pair_ms,
                                  grad_errs[r]) for r in ('warp', 'block', 'k1_block')}))

    kernels = []
    for name, key, source, line in (
            ('ctc_loss_whole_t_alpha', 'alpha_ring', 'ctc_loss.cu', 60),
            ('ctc_loss_whole_t_alpha_whole_t', 'alpha_whole_t', 'ctc_loss_whole_t.cu', 60),
            ('ctc_loss_whole_t_beta_grad_warp', 'beta_grad_warp', 'ctc_loss.cu', 83),
            ('ctc_loss_whole_t_beta_grad', 'beta_grad_block', 'ctc_loss_whole_t.cu', 83),
            ('ctc_loss_whole_t_beta_grad_k1_block', 'beta_grad_k1_block', 'ctc_loss.cu', 83)):
        ms, plain_ms, bound, bound_by, lib_ms, err = records[0][key]
        kernels.append(dict(name=name, route='cuda', source=f'convasr_tpu_torch/csrc/{source}',
                            replaces=f'convasr_tpu/ops/ctc_pallas.py:{line}',
                            launches=path_launches.get(name, 0), max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                            library_ms=lib_ms))
    return kernels


# -- 17. serving ---------------------------------------------------------------

def itu_ulaw_encode(samples):
    """ITU-T G.711 mu-law compressor (bias 0x84, segment search): the bytes a
    telephony client sends as MULAW."""
    out = np.empty(len(samples), np.uint8)
    for i, s in enumerate(np.asarray(samples, np.int32)):
        sign = 0x80 if s < 0 else 0
        s = min(abs(s), 32635) + 0x84
        exponent, mask = 7, 0x4000
        while exponent > 0 and not (s & mask):
            exponent -= 1
            mask >>= 1
        out[i] = ~(sign | (exponent << 4) | ((s >> (exponent + 3)) & 0x0F)) & 0xFF
    return out


def to_int16(signal):
    return (np.clip(signal, -1.0, 1.0) * 32767.0).round().astype(np.int16)


def percentiles_ms(seconds):
    ms = np.asarray(seconds) * 1e3
    return (f'p50 {np.percentile(ms, 50):.2f} / p90 {np.percentile(ms, 90):.2f} / '
            f'p99 {np.percentile(ms, 99):.2f} ms (mean {ms.mean():.2f}, n {len(ms)})')


class ForwardSpy:
    """Records what a forward entry point was given and returned, on the host."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, x, xlen, *a):
        out = self.fn(x, xlen, *a)
        self.calls.append((x.cpu().numpy().copy(), xlen.cpu().numpy().copy(),
                           out.cpu().numpy().copy()))
        return out


def int8_counts(int8):
    return dict(int8_conv_wgmma=int8.CONV_LAUNCHES, int8_gemm_wgmma=int8.GEMM_WGMMA_LAUNCHES,
                int8_conv_mma_sync=int8.CONV_MMA_SYNC_LAUNCHES,
                int8_gemm_whole_k=int8.GEMM_WHOLE_K_LAUNCHES,
                int8_gemm_k_tiled=int8.GEMM_K_TILED_LAUNCHES)


def reset_int8_counts(int8):
    int8.CONV_LAUNCHES = int8.GEMM_WGMMA_LAUNCHES = int8.CONV_MMA_SYNC_LAUNCHES = 0
    int8.GEMM_WHOLE_K_LAUNCHES = int8.GEMM_K_TILED_LAUNCHES = 0


def check_int8_calls(int8, captured, label, expect=(32, 12)):
    """Every captured int8 conv and GEMM bit-equal to its plain version
    (float64 on the card), `expect` (convs, GEMMs) of them; returns the
    shapes."""
    shapes = collections.Counter()
    for kind, x, w, a, kw, out in captured:
        if kind == 'conv':
            ref = int8.int8_conv1d_plain(x, w, *a, **kw)
            K = (kw['w_packed'] if w is None else w).shape[0]
            shape = f'conv B{x.shape[0]} T{x.shape[1]} {x.shape[2]}->{out.shape[2]} K{K}'
        else:
            ref = int8.int8_matmul_plain(x, w, **kw)
            shape = f'GEMM M{x.shape[0]} K{x.shape[1]} N{out.shape[1]}'
        assert torch.equal(out, ref), f'{label}: int8 {shape} differs from the plain version'
        shapes[shape] += 1
    convs = sum(kind == 'conv' for kind, *_ in captured)
    assert (convs, len(captured) - convs) == expect, (label, convs, len(captured))
    return shapes


class Int8Capture:
    """Swaps spies into ops/int8 that keep the next forward's convs and
    GEMMs with their inputs and outputs: `limit` calls (a forward's 32 convs
    and 12 GEMMs; 34 and 12 with the BPE head)."""

    def __init__(self, int8, limit=44):
        self.int8, self.captured, self.limit = int8, [], limit
        self.conv, self.gemm = int8.int8_conv1d, int8.int8_matmul

    def __enter__(self):
        def spy_conv(x, w, *a, **kw):
            out = self.conv(x, w, *a, **kw)
            if len(self.captured) < self.limit:
                self.captured.append(('conv', x.clone(), w, a, kw, out.clone()))
            return out

        def spy_gemm(a, b, b_packed=None):
            out = self.gemm(a, b, b_packed=b_packed)
            if len(self.captured) < self.limit:
                self.captured.append(('gemm', a.clone(), b, (), dict(b_packed=b_packed),
                                      out.clone()))
            return out
        self.int8.int8_conv1d, self.int8.int8_matmul = spy_conv, spy_gemm
        return self

    def __exit__(self, *exc):
        self.int8.int8_conv1d, self.int8.int8_matmul = self.conv, self.gemm


class CTCCapture:
    """Swaps spies into ops/ctc_loss and ops/align that keep the first call
    of the CTC forward (K1f), the CTC backward (K1b) and the alignment (K3)
    kernels after entry, with their inputs and outputs, for
    check_ctc_calls; with `classes`, the first on log-probs of that many
    classes (a head of a dual-head model)."""

    def __init__(self, ctc_loss, align, classes=None):
        self.ctc_loss, self.align, self.calls = ctc_loss, align, {}
        self.classes = classes
        self.kernels = dict(alpha=ctc_loss.alpha_kernel, beta_grad=ctc_loss.beta_grad_kernel,
                            viterbi=align.ctc_alignment_kernel)

    def __enter__(self):
        def clone(v):
            if isinstance(v, (tuple, list)):
                return type(v)(clone(t) for t in v)
            return v.clone() if torch.is_tensor(v) else v

        def spy(name):
            def run(*a, **kw):
                out = self.kernels[name](*a, **kw)
                if name not in self.calls and self.classes in (None, a[0].shape[-1]):
                    self.calls[name] = (clone(a), dict(kw), clone(out))
                return out
            return run
        self.ctc_loss.alpha_kernel, self.ctc_loss.beta_grad_kernel = spy('alpha'), \
            spy('beta_grad')
        self.align.ctc_alignment_kernel = spy('viterbi')
        return self

    def __exit__(self, *exc):
        self.ctc_loss.alpha_kernel = self.kernels['alpha']
        self.ctc_loss.beta_grad_kernel = self.kernels['beta_grad']
        self.align.ctc_alignment_kernel = self.kernels['viterbi']


def check_ctc_calls(calls, label, expect=('alpha', 'beta_grad')):
    """The kept CTC and alignment calls (CTCCapture) replayed through their
    plain versions on the card: K1f's alpha (rtol 1e-5, atol 1e-3), feasible
    rows and loss (1e-5 relative), K1b's gradient per unit of its upstream
    gradient g (ops/ctc_loss.grad_agreement: rtol 1e-3, atol 1e-4 at 38
    classes shrunk by 38 / C, each row's relative L2 within 1e-5; phase 15's
    check, on which scale an absolute atol would pass a kernel far off) and
    K3's char frames bit-equal. Returns a line for the log."""
    from convasr_tpu_torch.ops import ctc_loss
    from convasr_tpu_torch.ops.ctc import ctc_alignment
    assert set(expect) <= set(calls), f'{label}: kept calls {sorted(calls)}, want {expect}'
    text = []
    if 'alpha' in calls:
        (lp, y, xlen, ylen, blank), _, (alpha, ll) = calls['alpha']
        ref_alpha, ref_ll = ctc_loss.alpha_plain(lp, y, xlen, ylen, blank)
        feasible = ref_ll > -5e29
        assert torch.equal(ll > -5e29, feasible) and bool(feasible.any()), \
            f'{label}: K1f feasible rows differ from the plain version'
        assert torch.allclose(alpha, ref_alpha, rtol=1e-5, atol=1e-3), f'{label}: K1f alpha'
        loss_err = float(((ll - ref_ll).abs() / ref_ll.abs().clamp(min=1))[feasible].max())
        assert loss_err < 1e-5, f'{label}: K1f loss differs from the plain version by {loss_err}'
        text.append(f'K1f at B{lp.shape[0]} T{lp.shape[1]} L{y.shape[1]} ({lp.dtype}): loss '
                    f'within {loss_err:.2e} relative, {int(feasible.sum())} feasible rows')
    if 'beta_grad' in calls:
        (lp, y, xlen, ylen, a_in, ll_in, g, blank), _, grad = calls['beta_grad']
        ref_grad = ctc_loss.beta_grad_plain(lp, y, xlen, ylen, a_in, ll_in, g, blank)
        ok, unit_err, row_l2 = ctc_loss.grad_agreement(grad, ref_grad, g)
        assert ok, (f'{label}: K1b gradient at C {lp.shape[-1]} differs from the plain version '
                    f'by {unit_err} per unit of g, row relative L2 {row_l2}')
        text.append(f'K1b gradient at C {lp.shape[-1]} within '
                    f'{float((grad - ref_grad).abs().max()):.2e} ({unit_err:.2e} per unit of g, '
                    f'g in [{float(g.min()):.3e}, {float(g.max()):.3e}]; worst row relative L2 '
                    f'{row_l2:.2e})')
    if 'viterbi' in calls:
        a, kw, frames = calls['viterbi']
        ref = ctc_alignment(*a, **kw)
        assert torch.equal(frames, ref), f'{label}: K3 char frames differ from the plain version'
        text.append(f'K3 at B{a[0].shape[0]} T{a[0].shape[1]} L{a[1].shape[1]}: char frames '
                    f'bit-equal')
    torch.cuda.synchronize()
    return f'check: {label} against the plain versions: ' + '; '.join(text)


def host_ms(fn, reps=200):
    """Host time of one call of fn: `reps` calls queued back to back, timed
    on the host clock until the last returns (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    tic = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - tic) / reps * 1e3
    torch.cuda.synchronize()
    return host


def export_phases(device, ckpt, card):
    """Phase 18: export on the card (cli/export.py), the programs run, and
    benchmark --stablehlo / benchmark_online --onnx on them. Returns the
    int8 kernels' launches inside the exported programs."""
    from convasr_tpu_torch.cli import benchmark, benchmark_online, export
    from convasr_tpu_torch.cli import train as train_cli
    from convasr_tpu_torch.models import quantized
    from convasr_tpu_torch.ops import int8

    out_dir = WORK / 'export'
    out_dir.mkdir(parents=True, exist_ok=True)
    B, seconds = 8, 6.0
    common = ['--checkpoint', ckpt, '-B', str(B), '-T', str(seconds), '--device', 'cuda']
    rng = np.random.RandomState(18)
    x = torch.from_numpy(np.stack([speechlike(rng, int(SR * seconds)) for _ in range(B)])
                         .astype(np.float32)).to(device)
    xlen = torch.from_numpy(rng.uniform(0.6, 1.0, B).astype(np.float32))
    xlen[0] = 1.0
    xlen = xlen.to(device)

    # bf16: export and --validate through the CLI, then the program against
    # the eager forward on speech-like input, timed in turns
    bf16_path = str(out_dir / 'jasper_big_bf16.pt2')
    args = export.build_parser().parse_args(common + ['-o', bf16_path, '--bf16', 'true',
                                                      '--validate'])
    tic = time.perf_counter()
    export.main(args)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - tic
    model = export.build(args, device)[0]
    program = export.Program(bf16_path, device)
    assert program.example_shape == (B, int(SR * seconds)), program.example_shape
    with torch.inference_mode():
        live = model(x, xlen=xlen)['logits'][0].float()
    art = program(x, xlen)[0].float()
    np.testing.assert_allclose(art.cpu().numpy(), live.cpu().numpy(), rtol=1e-1, atol=1e-2)
    ids = float((art.argmax(-1) == live.argmax(-1)).float().mean())

    def eager():
        with torch.inference_mode():
            return model(x, xlen=xlen)
    turns = {'eager': [], 'program': []}
    for name in ('eager', 'program', 'program', 'eager'):
        turns[name].append(cuda_ms(eager if name == 'eager' else lambda: program(x, xlen),
                                   reps=20))
    log(f'export bf16 B{B} x {seconds:.0f} s (CLI, --validate): {export_s:.2f} s; the program '
        f'on speech-like input within rtol 1e-1 / atol 1e-2 of the eager forward, max |diff| '
        f'{float((art - live).abs().max()):.3e}, argmax ids equal {ids:.4f}, bit-equal '
        f'{torch.equal(art, live)}; forward by CUDA events in turns: eager '
        f'{turns["eager"][0]:.3f} / {turns["eager"][1]:.3f} ms, program '
        f'{turns["program"][0]:.3f} / {turns["program"][1]:.3f} ms; card: {card}')

    # int8: export on phase 8's calibration through the CLI, then the program
    # on its sidecar against the live int8 forward on the same tree
    cache = str(WORK / 'act_scales.npz')
    int8_path = str(out_dir / 'jasper_big_int8.pt2')
    args = export.build_parser().parse_args(common + ['-o', int8_path, '--quantize', 'int8',
                                                      '--calibration-cache', cache,
                                                      '--validate'])
    tic = time.perf_counter()
    export.main(args)
    torch.cuda.synchronize()
    export_int8_s = time.perf_counter() - tic
    model32 = export.build(args, device)[0]
    program = export.Program(int8_path, device)

    def live_int8():
        return quantized.quantized_apply(model32, program.qtree, x, xlen)['logits'][0]
    live = live_int8()
    torch.cuda.synchronize()
    reset_int8_counts(int8)
    live_int8()
    torch.cuda.synchronize()
    live_counts = int8_counts(int8)
    reset_int8_counts(int8)
    packs = (int8.CONV_WEIGHT_PACKS, int8.GEMM_WEIGHT_PACKS)
    with Int8Capture(int8) as capture:
        art = program(x, xlen)[0]
        torch.cuda.synchronize()
    program_counts = int8_counts(int8)
    want = dict(int8_conv_wgmma=32, int8_gemm_wgmma=12, int8_conv_mma_sync=0,
                int8_gemm_whole_k=0, int8_gemm_k_tiled=0)
    assert live_counts == program_counts == want, (live_counts, program_counts)
    assert (int8.CONV_WEIGHT_PACKS, int8.GEMM_WEIGHT_PACKS) == packs, 'the program packed'
    shapes = check_int8_calls(int8, capture.captured, 'phase 18 int8 program')
    np.testing.assert_allclose(art.cpu().numpy(), live.cpu().numpy(), rtol=1e-4, atol=1e-4)
    assert torch.equal(art.argmax(-1), live.argmax(-1)), 'int8 program ids differ from live'
    launches = collections.Counter(program_counts)
    turns = {'live': [], 'program': []}
    for name in ('live', 'program', 'program', 'live'):
        turns[name].append(cuda_ms(live_int8 if name == 'live' else lambda: program(x, xlen),
                                   reps=20))
    log(f'export int8 B{B} x {seconds:.0f} s (CLI, phase 8\'s scales, --validate): '
        f'{export_int8_s:.2f} s; launches of one forward: live {live_counts}, program '
        f'{program_counts} (equal), no weight packed; its 32 convs and 12 GEMMs bit-equal to '
        f'the plain versions ({len(shapes)} shapes); logits bit-equal to the live forward '
        f'{torch.equal(art, live)}, argmax ids equal; forward by CUDA events in turns: live '
        f'{turns["live"][0]:.3f} / {turns["live"][1]:.3f} ms, program '
        f'{turns["program"][0]:.3f} / {turns["program"][1]:.3f} ms; card: {card}')

    # the host cost of the registered op against the wrapper it calls, on a
    # conv and a GEMM of the program's forward (block 10's, the deepest)
    convs = [c for c in capture.captured if c[0] == 'conv']
    gemms = [c for c in capture.captured if c[0] == 'gemm']
    _, cx, cw, ca, ckw, _ = max(convs, key=lambda c: c[2].numel())
    _, ga, gb, _, gkw, _ = max(gemms, key=lambda c: c[2].shape[0])
    calls = dict(
        conv_op=lambda: torch.ops.convasr.int8_conv1d(cx, cw, ca[0], ca[1]),
        conv_wrapper=lambda: int8.int8_conv1d(cx, cw, *ca, **ckw),
        gemm_op=lambda: torch.ops.convasr.int8_matmul(ga, gb),
        gemm_wrapper=lambda: int8.int8_matmul(ga, gb, **gkw))
    host = {k: [] for k in calls}
    with torch.inference_mode():                     # as the forwards run
        for k in ('conv_wrapper', 'conv_op', 'conv_op', 'conv_wrapper', 'gemm_wrapper',
                  'gemm_op', 'gemm_op', 'gemm_wrapper'):
            host[k].append(host_ms(calls[k]))
    best = {k: min(v) for k, v in host.items()}
    added = 32 * (best['conv_op'] - best['conv_wrapper']) \
        + 12 * (best['gemm_op'] - best['gemm_wrapper'])

    # the live int8 forward through the ops, and through the wrappers as
    # before the ops were registered (the same cached packed weights), in turns
    through_ops = quantized._conv1d

    def through_wrappers(x, w, stride=1, dilation=1, groups=1, out_dtype=torch.float32):
        if out_dtype != torch.int32:
            return through_ops(x, w, stride, dilation, groups, out_dtype)
        if w.shape[0] == 1 and stride == 1:
            b = w[0]
            packed = int8.packed_gemm_weight(b) if int8.gemm_wgmma_fits(b.shape[0]) else None
            return int8.int8_matmul_auto(x.reshape(-1, x.shape[2]), b,
                                         b_packed=packed).reshape(x.shape[0], x.shape[1], -1)
        return int8.int8_conv1d_auto(x, w, stride, dilation,
                                     w_packed=int8.packed_conv_weight(w))

    forward_ms = {'ops': [], 'wrappers': []}
    try:
        for route in ('wrappers', 'ops', 'ops', 'wrappers'):
            quantized._conv1d = through_ops if route == 'ops' else through_wrappers
            forward_ms[route].append((host_ms(live_int8, 20), cuda_ms(live_int8, 20)))
    finally:
        quantized._conv1d = through_ops
    fwd = {route: tuple(min(v[i] for v in runs) for i in range(2))
           for route, runs in forward_ms.items()}
    log(f'host ms a call under inference mode (200 queued, the least of two turns): conv '
        f'{tuple(cx.shape)} x {tuple(cw.shape)} op {best["conv_op"]:.4f} vs wrapper '
        f'{best["conv_wrapper"]:.4f}; GEMM {tuple(ga.shape)} x {tuple(gb.shape)} op '
        f'{best["gemm_op"]:.4f} vs wrapper {best["gemm_wrapper"]:.4f}: the ops add '
        f'{added:.3f} ms of host work to an int8 forward (32 convs, 12 GEMMs); the live int8 '
        f'forward through the ops: host {fwd["ops"][0]:.3f} ms, events {fwd["ops"][1]:.3f} ms; '
        f'through the wrappers: host {fwd["wrappers"][0]:.3f} ms, events '
        f'{fwd["wrappers"][1]:.3f} ms (least of two turns each)')

    # an int8 program traced on the CPU, loaded on the card: the ops choose
    # the kernels when it runs
    cpu_path = str(out_dir / 'jasper_big_int8_cpu.pt2')
    tic = time.perf_counter()
    export.main(export.build_parser().parse_args(
        ['--checkpoint', ckpt, '-B', '1', '-T', str(seconds), '--device', 'cpu', '-o', cpu_path,
         '--quantize', 'int8', '--calibration-cache', cache]))
    cpu_export_s = time.perf_counter() - tic
    program_cpu = export.Program(cpu_path, device)
    live = quantized.quantized_apply(model32, program_cpu.qtree, x[:1], xlen[:1])['logits'][0]
    reset_int8_counts(int8)
    art = program_cpu(x[:1], xlen[:1])[0]
    torch.cuda.synchronize()
    cpu_counts = int8_counts(int8)
    assert cpu_counts == want, cpu_counts
    assert torch.equal(art.argmax(-1), live.argmax(-1)), 'CPU-traced program ids differ'
    launches.update(cpu_counts)
    log(f'export int8 on the CPU (B1, no --validate) {cpu_export_s:.2f} s, loaded on the card: '
        f'launches {cpu_counts}, argmax ids equal to the live forward, logits bit-equal '
        f'{torch.equal(art, live)}')

    # benchmark --stablehlo on the bf16 program, benchmark_online --onnx on
    # the int8 one (requests padded to its B8 x 6 s)
    result = benchmark.main(benchmark.build_parser().parse_args(
        ['--stablehlo', bf16_path, '-B', str(B), '-T', str(seconds), '--iterations', '10',
         '--warmup-iterations', '2', '--device', 'cuda']))
    assert torch.isfinite(result['first']).all()
    log(f'benchmark --stablehlo (bf16 program, B{B} x {seconds:.0f} s, chained, 10 iterations): '
        f'RTF {result["rtf"]:.1f}, mean {result["times"].mean() * 1e3:.2f} ms a batch')
    reset_int8_counts(int8)
    lat = benchmark_online.main(benchmark_online.build_parser().parse_args(
        ['--onnx', int8_path, '--device', 'cuda', '--rps', '5', '--benchmark-duration', '4',
         '--warmup-iterations', '2']))
    torch.cuda.synchronize()
    online = int8_counts(int8)
    forwards = len(lat) + 2
    assert online == {k: n * forwards for k, n in want.items()}, (online, forwards)
    launches.update(online)
    log(f'benchmark_online --onnx (int8 program on its sidecar, padded to B{B}): '
        f'{percentiles_ms(np.asarray(lat) / 1e3)}; launches {online} for {forwards} forwards')

    # train --onnx: the checkpoint's model with folded batch norm, exported
    # at --onnx-sample-batch-size x --onnx-sample-time and checked
    train_path = str(out_dir / 'jasper_big_train.pt2')
    tic = time.perf_counter()
    train_cli.main(train_cli.build_parser().parse_args(
        ['--checkpoint', ckpt, '--onnx', train_path, '--onnx-validate',
         '--onnx-sample-batch-size', str(B), '--onnx-sample-time', str(seconds),
         '--experiments-dir', str(out_dir / 'exp'), '--experiment-id', 'onnx',
         '--text-config', str(ROOT / 'configs' / 'ru_text_config.json'),
         '--val-config', str(ROOT / 'configs' / 'ru_val_config.json')]))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - tic
    assert 'export parity check passed' in (out_dir / 'exp' / 'onnx' / 'log.txt').read_text()
    assert export.Program(train_path, device).example_shape == (B, int(SR * seconds))
    log(f'train --onnx --onnx-validate (bf16, BN folded, B{B} x {seconds:.0f} s): exported and '
        f'checked in {train_s:.2f} s')
    return dict(launches)


def serve_phases(ckpt, corpus, card):
    """Phase 17: the port's gRPC server on the card (bf16, then --quantize
    int8) through real gRPC channels, and cli/benchmark_online. Returns the
    int8 kernels' launches on the serving path."""
    import contextlib
    import io
    import threading
    import grpc
    from convasr_tpu_torch.audio import read_audio
    from convasr_tpu_torch.audio.io import ulaw_to_int16
    from convasr_tpu_torch.cli import benchmark_online
    from convasr_tpu_torch.data import transcripts
    from convasr_tpu_torch.decode.generators import GreedyCTCGenerator
    from convasr_tpu_torch.ops import int8
    from convasr_tpu_torch.serve import cloud_speech_pb2 as pb2
    from convasr_tpu_torch.serve import grpc_google_api as api

    out_dir = WORK / 'serve'
    out_dir.mkdir(parents=True, exist_ok=True)
    cache = out_dir / 'act_scales.npz'
    cache.unlink(missing_ok=True)
    mixes = [to_int16(read_audio(str(WORK / 'vad_in' / f'mix{k}.wav'), sample_rate=SR,
                                 mono=True)[0][0]) for k in range(2)]
    rng = np.random.RandomState(170)
    unary = [to_int16(0.5 * speechlike(rng, 6 * SR)) for _ in range(20)]
    burst = [to_int16(0.5 * speechlike(rng, 6 * SR)) for _ in range(16)]
    mulaw = itu_ulaw_encode(to_int16(0.5 * speechlike(rng, 6 * SR)))
    stereo = to_int16(0.5 * np.stack([speechlike(rng, 6 * 16000), speechlike(rng, 6 * 16000)],
                                     1).reshape(-1))
    total = collections.Counter()

    def request(samples, rate=SR, channels=1, encoding=pb2.RecognitionConfig.LINEAR16):
        return pb2.RecognizeRequest(
            config=dict(encoding=encoding, sample_rate_hertz=rate, audio_channel_count=channels),
            audio=dict(content=samples.astype('<i2').tobytes()
                       if encoding == pb2.RecognitionConfig.LINEAR16 else samples.tobytes()))

    for label, extra in (('bf16', []),
                         ('int8', ['--quantize', 'int8', '--calibration-data', corpus,
                                   '--calibration-batches', '1', '--calibration-cache',
                                   str(cache)])):
        quantized = label == 'int8'
        args = api.build_parser().parse_args(
            ['--checkpoint', ckpt, '--device', 'cuda', '--endpoint', '127.0.0.1:0',
             '--num-workers', '16', '--batch-window-ms', '5', '--max-batch-size', '8',
             '--streaming-slots', '4', '--warmup-sec', '6'] + extra)
        reset_int8_counts(int8)
        tic = time.perf_counter()
        startup_log = []
        serving = api.start(args, log=startup_log.append)
        startup = time.perf_counter() - tic
        servicer, forward = serving.servicer, serving.servicer.forward
        engine, batcher = servicer.stream_engine, servicer.batcher
        generator = GreedyCTCGenerator(blank_amount_to_space=args.replace_blank_series)
        log(f'serve [{label}]: started on {serving.endpoint} in {startup:.1f} s (model, '
            + ('int8 kernels built, calibration, ' if quantized else '')
            + 'warmup of the 1-6 s buckets and the streaming paths); '
            + ' | '.join(l for l in startup_log if 'calibrated' in l or 'kernels built' in l)
            + f'; launches during startup {int8_counts(int8)}')
        channel = grpc.insecure_channel(serving.endpoint)
        stub, streaming_stub = api.make_client_stub(channel), api.make_streaming_stub(channel)
        try:
            # unary at B1: the batcher set aside, so that each request is one
            # (1, T_pad) forward, the shape a direct call gives
            servicer.batcher = None
            stub(request(unary[0]), timeout=300)              # its first B1 call
            spy = ForwardSpy(forward.fused_i16)
            forward.fused_i16 = spy
            reset_int8_counts(int8)
            singles, responses = [], []
            try:
                for k, samples in enumerate(unary):
                    capture = Int8Capture(int8) if quantized and k == 0 else \
                        contextlib.nullcontext()
                    with capture:
                        tic = time.perf_counter()
                        responses.append(stub(request(samples), timeout=300))
                        singles.append(time.perf_counter() - tic)
                    if quantized and k == 0:
                        b1_shapes = check_int8_calls(int8, capture.captured, 'served B1 forward')
                responses.append(stub(request(mulaw, encoding=pb2.RecognitionConfig.MULAW),
                                      timeout=300))
                responses.append(stub(request(stereo, rate=16000, channels=2), timeout=300))
            finally:
                forward.fused_i16 = spy.fn
            launches = int8_counts(int8)
            forwards = len(spy.calls)
            assert forwards == len(unary) + 2, forwards
            sent = unary + [ulaw_to_int16(mulaw.tobytes())]
            for k, ((x, xlen, packed), response) in enumerate(zip(spy.calls, responses)):
                T = int(round(float(xlen[0]) * x.shape[1]))
                if k < len(sent):
                    # LINEAR16 and MULAW reach the model as the int16 samples sent
                    assert np.array_equal(x[0, :T], sent[k]) and not x[0, T:].any(), k
                else:
                    assert T == len(stereo) // 2 // 2, (T, len(stereo))   # 16 kHz stereo -> 8 kHz
                with torch.inference_mode():
                    direct = forward.fused_i16(torch.from_numpy(x), torch.from_numpy(xlen))
                direct = direct.cpu().numpy()
                assert np.array_equal(direct[..., 0], packed[..., 0]), \
                    f'{label} request {k}: the served ids differ from a direct call'
                n = packed.shape[1]
                [alts] = generator.generate(
                    tokenizer=servicer.text_pipeline.tokenizer, log_probs=None,
                    begin=np.zeros(1), end=np.asarray([T / SR]),
                    output_lengths=np.asarray([int(np.ceil(T / x.shape[1] * n))]),
                    time_stamps=(x.shape[1] / SR) * np.linspace(0, 1, n)[None, :],
                    segment_text_key='hyp', most_probable_idx=direct[..., 0].astype(np.int64))
                text = transcripts.join(hyp=transcripts.map_text(
                    servicer.text_pipeline.postprocess, hyp=alts[0]))
                assert response.results[0].alternatives[0].transcript == text, \
                    f'{label} request {k}: the served transcript differs from a direct call'
            chars = sum(len(r.results[0].alternatives[0].transcript) for r in responses)
            per_forward = {k: v / forwards for k, v in launches.items() if v}
            if quantized:
                assert launches['int8_conv_wgmma'] == 32 * forwards and \
                    launches['int8_gemm_wgmma'] == 12 * forwards, launches
                total.update({k: v for k, v in launches.items()})
            else:
                assert not any(launches.values()), launches
            log(f'serve [{label}] Recognize B1, 20 x 6 s LINEAR16 (one (1, 48000) forward '
                f'each): latency {percentiles_ms(singles)}; then one MULAW and one 16 kHz stereo '
                f'(resampled, downmixed, back to int16); every transcript ({chars} chars) equals '
                f'its padded array put through forward.fused_i16 directly; hand-kernel launches '
                f'per served forward {per_forward}; card: {card}')
            if quantized:
                log(f'check: serve int8: the 32 convs and 12 GEMMs of one served B1 forward '
                    f'bit-equal to their plain versions; shapes {dict(b1_shapes)}')

            # 8 concurrent requests, twice, through the DynamicBatcher
            servicer.batcher = batcher
            bspy = ForwardSpy(batcher.forward_fused)
            batcher.forward_fused = bspy
            before = (batcher.dispatches, batcher.served)
            reset_int8_counts(int8)
            latencies = []

            def call(samples):
                tic = time.perf_counter()
                stub(request(samples), timeout=300)
                return time.perf_counter() - tic
            try:
                with concurrent.futures.ThreadPoolExecutor(8) as pool:
                    for lo in (0, 8):
                        latencies += list(pool.map(call, burst[lo:lo + 8]))
            finally:
                batcher.forward_fused = bspy.fn
            dispatches = batcher.dispatches - before[0]
            served = batcher.served - before[1]
            launches = int8_counts(int8)
            rows = {row.tobytes(): (xlen[i], packed[i]) for x, xlen, packed in bspy.calls
                    for i, row in enumerate(x)}
            under = differ = 0
            for samples in burst:
                padded = np.zeros((1, 6 * SR), np.int16)
                padded[0, :len(samples)] = samples
                xlen, batched = rows[padded[0].tobytes()]
                with torch.inference_mode():
                    alone = forward.fused_i16(torch.from_numpy(padded),
                                              torch.tensor([xlen])).cpu().numpy()[0]
                    lp = forward(torch.from_numpy(padded.astype(np.float32) / 32767.0),
                                 torch.tensor([xlen]))[0].float().cpu().numpy()[0]
                top2 = np.sort(lp, axis=-1)[:, -2:]
                clear = top2[:, 1] - top2[:, 0] > 1e-3
                under += int((~clear).sum())
                differ += int((batched[~clear, 0] != alone[~clear, 0]).sum())
                assert np.array_equal(batched[clear, 0], alone[clear, 0]), \
                    f'{label}: a batched row\'s ids differ from its B1 forward\'s'
            if quantized:
                assert launches['int8_conv_wgmma'] == 32 * dispatches, (launches, dispatches)
                total.update(launches)
            log(f'serve [{label}] Recognize, 8 concurrent x 2 through the DynamicBatcher '
                f'(--batch-window-ms 5, rows padded to B8): latency {percentiles_ms(latencies)}; '
                f'{dispatches} forwards for {served} requests; every row\'s ids equal its B1 '
                f'forward\'s at the frames whose top-2 log-prob gap exceeds 1e-3 ({under} frames '
                f'of {len(burst) * batched.shape[0]} under it, {differ} of them differ); '
                f'hand-kernel launches {({k: v for k, v in launches.items() if v})}')

            # streams: the two mixtures' first 12 s twice (4 streams) on the
            # engine's 4 slots, and the same 4 once more, past the slots, per
            # stream (12 s of the 48: the whole script's time limit)
            ticks, spills = engine.ticks, servicer.spills
            reset_int8_counts(int8)
            chunk = int(0.32 * SR)
            audio = [mixes[k % 2][:STREAM_SECONDS * SR] for k in range(8)]
            results, gate = {}, threading.Barrier(8, timeout=120)

            def stream(k):
                def requests():
                    yield pb2.StreamingRecognizeRequest(streaming_config=dict(
                        config=dict(encoding=pb2.RecognitionConfig.LINEAR16,
                                    sample_rate_hertz=SR, audio_channel_count=1),
                        interim_results=True))
                    gate.wait()
                    for lo in range(0, len(audio[k]), chunk):
                        yield pb2.StreamingRecognizeRequest(
                            audio_content=audio[k][lo:lo + chunk].astype('<i2').tobytes())
                t0 = time.perf_counter()
                out = [(time.perf_counter() - t0, r) for resp in streaming_stub(
                    requests(), timeout=600) for r in resp.results]
                results[k] = (time.perf_counter() - t0, out)

            tic = time.perf_counter()
            threads = [threading.Thread(target=stream, args=(k,)) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - tic
            assert not any(t.is_alive() for t in threads) and len(results) == 8
            launches = int8_counts(int8)
            if quantized:
                total.update(launches)
            assert servicer.spills - spills == 4, servicer.spills - spills
            # each stream's server thread frees its slot once the client has
            # seen the stream end
            deadline = time.perf_counter() + 30
            while engine.sessions and time.perf_counter() < deadline:
                time.sleep(0.01)
            assert not engine.sessions and sorted(engine._free) == [0, 1, 2, 3]
            finals = {k: ''.join(r.alternatives[0].transcript for _, r in out if r.is_final)
                      for k, (_, out) in results.items()}
            assert all(finals.values()), finals
            log(f'serve [{label}] StreamingRecognize: 8 streams of the mixtures\' first '
                f'{STREAM_SECONDS} s at 0.32 s '
                f'chunks, sent as fast as the server takes them, in {wall:.1f} s: 4 on the '
                f'batched engine ({engine.ticks - ticks} ticks), 4 past its slots per stream '
                f'(logged); final chars a stream {[len(v) for v in finals.values()]}; last '
                f'result at {[round(max(t for t, _ in out), 1) for _, out in results.values()]} '
                f's; hand-kernel launches {({k: v for k, v in launches.items() if v})}')

            # the fused tick against the legacy one, and its time, with the
            # ticker held off by the engine's lock and all 4 slots fed
            with engine.lock:
                sessions = [engine.open(servicer.text_pipeline.tokenizer, lookahead_sec=1.5)
                            for _ in range(4)]
                apply_lp, get_weights = forward.stream_logprobs()
                ones = torch.ones(4, device=engine.device)
                for t in range(3):
                    for k, s in enumerate(sessions):
                        s.accept(mixes[k % 2][t * chunk:(t + 1) * chunk] / 32767.0)
                    engine.tick()
                with torch.inference_mode():
                    lp = apply_lp(get_weights(), engine._buf, ones)
                    legacy_ids = lp.argmax(-1)[:, -engine.tail_frames:].to(torch.uint8)
                    zero = torch.zeros((4, engine.chunk), dtype=torch.int16,
                                       device=engine.device)
                    no = torch.zeros(4, dtype=torch.bool, device=engine.device)
                    capture = Int8Capture(int8) if quantized else contextlib.nullcontext()
                    with capture:
                        _, tail = engine._tick_fused(engine._buf, None, zero, no, no)
                    assert torch.equal(tail, legacy_ids), \
                        f'{label}: the fused tick\'s ids differ from the legacy argmax'
                if quantized:
                    n4_shapes = check_int8_calls(int8, capture.captured, 'N4 tick')
                tick_ms = []
                for t in range(3, 23):
                    for k, s in enumerate(sessions):
                        s.accept(mixes[k % 2][t * chunk:(t + 1) * chunk] / 32767.0)
                    torch.cuda.synchronize()
                    tic = time.perf_counter()
                    engine.tick()
                    tick_ms.append((time.perf_counter() - tic) * 1e3)
                    for s in sessions:
                        s.drain()
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    tic = time.perf_counter()
                    for t in range(23, 33):
                        for k, s in enumerate(sessions):
                            s.accept(mixes[k % 2][t * chunk:(t + 1) * chunk] / 32767.0)
                        engine.tick()
                    prof_wall = (time.perf_counter() - tic) * 1e3 / 10
                card_ms = sum(e.self_device_time_total for e in prof.key_averages()
                              if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / 10
                for s in sessions:
                    engine.release(s.slot)
            tick = float(np.median(tick_ms))
            share = f'{card_ms / tick:.1%}' if card_ms else 'not measured'
            log(f'serve [{label}] batched engine tick, N4 x (4, {engine.window}) window, '
                f'0.32 s chunks: {np.min(tick_ms):.2f} / {tick:.2f} / {np.max(tick_ms):.2f} ms '
                f'(min / median / max of 20, host clock, ending in its read-back); card time '
                f'{card_ms:.2f} ms a tick by torch.profiler ({prof_wall:.2f} ms wall under it): '
                f'card {share}, host the rest; at one tick back to back the card serves '
                f'{4 * 320 / tick:.0f} streams at 0.32 s chunks (4 x 320 ms / {tick:.2f} ms); the '
                f'fused tick\'s uint8 ids equal the argmax of the legacy tick\'s full-window '
                f'log-probs on the same (4, {engine.window}) ring; card: {card}')
            if quantized:
                log(f'check: serve int8: the 32 convs and 12 GEMMs of one N4 tick bit-equal to '
                    f'their plain versions; shapes {dict(n4_shapes)}')
        finally:
            channel.close()
            serving.stop(0)
            del serving, servicer, forward, engine, batcher
            gc.collect()
            torch.cuda.empty_cache()

    # the --decoder branch: Recognize decoded by the host C++ beam, and
    # streams with beam finals from the engine's top-k tail (packed u8), the
    # carried device-beam interims, over the mu-law transport
    args = api.build_parser().parse_args(
        ['--checkpoint', ckpt, '--device', 'cuda', '--endpoint', '127.0.0.1:0',
         '--decoder', 'BeamSearchDecoder', '--beam-width', '16', '--beam-cutoff-top-n', '8',
         '--streaming-slots', '2', '--streaming-transport', 'mulaw',
         '--streaming-beam-interim', '8', '--warmup-sec', '1'])
    serving = api.start(args, log=lambda *a: None)
    servicer, forward, engine = serving.servicer, serving.servicer.forward, \
        serving.servicer.stream_engine
    channel = grpc.insecure_channel(serving.endpoint)
    try:
        stub, streaming_stub = api.make_client_stub(channel), api.make_streaming_stub(channel)
        beam_lat = []
        for samples in unary[:3]:
            tic = time.perf_counter()
            response = stub(request(samples), timeout=300)
            beam_lat.append(time.perf_counter() - tic)
            padded = np.zeros((1, 6 * SR), np.float32)
            padded[0, :len(samples)] = samples / 32767.0
            lp, _, olen = forward(torch.from_numpy(padded), torch.ones(1))
            [tokens] = servicer.decoder.decode(lp.float().cpu().numpy(),
                                               output_lengths=olen.cpu().numpy())
            [text] = servicer.text_pipeline.decode([tokens])
            assert response.results[0].alternatives[0].transcript == ' '.join(
                servicer.text_pipeline.postprocess(text).split()), 'beam Recognize'
        seconds, chunk = 12, int(0.32 * SR)
        results = {}

        def beam_stream(k):
            def requests():
                yield pb2.StreamingRecognizeRequest(streaming_config=dict(
                    config=dict(encoding=pb2.RecognitionConfig.LINEAR16,
                                sample_rate_hertz=SR, audio_channel_count=1),
                    interim_results=True))
                audio = mixes[k][:seconds * SR]
                for lo in range(0, len(audio), chunk):
                    time.sleep(0.32)             # real time: ticks deliver between chunks
                    yield pb2.StreamingRecognizeRequest(
                        audio_content=audio[lo:lo + chunk].astype('<i2').tobytes())
            results[k] = [r for resp in streaming_stub(requests(), timeout=600)
                          for r in resp.results]

        ticks = engine.ticks
        tic = time.perf_counter()
        threads = [threading.Thread(target=beam_stream, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - tic
        assert not any(t.is_alive() for t in threads) and len(results) == 2
        assert servicer.stream_beam and engine._beam_pack_u8 and engine.beam_interim_width == 8
        assert servicer.spills == 0 and engine.ticks > ticks
        interims = [sum(not r.is_final for r in out) for out in results.values()]
        finals = [''.join(r.alternatives[0].transcript for r in out if r.is_final)
                  for out in results.values()]
        assert all(interims), interims
        log(f'serve [beam] --decoder BeamSearchDecoder (host C++ beam, width 16, bf16): '
            f'Recognize of 6 s {percentiles_ms(beam_lat)}, each transcript the beam\'s on the '
            f'served log-probs; 2 streams of {seconds} s over mu-law on the engine in '
            f'{wall:.1f} s, in real time ({engine.ticks - ticks} ticks): beam finals from the '
            f'packed u8 '
            f'top-8 tail, {interims} interim results carried by the device beam (width 8), '
            f'final chars {[len(f) for f in finals]}; card: {card}')
    finally:
        channel.close()
        serving.stop(0)
        del serving, servicer, forward, engine
        gc.collect()
        torch.cuda.empty_cache()

    # cli/benchmark_online at full width, bf16: unary at --rps 5, and 16
    # real-time streams on the batched engine
    for label, flags in (('unary', ['--rps', '5']),
                         ('streaming', ['--streaming', '--streams', '16',
                                        '--streaming-engine', 'batched'])):
        args = benchmark_online.build_parser().parse_args(
            ['--device', 'cuda', '--checkpoint', ckpt, '--benchmark-duration',
             str(ONLINE_SECONDS)] + flags)
        printed = io.StringIO()
        tic = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            lat = benchmark_online.main(args)
        torch.cuda.synchronize()
        assert np.isfinite(lat).all() and len(lat), label
        text = printed.getvalue()
        (out_dir / f'benchmark_online_{label}.log').write_text(text)
        log(f'benchmark_online [{label}] {" ".join(flags)} ({ONLINE_SECONDS} s, JasperNetBig bf16, '
            f'{time.perf_counter() - tic:.1f} s wall): '
            + ' | '.join(l for l in text.splitlines() if not l.startswith('warming'))
            + f'; card: {card}')
    return dict(total)


# -- 19. the device cache, several processes, the learned frontends -----------

def _jobs(target, jobs):
    """One spawned process of phases 19-20: target(*args) for each args of
    `jobs`, one after the other, so that the runs share one process start;
    each run's memory is freed before the next."""
    for args in jobs:
        target(*args)
        gc.collect()
        torch.cuda.empty_cache()


def _rank_main(argv, out_path):
    """One rank of phase 19's two-process train: the port's cli/train.main
    with its step times and its CTC kernels' launches written to out_path."""
    sys.path.insert(0, str(ROOT))
    from convasr_tpu_torch.cli import train as train_cli
    from convasr_tpu_torch.ops import align, ctc_loss
    times, make_step = [], train_cli.make_train_step

    def timed_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def timed(state, batch, generator=None):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            metrics = step(state, batch, generator)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - tic)
            return metrics
        return timed
    train_cli.make_train_step = timed_make_step
    ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0
    try:
        with CTCCapture(ctc_loss, align) as capture:
            train_cli.main(train_cli.build_parser().parse_args(argv))
            torch.cuda.synchronize()
    finally:
        train_cli.make_train_step = make_step
    launches = dict(ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                    ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
                    ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES)
    checked = check_ctc_calls(capture.calls, f'rank {argv[argv.index("--process-id") + 1]}\'s '
                              f'first train step')
    with open(out_path, 'w') as f:
        json.dump(dict(times=times, launches=launches, checked=checked), f)


def json_outputs(out_dir):
    """Every .json a transcribe run wrote, by name."""
    return {o: json.load(open(os.path.join(out_dir, o))) for o in sorted(os.listdir(out_dir))
            if o.endswith('.json')}


def data_parallel_phase(ckpt, corpus, work, device=torch.device('cuda', 0)):
    """Phase 19.4: transcribe --data-parallel with --align and with the
    device beam, first over the one visible card (the single-device path:
    the outputs bit-equal to phase 2's and phase 11's runs), then over a
    device list that names the card three times, as the CPU tests name the
    CPU twice: phase 2's batches of 8 rows are padded to 9, split into one
    chunk of 3 a device (mesh.split_rows), and the device beam's rows go
    through beam_device.beam_search_device_sharded. There the first forward
    and the first beam are held bit-equal to their chunks run one by one
    (the padding, split and gather), and against the whole batch run at
    once: the forward within a bound, the beam's tokens counted. Returns
    the alignment kernels' launches."""
    from convasr_tpu_torch.cli import transcribe
    from convasr_tpu_torch.ops import align, beam_device, ctc_loss
    from convasr_tpu_torch.parallel import mesh
    split_rows, sharded_beam = mesh.split_rows, beam_device.beam_search_device_sharded
    inference_devices = mesh.inference_devices
    calls, kept = collections.Counter(), {}

    def counted_split_rows(fn, devices, x, xlen):
        calls[f'split_rows over {len(devices)}'] += 1
        out = split_rows(fn, devices, x, xlen)
        kept.setdefault('forward', (fn, devices, x.clone(), xlen.clone(),
                                    tuple(o.clone() for o in out)))
        return out

    def counted_sharded_beam(log_probs, lengths, blank_id, devices, **kw):
        calls['sharded beam'] += 1
        out = sharded_beam(log_probs, lengths, blank_id, devices, **kw)
        lp = torch.as_tensor(log_probs)
        kept.setdefault('beam', (lp.clone(), torch.as_tensor(lengths).to(lp.device, torch.int32),
                                 blank_id, devices, kw, tuple(o.clone() for o in out)))
        return out

    def chunked(run, n, arrays, fill):
        """run(k, chunk k of each array) over n chunks of the arrays padded
        to a multiple of n rows with `fill`, concatenated and sliced back:
        what split_rows and the sharded beam promise, restated."""
        B = arrays[0].shape[0]
        padded = [torch.cat([a, torch.full((-B % n,) + tuple(a.shape[1:]), v, dtype=a.dtype,
                                           device=a.device)]) for a, v in zip(arrays, fill)]
        rows = padded[0].shape[0] // n
        outs = [run(k, *(a[k * rows:(k + 1) * rows] for a in padded)) for k in range(n)]
        return tuple(torch.cat([o[j] for o in outs])[:B] for j in range(len(outs[0])))

    launches = collections.Counter()
    for n_devices in (1, 3):
        for label, flags, ref_dir in (
                ('--align', ['--align'], WORK / 'transcribe'),
                ('--decoder BeamSearchDecoderDevice', ['--decoder', 'BeamSearchDecoderDevice',
                                                       '--beam-width', '16', '--beam-cutoff-top-n',
                                                       '8', '--lm', str(WORK / 'char2.arpa')],
                 WORK / 'transcribe_BeamSearchDecoderDevice')):
            out_dir = work / f'dp{n_devices}_{flags[0].strip("-")}'
            align.WARP_LAUNCHES = align.BLOCK_LAUNCHES = 0
            calls.clear()
            kept.clear()
            mesh.split_rows, beam_device.beam_search_device_sharded = counted_split_rows, \
                counted_sharded_beam
            if n_devices > 1:
                mesh.inference_devices = lambda _: [device] * n_devices
            tic = time.perf_counter()
            try:
                with CTCCapture(ctc_loss, align) as capture:
                    transcribe.main(transcribe.build_parser().parse_args(
                        ['--checkpoint', ckpt, '-i', corpus, '-o', str(out_dir), '--device',
                         device.type, '--output-json', '--mono', '--data-parallel'] + flags))
                    torch.cuda.synchronize()
            finally:
                mesh.split_rows, beam_device.beam_search_device_sharded = split_rows, \
                    sharded_beam
                mesh.inference_devices = inference_devices
            wall = time.perf_counter() - tic
            run = dict(ctc_viterbi_align_warp=align.WARP_LAUNCHES,
                       ctc_viterbi_align=align.BLOCK_LAUNCHES)
            launches.update(run)
            sharded = n_devices > 1 and flags[0] != '--align'
            assert calls[f'split_rows over {n_devices}'] > 0 and \
                (calls['sharded beam'] > 0) == sharded, (label, dict(calls))
            got, want = json_outputs(out_dir), json_outputs(ref_dir)
            assert sorted(got) == sorted(want) and all(
                len(got[o]) == len(want[o]) for o in got), label
            same = sum(g == w for o in got for g, w in zip(got[o], want[o]))
            n_segments = sum(len(v) for v in got.values())
            text = (f'transcribe --data-parallel {label} over {n_devices} device(s) on '
                    f'{torch.cuda.device_count()} card(s): {wall:.2f} s wall; calls '
                    f'{dict(calls)}; launches {run}')
            if n_devices == 1:
                assert got == want, f'transcribe --data-parallel {label} differs from no flag'
                text += f'; {len(got)} output files bit-equal to the run without the flag'
            else:
                # the first forward: bit-equal to its chunks run one by one;
                # against the whole batch at once, cuDNN picks other
                # algorithms for 3 rows than for 8, so the bf16 log-probs
                # differ by rounding: measured, and the segments (with
                # --align, their times too) counted against no flag
                fn, devices, x, xlen, out = kept['forward']
                with torch.inference_mode():
                    by_chunk = chunked(fn, len(devices), (x, xlen), fill=(0, 1))
                    whole = fn(0, x, xlen)
                assert all(torch.equal(a, b) for a, b in zip(out, by_chunk)), \
                    f'{label}: the split forward differs from its chunks run one by one'
                assert torch.equal(out[2], whole[2]), f'{label}: olen differs'
                lp_diff = float((out[0].float() - whole[0].float()).abs().max())
                ids = float((out[0].argmax(-1) == whole[0].argmax(-1)).float().mean())
                text += (f'; the first forward (B{x.shape[0]} padded to '
                         f'{-(-x.shape[0] // n_devices) * n_devices}) bit-equal to its chunks '
                         f'run one by one, its log-probs within {lp_diff:.3e} of the whole '
                         f'batch at once ({ids:.4f} of the frames\' argmax equal); {same} of '
                         f'{n_segments} segments equal to the run without the flag')
                if sharded:
                    lp, lengths, blank, devices, kw, out = kept['beam']
                    # the beam's padding rows have length 0
                    by_chunk = chunked(lambda k, a, b: beam_device.beam_search_device(
                        a, b, blank, **kw), len(devices), (lp, lengths), fill=(0, 0))
                    assert all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(out, by_chunk)), \
                        f'{label}: the sharded beam differs from its chunks run one by one'
                    whole = beam_device.beam_search_device(lp, lengths, blank, **kw)
                    # each row's best beam: its length and tokens
                    best = [(out[1][b, 0].item(), whole[1][b, 0].item()) for b in range(len(lp))]
                    rows = sum(n == m and torch.equal(out[0][b, 0, :n].cpu(),
                                                      whole[0][b, 0, :n].cpu())
                               for b, (n, m) in enumerate(best))
                    text += (f'; the first sharded beam (B{lp.shape[0]}) bit-equal to its '
                             f'chunks run one by one, {rows} of {lp.shape[0]} rows\' best '
                             f'beams equal to the whole batch\'s')
            if flags[0] == '--align':
                assert run['ctc_viterbi_align_warp'] > 0, run
                text += '; ' + check_ctc_calls(capture.calls, 'its first alignment',
                                               expect=('viterbi',))
            log(text)
    return dict(launches)


def multi_phases(device, ckpt, corpus, card):
    """Phase 19: train --device-cache against streaming, two train processes
    on the one card (Gloo) against one, NCCL at world 1, transcribe
    --data-parallel against phases 2 and 11, the wav2vec frontend (train,
    transcribe, int8) and the neural VAD. Returns the hand kernels' launches
    on these paths."""
    import multiprocessing
    import torch.distributed as dist
    from convasr_tpu_torch.audio import neural_vad
    from convasr_tpu_torch.audio.vad import detect_speech
    from convasr_tpu_torch.cli import train as train_cli
    from convasr_tpu_torch.cli import transcribe
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend, full_fp32
    from convasr_tpu_torch.frontend.wav2vec import (Wav2VecFrontend, convert_fairseq_checkpoint,
                                                    fairseq_state_dict)
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.ops import align, ctc_loss, int8
    from convasr_tpu_torch.parallel import mesh
    from convasr_tpu_torch.train.checkpoints import load_train_checkpoint

    work = WORK / 'phase19'
    work.mkdir(parents=True, exist_ok=True)
    total = collections.Counter()
    configs = ['--text-config', str(ROOT / 'configs' / 'ru_text_config.json'),
               '--val-config', str(ROOT / 'configs' / 'ru_val_config.json')]

    def ctc_counts():
        return dict(ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                    ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
                    ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES)

    def train(name, manifest, steps, *extra, check=False):
        """cli/train.main from phase 2's checkpoint, float32, 32 rows a step;
        returns the logged losses, the step seconds, the launches, the log.
        With `check`, the first step's CTC kernels are held against their
        plain versions."""
        times, make_step = [], train_cli.make_train_step

        def timed_make_step(*a, **kw):
            step = make_step(*a, **kw)

            def timed(state, batch, generator=None):
                torch.cuda.synchronize()
                tic = time.perf_counter()
                metrics = step(state, batch, generator)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - tic)
                return metrics
            return timed
        args = train_cli.build_parser().parse_args(
            ['--train-data-path', manifest, '--experiments-dir', str(work), '--experiment-id',
             name, '--checkpoint', ckpt, '--bf16', 'false', '--train-batch-size', '32',
             '--iterations', str(steps), '--val-iteration-interval', '0',
             '--log-iteration-interval', '1', '--epochs', '10', '--checkpoint-skip',
             '--num-workers', '4'] + configs + list(extra))
        train_cli.make_train_step = timed_make_step
        ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = 0
        ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0
        try:
            with CTCCapture(ctc_loss, align) as capture:
                train_cli.main(args)
                torch.cuda.synchronize()
        finally:
            train_cli.make_train_step = make_step
        launches = ctc_counts()
        if check:
            log(check_ctc_calls(capture.calls, f'train {" ".join(extra)}\'s first step'))
        assert launches == dict(ctc_loss_alpha=steps, ctc_loss_beta_grad_warp=steps,
                                ctc_loss_beta_grad=0), f'{name}: CTC launches {launches}'
        total.update(launches)
        losses = [json.loads(line)['loss'] for line in open(work / name / 'log.json')]
        assert len(losses) == steps and np.isfinite(losses).all(), (name, losses)
        return losses, times, launches, (work / name / 'log.txt').read_text()

    def spread(a, b):
        return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))

    # 19.1 --device-cache against streaming on phase 5's corpus, 6 float32
    # steps each, in turns. The cache pads a row to its bucket's longest,
    # streaming to its batch's: the sampler fills each batch of a bucket up
    # to 32 rows by resampling, so on this corpus the two are one length and
    # the JAX spec's equality holds (rtol 1e-5 / atol 1e-6). cuDNN's
    # deterministic algorithms, as in phase 16's check: its default float32
    # backward moved two streaming runs apart by up to 2.2e-5
    p5_json = str(WORK / 'train.json')
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, extra in (('stream', ()), ('cache', ('--device-cache',)),
                            ('cache_k2', ('--device-cache', '--steps-per-dispatch', '2')),
                            ('stream2', ())):
            runs[name] = train(name, p5_json, 6, *extra, check=name == 'cache')
    finally:
        torch.backends.cudnn.deterministic = deterministic
    noise = spread(runs['stream2'][0], runs['stream'][0])
    for name in ('cache', 'cache_k2'):
        losses, _, _, text = runs[name]
        assert '--device-cache disabled' not in text and 'replicated on cuda' in text, text[-2000:]
        np.testing.assert_allclose(losses, runs['stream'][0], rtol=1e-5, atol=1e-6,
                                   err_msg=f'{name} vs streaming (streaming run to run '
                                           f'{noise:.2e})')
    cache_line = next(line for line in runs['cache'][3].splitlines()
                      if 'device cache: ' in line and ' bytes' in line)
    med = {k: statistics.median(runs[k][1][2:]) * 1e3 for k in runs}
    log(f'train --device-cache (replicated) vs streaming, JasperNetBig float32 (cuDNN '
        f'deterministic), 6 steps of 32 rows of phase 5\'s corpus: per-step losses {[round(v, 5) for v in runs["stream"][0]]}; '
        f'cache vs streaming max relative spread {spread(runs["cache"][0], runs["stream"][0]):.2e}'
        f', --steps-per-dispatch 2 {spread(runs["cache_k2"][0], runs["stream"][0]):.2e}, '
        f'streaming run to run {noise:.2e} (rtol 1e-5 / atol 1e-6 held); '
        f'{cache_line.split("train: ")[-1]}; median step of steps 3-6, in turns: streaming '
        f'{med["stream"]:.1f} / {med["stream2"]:.1f} ms, cache {med["cache"]:.1f} / '
        f'--steps-per-dispatch 2 {med["cache_k2"]:.1f} ms; steps ms streaming '
        f'{[round(t * 1e3, 1) for t in runs["stream"][1]]}, cache '
        f'{[round(t * 1e3, 1) for t in runs["cache"][1]]}; launches a run {runs["cache"][2]}')

    # 19.2 two processes on the one card, Gloo, global batch 32 (16 a rank),
    # 3 float32 steps, streaming and then the sharded cache, against one
    # process; dropout and dither off (each rank draws its own)
    quiet = ('--dropout', '0', '--dither', '0')
    single = train('single', p5_json, 3, *quiet)
    gc.collect()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context('spawn')
    layouts = ('streaming', 'sharded')

    def argv(layout):
        extra = ['--device-cache', '--device-cache-layout', 'sharded'] \
            if layout == 'sharded' else []
        return ['--train-data-path', p5_json, '--experiments-dir', str(work), '--experiment-id',
                f'mp_{layout}', '--checkpoint', ckpt, '--bf16', 'false', '--train-batch-size',
                '32', '--iterations', '3', '--val-iteration-interval', '0',
                '--log-iteration-interval', '1', '--epochs', '10', '--checkpoint-skip',
                '--num-workers', '2', '--num-processes', '2', '--backend', 'gloo',
                '--synchronization-timeout', '300', '--coordinator-address',
                f'file://{work}/rdv_{layout}'] + configs + list(quiet) + extra
    # one spawn of two ranks runs both layouts, one after the other
    tic = time.perf_counter()
    procs = [ctx.Process(target=_jobs, args=(_rank_main, [
        (argv(layout) + ['--process-id', str(r)], str(work / f'mp_{layout}_r{r}.json'))
        for layout in layouts])) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=900)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert [p.exitcode for p in procs] == [0, 0], f'19.2: exit codes ' \
        f'{[p.exitcode for p in procs]}'
    wall = time.perf_counter() - tic
    for layout in layouts:
        name = f'mp_{layout}'
        ranks = [json.load(open(work / f'{name}_r{r}.json')) for r in range(2)]
        for r, rank in enumerate(ranks):
            losses = [json.loads(line)['loss'] for line in open(work / name / f'log.node{r}.json')]
            np.testing.assert_allclose(losses, single[0], rtol=1e-4,
                                       err_msg=f'{name} rank {r} vs one process')
            assert rank['launches'] == dict(ctc_loss_alpha=3, ctc_loss_beta_grad_warp=3,
                                            ctc_loss_beta_grad=0), rank['launches']
            total.update(rank['launches'])
            log(rank['checked'] + f' ({layout})')
        if layout == 'sharded':
            assert 'sharded on cuda' in (work / name / 'log.node1.txt').read_text()
        log(f'train --num-processes 2 on {card.split(",")[0]} (Gloo, both ranks on cuda:0, '
            f'{layout}), 3 float32 steps of 2 x 16 rows: losses '
            f'{[round(v, 5) for v in losses]} vs one process {[round(v, 5) for v in single[0]]} '
            f'(rtol 1e-4 held; relative spread {spread(losses, single[0]):.2e}); step ms rank 0 '
            f'{[round(t * 1e3) for t in ranks[0]["times"]]}, rank 1 '
            f'{[round(t * 1e3) for t in ranks[1]["times"]]} (one process '
            f'{[round(t * 1e3) for t in single[1]]}); launches a rank {ranks[0]["launches"]}; '
            f'wall of both layouts {wall:.1f} s incl. one start of two processes')

    # 19.3 NCCL at world 1 on the card
    backend = mesh.init_distributed(f'file://{work}/rdv_nccl', 1, 0, timeout=120,
                                    device=torch.device('cuda', 0))
    try:
        t = torch.arange(8.0, device=device)
        dist.all_reduce(t)
        gathered = mesh.allgather_bytes(b'convasr')
        torch.cuda.synchronize()
        assert backend == 'nccl' and torch.equal(t.cpu(), torch.arange(8.0)) \
            and gathered == [b'convasr'], (backend, gathered)
    finally:
        mesh.shutdown()
    log(f'check: init_distributed at world 1 chose {backend}; one all_reduce on the card and one '
        f'allgather_bytes ({gathered}) returned their inputs')

    # 19.4 --data-parallel
    total.update(data_parallel_phase(ckpt, corpus, work))

    # 19.5 wav2vec: a seeded fairseq-layout checkpoint (512 channels, the
    # fairseq v1 layers), 4 steps at full JasperNetBig width (bf16), then 2
    # with --freeze-frontend
    w2v_pt = work / 'w2v_fairseq.pt'
    sd = fairseq_state_dict(0)
    torch.save(dict(model=sd), w2v_pt)
    converted = convert_fairseq_checkpoint(str(w2v_pt))
    w2v_runs = {}
    for name, steps, extra in (('w2v', 4, ()), ('w2v_frozen', 2, ('--freeze-frontend',))):
        ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = 0
        ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0
        tic = time.perf_counter()
        with CTCCapture(ctc_loss, align) as capture:
            train_cli.main(train_cli.build_parser().parse_args(
                ['--train-data-path', p5_json, '--experiments-dir', str(work), '--experiment-id',
                 name, '--frontend', 'Wav2VecFrontend', '--frontend-checkpoint', str(w2v_pt),
                 '--num-input-features', '512', '--train-batch-size', '16', '--iterations',
                 str(steps), '--val-iteration-interval', str(steps), '--log-iteration-interval',
                 '1', '--epochs', '10', '--num-workers', '4'] + configs + list(extra)))
            torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        launches = ctc_counts()
        assert launches == dict(ctc_loss_alpha=steps, ctc_loss_beta_grad_warp=steps,
                                ctc_loss_beta_grad=0), f'{name}: {launches}'
        total.update(launches)
        [path] = sorted((work / name).glob(f'checkpoint_*_iter{steps:07d}.pt'))
        state = load_train_checkpoint(str(path))['model_state_dict']
        same = all(torch.equal(state['frontend.' + k], v) for k, v in converted.items())
        assert same == (name == 'w2v_frozen'), f'{name}: frontend weights unchanged: {same}'
        losses = [json.loads(line)['loss'] for line in open(work / name / 'log.json')]
        assert np.isfinite(losses).all(), losses
        w2v_runs[name] = path
        log(f'train --frontend Wav2VecFrontend --frontend-checkpoint {" ".join(extra)}: '
            f'JasperNetBig (512 input features) bf16, {steps} steps of 16 rows of phase 5\'s '
            f'corpus in {wall:.1f} s wall; losses {[round(v, 3) for v in losses]}; frontend '
            f'weights equal to the fairseq ones: {same}; launches {launches}')
        if name == 'w2v':
            log(check_ctc_calls(capture.calls, 'the wav2vec train\'s first step'))
    w2v_ckpt = str(w2v_runs['w2v'])
    align.WARP_LAUNCHES = align.BLOCK_LAUNCHES = 0
    out_dir = work / 'w2v_transcribe'
    tic = time.perf_counter()
    with CTCCapture(ctc_loss, align) as capture:
        transcribe.main(transcribe.build_parser().parse_args(
            ['--checkpoint', w2v_ckpt, '-i', corpus, '-o', str(out_dir), '--device', 'cuda',
             '--align', '--output-json', '--mono']))
        torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    segments = [s for o in json_outputs(out_dir).values() for s in o]
    assert segments and all(np.isfinite([s['begin'], s['end'], s['cer']]).all()
                            for s in segments)
    launches = dict(ctc_viterbi_align_warp=align.WARP_LAUNCHES,
                    ctc_viterbi_align=align.BLOCK_LAUNCHES)
    assert launches['ctc_viterbi_align_warp'] > 0, launches
    total.update(launches)
    log(f'transcribe --align on the wav2vec checkpoint (bf16): {len(segments)} segments in '
        f'{wall:.2f} s wall; launches {launches}')
    log(check_ctc_calls(capture.calls, 'the wav2vec transcribe --align\'s first alignment',
                        expect=('viterbi',)))
    # float32 log-probs, card vs CPU
    w2v_state = load_train_checkpoint(w2v_ckpt)['model_state_dict']

    def w2v_model():
        m = create_model('JasperNetBig', num_input_features=512, num_classes=(38,),
                         frontend=Wav2VecFrontend())
        m.load_state_dict(w2v_state)
        return m.eval()
    cpu_w2v = w2v_model()
    card_w2v = w2v_model().to(device)
    x = torch.from_numpy((0.1 * np.random.RandomState(2).randn(2, SR)).astype(np.float32))
    xlen = torch.tensor([1.0, 0.7])
    with torch.inference_mode():
        on_card = card_w2v(x.to(device), xlen=xlen.to(device))['log_probs'][0].cpu()
        on_cpu = cpu_w2v(x, xlen=xlen)['log_probs'][0]
    diff = float((on_card - on_cpu).abs().max())
    assert torch.isfinite(on_card).all() and diff < 1e-3, f'wav2vec card vs CPU differ by {diff}'
    del cpu_w2v
    log(f'check: the wav2vec JasperNetBig float32 log-probs card vs CPU max |diff| {diff:.2e} '
        f'(< 1e-3), shape {tuple(on_card.shape)}')
    # --quantize int8: every conv and GEMM bit-equal to its plain version
    reset_int8_counts(int8)
    out_dir = work / 'w2v_int8'
    tic = time.perf_counter()
    with Int8Capture(int8) as capture:
        transcribe.main(transcribe.build_parser().parse_args(
            ['--checkpoint', w2v_ckpt, '-i', corpus, '-o', str(out_dir), '--device', 'cuda',
             '--quantize', 'int8', '--output-json', '--mono']))
        torch.cuda.synchronize()
    wall = time.perf_counter() - tic
    launches = int8_counts(int8)
    assert launches['int8_conv_wgmma'] > 0 and launches['int8_gemm_wgmma'] > 0, launches
    shapes = check_int8_calls(int8, capture.captured, 'phase 19 wav2vec int8')
    total.update(launches)
    log(f'transcribe --quantize int8 on the wav2vec checkpoint: {wall:.2f} s wall; the first '
        f'{len(capture.captured)} int8 convs and GEMMs bit-equal to their plain versions '
        f'({dict(shapes)}); launches {launches}')
    # the forward against the log-mel model's at one B x T, bf16
    B, seconds = 16, 6
    xb = torch.from_numpy((0.1 * np.random.RandomState(3).randn(B, SR * seconds))
                          .astype(np.float32)).to(device)
    ones = torch.ones(B, device=device)
    logmel = create_model('JasperNetBig', num_input_features=64, num_classes=(38,),
                          frontend=LogFilterBankFrontend(64, SR, 0.02, 0.01, dither=0.0),
                          dtype=torch.bfloat16).to(device).eval()
    w2v_bf16 = create_model('JasperNetBig', num_input_features=512, num_classes=(38,),
                            frontend=Wav2VecFrontend(), dtype=torch.bfloat16)
    w2v_bf16.load_state_dict(w2v_state)
    w2v_bf16 = w2v_bf16.to(device).eval()
    timed = {}
    with torch.inference_mode():
        for name in ('logmel', 'w2v', 'w2v', 'logmel'):
            m = logmel if name == 'logmel' else w2v_bf16
            timed.setdefault(name, []).append(cuda_ms(lambda: m(xb, xlen=ones), reps=5))
        with full_fp32():       # as the model runs it
            fe_ms = cuda_ms(lambda: w2v_bf16.frontend(xb), reps=5)
        fe_tf32_ms = cuda_ms(lambda: w2v_bf16.frontend(xb), reps=5)
    log(f'forward B{B} x {seconds} s bf16 on {card.split(",")[0]}: log-mel JasperNetBig '
        f'{min(timed["logmel"]):.2f} / {max(timed["logmel"]):.2f} ms, wav2vec JasperNetBig '
        f'{min(timed["w2v"]):.2f} / {max(timed["w2v"]):.2f} ms, in turns; the wav2vec frontend '
        f'alone in float32 {fe_ms:.2f} ms as the model runs it (cuDNN\'s TF32 off), '
        f'{fe_tf32_ms:.2f} ms with TF32')
    del logmel, w2v_bf16, card_w2v
    gc.collect()
    torch.cuda.empty_cache()

    # 19.6 the neural VAD: trained on the card (its CLI, 300 steps), beating
    # the energy VAD at low SNR, then cutting phase 14's mixtures
    vad_path = str(work / 'vad.npz')
    tic = time.perf_counter()
    neural_vad.main(['--train', vad_path])
    vad_train_s = time.perf_counter() - tic
    vad = neural_vad.NeuralVADModel.load(vad_path)
    assert vad.device.type == 'cuda'
    frame = int(neural_vad.FRAME_SEC * SR)
    sig, lab = neural_vad.synth_batch(np.random.RandomState(99), 8, 3.0, SR)
    acc = neural_vad.frame_accuracy(vad.mask(sig, SR), lab, frame)
    energy = neural_vad.frame_accuracy(detect_speech(sig, SR, window_size=neural_vad.FRAME_SEC,
                                                     backend='energy'), lab, frame)
    assert acc > 0.80 and acc > energy, (acc, energy)
    mixes = [str(WORK / 'vad_in' / f'mix{k}.wav') for k in range(2)]
    out_dir = work / 'neural_vad'
    tic = time.perf_counter()
    transcribe.main(transcribe.build_parser().parse_args(
        ['--checkpoint', ckpt, '-i', *mixes, '-o', str(out_dir), '--device', 'cuda', '--vad', '3',
         '--vad-backend', 'neural', '--vad-model', vad_path, '--diarize', '--output-json',
         '--logits', '--mono']))
    wall = time.perf_counter() - tic
    n_segments = 0
    for mix in mixes:
        name = os.path.basename(mix)
        cuts = [(c['begin'], c['end'])
                for c in json.load(open(out_dir / 'vad_segments' / f'{name}.json'))]
        segments = json.load(open(out_dir / f'{name}.json'))
        npz = np.load(out_dir / f'{name}.npz')
        olen = [len(npz[k]) for k in npz.files if k.startswith('logits_')]
        assert cuts and segments and len(olen) == len(cuts), (name, len(olen), len(cuts))
        # phase 14's slack: a row's last stamp on the batch's frame grid may
        # pass its cut's end by (longest cut) / (most frames of a row - 1)
        slack = max(e - b for b, e in cuts) / (max(olen) - 1) + 1 / SR
        for t in segments:
            assert not t['hyp'] or any(b - 1e-6 <= t['begin'] <= t['end'] <= e + slack
                                       for b, e in cuts), (name, t['begin'], t['end'], slack)
        n_segments += len(segments)
    log(f'neural VAD: trained on the card in {vad_train_s:.1f} s (300 steps); frame accuracy on '
        f'seeded mixtures at 0-25 dB SNR {acc:.3f} vs the energy VAD {energy:.3f}; transcribe '
        f'--vad 3 --vad-backend neural --diarize over phase 14\'s two mixtures: {n_segments} '
        f'segments, each inside a VAD cut, in {wall:.2f} s wall')
    return dict(total)


# -- 20. the tensor-parallel layout ------------------------------------------

def _tp_rank_main(rank, world, ckpt, manifest, rdv, reverse, final_path, out_path,
                  bpe=None):
    """One process of phase 20.1 (spawned): JasperNetBig from phase 2's
    checkpoint, float32, NovoGrad with the clip at 100; at world 2 a rank of
    1 data x 2 model on Gloo with every leaf of 256 channels or more sharded
    (the 38-class head replicated). 3 steps on the same 16 rows of phase 5's
    corpus (in reverse order with `reverse`: the same math, other
    rounding), the first K1f and K1b calls kept and held against their plain
    versions; rank 0 saves the final (gathered) state to final_path. With
    `bpe` (dict(text_config, vocab), phase 20.3): the dual-head JasperNetBig
    of phase 21's checkpoint on both heads' targets, the BPE head's classes
    sharded too, its first K1f and K1b calls (C = vocab) kept."""
    sys.path.insert(0, str(ROOT))
    from convasr_tpu_torch.cli.train import to_host_batch
    from convasr_tpu_torch.data.dataset import AudioTextDataset, frame_count_bucket_fn
    from convasr_tpu_torch.data.sampler import BucketingBatchSampler
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.ops import align, ctc_loss
    from convasr_tpu_torch.parallel import mesh, tensor_parallel
    from convasr_tpu_torch.text import ProcessingPipeline
    from convasr_tpu_torch.train import loop, optim
    device = torch.device('cuda', 0)
    torch.cuda.set_device(device)
    if world > 1:
        mesh.init_distributed(rdv, world, rank, timeout=600, backend='gloo', device=device)
        grid = mesh.make_groups(world)
    classes = (38,) if bpe is None else (38, bpe['vocab'])
    model = create_model('JasperNetBig', num_input_features=64, num_classes=classes,
                         decoder_type=None if bpe is None else 'bpe',
                         frontend=LogFilterBankFrontend(64, SR, 0.02, 0.01, dither=0.0))
    model.load_state_dict(torch.load(ckpt, weights_only=True)['model_state_dict'])
    model.to(device)
    sharded = 0
    if world > 1:
        layout = tensor_parallel.state_shardings(model, world, min_channels=256)
        tensor_parallel.shard_model_(model, layout, grid)
        sharded = sum(d is not None for d in layout.values())
    tx = loop.make_optimizer_with_accum(
        optim.make_optimizer('novograd', optim.multistep_lr(1e-2, 0.1, [25000, 50000]),
                             betas=(0.95, 0.98), weight_decay=1e-3), max_grad_norm=100.0)
    state = loop.init_train_state(model, tx)
    step = loop.make_train_step(model, tx)
    config = ProcessingPipeline.load_config(str(ROOT / 'configs' / 'ru_text_config.json')
                                            if bpe is None else bpe['text_config'])
    pipelines = ['char_legacy'] + ([] if bpe is None else ['bpe'])
    ds = AudioTextDataset(manifest, [ProcessingPipeline.make(config, n) for n in pipelines], SR,
                          time_padding_multiple=128, bucket_fn=frame_count_bucket_fn(0.01, 128),
                          mono=True, pop_meta=True)
    idx = next(iter(BucketingBatchSampler(ds, batch_size=16, world_size=1)))
    _, host = to_host_batch(ds.collate_fn([ds[i] for i in idx]))
    batch = {k: torch.from_numpy(v[::-1].copy() if reverse else v).to(device)
             for k, v in host.items()}
    params = list(model.parameters())

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, (list, tuple)):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0
    times, metrics = [], []
    with CTCCapture(ctc_loss, align, classes=classes[-1]) as capture:
        for _ in range(3):
            torch.cuda.synchronize()
            tic = time.perf_counter()
            m = step(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - tic)
            metrics.append({k: float(v) for k, v in m.items()})
    launches = dict(ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                    ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
                    ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES)
    out = dict(times=times, metrics=metrics, launches=launches, sharded=sharded,
               head_rows=[int(p.shape[0]) for n, p in model.named_parameters()
                          if n == 'decoder.bpe_conv1.conv0.conv.weight'],
               shape=list(batch['x'].shape), target_len=int(batch['y'].shape[-1]),
               n_params=sum(p.numel() for p in params), param_bytes=nbytes(params),
               opt_bytes=nbytes(state.opt_state),
               peak=torch.cuda.max_memory_allocated(),
               checked=check_ctc_calls(capture.calls, f'phase 20.{1 if bpe is None else 3} '
                                       f'{"rank " + str(rank) if world > 1 else "one process"}'
                                       f'\'s first step (C {classes[-1]})'))
    final = tensor_parallel.gather_state(model)
    if rank == 0:
        torch.save({k: v.cpu() for k, v in final.items()}, final_path)
    with open(out_path, 'w') as f:
        json.dump(out, f)
    if world > 1:
        mesh.shutdown(wait=True)


def tp_phases(device, ckpt, card, bpe):
    """Phase 20: the tensor-parallel layout on the card; 20.3 on phase 21's
    dual-head checkpoint (`bpe`: dict(ckpt, text_config, vocab)). Returns
    the hand kernels' launches."""
    import multiprocessing
    work = WORK / 'phase20'
    work.mkdir(parents=True, exist_ok=True)
    total = collections.Counter()
    ctx = multiprocessing.get_context('spawn')
    gc.collect()
    torch.cuda.empty_cache()
    runs, finals = {}, {}

    heads = dict(text_config=bpe['text_config'], vocab=bpe['vocab'])
    # each run: (name, weights, the dual head's text config and vocabulary)
    plan = {1: [('one', ckpt, None), ('reversed', ckpt, None), ('dual_one', bpe['ckpt'], heads)],
            2: [('tp', ckpt, None), ('dual_tp', bpe['ckpt'], heads)]}

    def spawn(world):
        """`world` spawned processes, each running _tp_rank_main for
        plan[world]'s runs one after the other, joined within 900 s: each run's reports in
        runs[name], rank 0's final state in finals[name], the spawn's wall in
        runs[f'wall_{world}']."""
        tic = time.perf_counter()
        procs = [ctx.Process(target=_jobs, args=(_tp_rank_main, [(
            r, world, weights, str(WORK / 'train.json'), f'file://{work}/rdv_{name}',
            name == 'reversed', str(work / f'{name}_final.pt'),
            str(work / f'{name}_r{r}.json'), run_heads) for name, weights, run_heads
            in plan[world]])) for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        assert [p.exitcode for p in procs] == [0] * world, \
            f'20 at world {world}: exit codes {[p.exitcode for p in procs]}'
        runs[f'wall_{world}'] = time.perf_counter() - tic
        for name, _, _ in plan[world]:
            runs[name] = [json.load(open(work / f'{name}_r{r}.json')) for r in range(world)]
            finals[name] = torch.load(work / f'{name}_final.pt', weights_only=True)
            os.remove(work / f'{name}_final.pt')

    # 20.1 one process, then two Gloo ranks on cuda:0 as 1 data x 2 model,
    # then one process on the rows in reverse order: the rounding noise of
    # three NovoGrad steps, which divide each leaf's gradient by its norm.
    # One process start serves the three one-process runs (and 20.3's), one
    # start of two the two-rank runs.
    for world in (1, 2):
        spawn(world)
    one = runs['one'][0]
    # the gathered parameters after 3 steps against one process's: within
    # rtol 1e-3 / atol 1e-5 beyond twice the largest difference that the
    # reversed rows' rounding alone makes (which the report prints)
    floats = [k for k, v in finals['one'].items() if v.is_floating_point()]

    def deviation(name):
        return {k: float((finals[name][k] - finals['one'][k]).abs().max()) for k in floats}
    noise, dev_tp = deviation('reversed'), deviation('tp')
    floor = 2 * max(noise.values())
    outside = [k for k in floats if not torch.allclose(finals['tp'][k], finals['one'][k],
                                                       rtol=1e-3, atol=1e-5 + floor)]
    assert not outside, f'20.1: gathered parameters after 3 steps off one process\'s: ' \
        f'{[(k, dev_tp[k], noise[k]) for k in outside[:5]]}'
    for k, v in finals['one'].items():
        assert v.is_floating_point() or torch.equal(finals['tp'][k], v), k

    def strict(name):
        return sum(torch.allclose(finals[name][k], finals['one'][k], rtol=1e-3, atol=1e-5)
                   for k in floats)
    held = (strict('tp'), strict('reversed'))
    finals.clear()
    losses = [m['loss'] for m in one['metrics']]
    for r, rank in enumerate(runs['tp']):
        np.testing.assert_allclose([m['loss'] for m in rank['metrics']], losses, rtol=1e-4,
                                   err_msg=f'20.1 rank {r} vs one process')
        ratio = rank['param_bytes'] / one['param_bytes']
        assert 0.49 < ratio < 0.51, f'20.1 rank {r}: parameter bytes {ratio:.4f} of one process\'s'
        assert rank['sharded'] > 0
    for run in runs['one'] + runs['tp'] + runs['reversed']:
        assert run['launches']['ctc_loss_alpha'] == 3 and run['launches'][
            'ctc_loss_beta_grad_warp'] + run['launches']['ctc_loss_beta_grad'] == 3, \
            run['launches']
        total.update(run['launches'])
        log(run['checked'])

    def med(run):
        return statistics.median(run['times'][1:]) * 1e3
    spread = max(abs(m['loss'] - w) / abs(w) for rank in runs['tp']
                 for m, w in zip(rank['metrics'], losses))
    spread_reversed = max(abs(m['loss'] - w) / abs(w)
                          for m, w in zip(runs['reversed'][0]['metrics'], losses))
    mb = 1 / 2 ** 20
    log(f'tensor parallel on {card}: JasperNetBig float32 ({one["n_params"] / 1e6:.1f} M '
        f'parameters; {runs["tp"][0]["sharded"]} leaves of 256 channels or more sharded over the model '
        f'group), 3 steps of the same {one["shape"][0]} rows of phase 5\'s corpus '
        f'(T {one["shape"][1]} samples, L padded to {one["target_len"]}), 1 data x 2 model on Gloo, '
        f'both ranks on cuda:0, against one process: losses '
        f'{[round(v, 5) for v in losses]}, relative spread {spread:.2e} (rtol 1e-4 held; the reversed rows {spread_reversed:.2e}); '
        f'gathered parameters after 3 steps within {max(dev_tp.values()):.2e} of one '
        f'process\'s, the reversed rows {max(noise.values()):.2e} (rtol 1e-3 / atol 1e-5 + '
        f'{floor:.2e} held; at rtol 1e-3 / atol 1e-5 {held[0]} and {held[1]} of {len(floats)} '
        f'leaves); parameter + optimizer bytes a rank '
        + ', '.join(f'{r["param_bytes"] * mb:.1f} + {r["opt_bytes"] * mb:.1f} MiB'
                    for r in runs['tp'])
        + f' against one process\'s {one["param_bytes"] * mb:.1f} + {one["opt_bytes"] * mb:.1f} '
        f'MiB; max_memory_allocated a rank '
        + ', '.join(f'{r["peak"] * mb:.0f} MiB' for r in runs['tp'])
        + f' against {one["peak"] * mb:.0f} MiB; median step of steps 2-3 a rank '
        + ', '.join(f'{med(r):.1f} ms' for r in runs['tp'])
        + f' against {med(one):.1f} ms (steps ms: one process '
        f'{[round(t * 1e3, 1) for t in one["times"]]}, rank 0 '
        f'{[round(t * 1e3, 1) for t in runs["tp"][0]["times"]]}); wall incl. process starts: '
        f'the one-process runs (one, reversed, 20.3\'s dual head) {runs["wall_1"]:.1f} s, the '
        f'two-rank runs (20.1, 20.3) {runs["wall_2"]:.1f} s')

    # 20.3 the dual head (char_legacy + a 5000-piece BPE head) at full width:
    # one process, then two Gloo ranks as 1 data x 2 model, each holding
    # half of the BPE head's classes; both heads' losses, the BPE head's
    # logits gathered whole for log_softmax and the CTC kernels
    finals.clear()
    one = runs['dual_one'][0]
    losses = [m['loss'] for m in one['metrics']]
    for r, rank in enumerate(runs['dual_tp']):
        np.testing.assert_allclose([m['loss'] for m in rank['metrics']], losses, rtol=1e-4,
                                   err_msg=f'20.3 rank {r} vs one process')
        assert rank['head_rows'] == [bpe['vocab'] // 2], rank['head_rows']
    for run in runs['dual_one'] + runs['dual_tp']:
        # both heads' forward and backward each step, the BPE head's on the
        # warp kernel too (the lattice's classes staged, not its C-wide rows)
        assert run['launches']['ctc_loss_alpha'] == 6 and run['launches'][
            'ctc_loss_beta_grad_warp'] == 6 and run['launches']['ctc_loss_beta_grad'] == 0, \
            run['launches']
        total.update(run['launches'])
        log(run['checked'])
    spread = max(abs(m['loss'] - w) / abs(w) for rank in runs['dual_tp']
                 for m, w in zip(rank['metrics'], losses))
    log(f'tensor parallel, dual head, on {card}: JasperNetBig char_legacy + bpe '
        f'({one["n_params"] / 1e6:.1f} M parameters, a rank holds '
        f'{runs["dual_tp"][0]["head_rows"][0]} of the BPE head\'s {bpe["vocab"]} classes; '
        f'{runs["dual_tp"][0]["sharded"]} leaves sharded), 3 float32 steps of the same '
        f'{one["shape"][0]} rows, 1 data x 2 model on Gloo on cuda:0, against one process: '
        f'losses {[round(v, 5) for v in losses]}, relative spread {spread:.2e} (rtol 1e-4 held); '
        f'parameter bytes a rank {runs["dual_tp"][0]["param_bytes"] / 2 ** 20:.1f} MiB against '
        f'{one["param_bytes"] / 2 ** 20:.1f}; max_memory_allocated a rank '
        + ', '.join(f'{r["peak"] / 2 ** 20:.0f} MiB' for r in runs['dual_tp'])
        + f' against {one["peak"] / 2 ** 20:.0f} MiB; median step of steps 2-3 a rank '
        + ', '.join(f'{statistics.median(r["times"][1:]) * 1e3:.1f} ms' for r in runs['dual_tp'])
        + f' against {statistics.median(one["times"][1:]) * 1e3:.1f} ms')

    # 20.2 the dryrun at 4 ranks: 2 data x 2 model, all on cuda:0 over Gloo
    results = work / 'dryrun.pt'
    tic = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', 'convasr_tpu_torch.parallel.dryrun', '--ranks',
                           '4', '--results', str(results)], cwd=str(ROOT), capture_output=True,
                          text=True, timeout=900)
    wall = time.perf_counter() - tic
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    lines = [line for line in proc.stdout.splitlines() if line.startswith('dryrun_multichip(4)')]
    assert len(lines) == 5, proc.stdout[-3000:]
    got = torch.load(results, weights_only=False)
    assert got['grid'] == (2, 2) and got['backend'] == 'gloo', (got['grid'], got['backend'])
    for rank in got['ranks']:
        assert rank['launches']['ctc_loss_alpha'] == 3, rank['launches']
        total.update(rank['launches'])
    for line in lines:
        log(line)
    log(f'dryrun --ranks 4 on cuda:0 (Gloo, 2 data x 2 model, {got["ranks"][0]["sharded"]} of '
        f'{got["ranks"][0]["leaves"]} leaves sharded) in {wall:.1f} s wall incl. 4 process '
        f'starts; sharded inference log-probs within {got["lp_err"]:.2e} of one device\'s, '
        f'beam scores within {got["score_err"]:.2e}; CTC launches a rank '
        f'{got["ranks"][0]["launches"]}')
    return dict(total)

# phase 21: the BPE head. The vocabulary README's `tools bpetrain --vocab-size
# 5000` asks for, trained on seeded Russian text: a lexicon of pseudo-words
# of one to four syllables beside WORDS, sentences drawn with Zipf-like
# word frequencies
BPE_VOCAB = 5000
CONSONANTS = 'бвгдзклмнпрстфхцчшжй'
VOWELS = 'аоуиеыэяю'


def bpe_text(path, seed, words=3000, sentences=3000):
    rng = np.random.RandomState(seed)

    def word():
        return ''.join(CONSONANTS[rng.randint(len(CONSONANTS))] + VOWELS[rng.randint(len(VOWELS))]
                       + (CONSONANTS[rng.randint(len(CONSONANTS))] if rng.rand() < 0.3 else '')
                       for _ in range(rng.randint(1, 5)))
    lexicon = sorted(set(WORDS) | {word() for _ in range(words)})
    p = 1 / np.arange(1, len(lexicon) + 1) ** 0.8
    p /= p.sum()
    with open(path, 'w') as f:
        for _ in range(sentences):
            f.write(' '.join(lexicon[i] for i in rng.choice(len(lexicon), rng.randint(3, 12), p=p))
                    + '\n')
    return len(lexicon)


def bpe_vocabulary():
    """Phase 21.1, on the host only (main runs it beside the kernels'
    build): `cli/tools bpetrain` on the seeded text -> (words in the
    lexicon, bpetrain's seconds)."""
    from convasr_tpu_torch.cli import tools
    work = WORK / 'phase21'
    work.mkdir(parents=True, exist_ok=True)
    text = work / 'bpe_text.txt'
    lexicon = bpe_text(text, seed=21)
    tic = time.perf_counter()
    tools.main(['bpetrain', '-i', str(text), '-o', str(work / 'bpe'), '--vocab-size',
                str(BPE_VOCAB)])
    return lexicon, time.perf_counter() - tic


def bpe_phases(device, card, bpe_vocab):
    """Phase 21: the dual-head and BPE-only JasperNetBig on the card, and its
    kernels at the BPE head's width, on bpe_vocabulary's vocabulary (its
    result `bpe_vocab`). Returns the hand kernels' launches on its paths,
    and dict(ckpt, text_config, vocab) of the dual head for phase 20.3."""
    import torch.nn.functional as F
    from convasr_tpu_torch.cli import transcribe
    from convasr_tpu_torch.cli import train as train_cli
    from convasr_tpu_torch.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu_torch.models.zoo import create_model
    from convasr_tpu_torch.ops import align, ctc_loss, int8
    from convasr_tpu_torch.ops.ctc import ctc_alignment
    from convasr_tpu_torch.train.checkpoints import load_train_checkpoint
    work = WORK / 'phase21'
    work.mkdir(parents=True, exist_ok=True)
    total = collections.Counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f'phase 21 (the BPE head) on {card}')

    # 21.1 the vocabulary through `tools bpetrain` (bpe_vocabulary)
    lexicon, bpe_s = bpe_vocab
    vocab = len(json.load(open(work / 'bpe.json'))['pieces'])
    assert vocab >= 1024, f'bpetrain stopped at {vocab} pieces'
    config = json.load(open(ROOT / 'configs' / 'ru_text_config.json'))
    config['tokenizers']['bpe'] = {'class': 'BPETokenizer', 'model_path': str(work / 'bpe.json')}
    config['pipelines']['bpe'] = dict(tokenizer='bpe', preprocessor='default',
                                      postprocessor='default')
    text_config = work / 'text_config.json'
    with open(text_config, 'w') as f:
        json.dump(config, f, ensure_ascii=False)
    log(f'21.1 tools bpetrain --vocab-size {BPE_VOCAB} on {lexicon} seeded words in 3000 '
        f'sentences: {vocab} pieces (of {BPE_VOCAB} asked) in {bpe_s:.1f} s')

    # 21.2 train: the dual head (char_legacy + bpe), then --bpe-only
    train_json, _ = train_corpus('train', 96, seed=3)
    val_json, _ = train_corpus('val', 16, seed=4)
    exp = work / 'exp'

    def counts():
        return dict(ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
                    ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
                    ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES,
                    ctc_viterbi_align_warp=align.WARP_LAUNCHES,
                    ctc_viterbi_align=align.BLOCK_LAUNCHES, **int8_counts(int8))

    def reset():
        ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = 0
        ctc_loss.BETA_GRAD_WARP_LAUNCHES = align.WARP_LAUNCHES = align.BLOCK_LAUNCHES = 0
        reset_int8_counts(int8)

    seen, make_step = {}, train_cli.make_train_step

    def spy_make_step(model, *a, **kw):
        seen['model'] = model
        return make_step(model, *a, **kw)

    def train(name, arch, steps, extra):
        args = train_cli.build_parser().parse_args(
            ['--train-data-path', train_json, '--val-data-path', val_json,
             '--experiments-dir', str(exp), '--experiment-id', name, '--model', arch,
             '--train-batch-size', '32', '--val-batch-size', '16', '--iterations', str(steps),
             '--val-iteration-interval', str(steps), '--log-iteration-interval', '1',
             '--epochs', '3', '--skip-on-epoch-end-evaluation', '--num-workers', '4',
             '--text-config', str(text_config), '--text-pipelines', 'char_legacy', 'bpe',
             '--val-config', str(ROOT / 'configs' / 'ru_val_config.json')] + extra)
        train_cli.make_train_step = spy_make_step
        reset()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        try:
            with CTCCapture(ctc_loss, align, classes=vocab) as capture:
                train_cli.main(args)
            torch.cuda.synchronize()
        finally:
            train_cli.make_train_step = make_step
        wall = time.perf_counter() - tic
        launches = counts()
        total.update(launches)
        model = seen.pop('model')
        n_params = sum(p.numel() for p in model.parameters())
        assert all(p.is_cuda for p in model.parameters()) and \
            model.decoder.bpe_conv1.conv0.conv.weight.shape == (vocab, 1024, 15)
        logged = [json.loads(line) for line in open(exp / name / 'log.json')]
        assert [m['iteration'] for m in logged] == list(range(1, steps + 1)), logged
        assert all(np.isfinite(m['loss']) and m['finite'] == 1.0 for m in logged), logged
        log(f'21.2 train {name}: {arch} {n_params / 1e6:.1f} M parameters (bpe_conv1 '
            f'{tuple(model.decoder.bpe_conv1.conv0.conv.weight.shape)}), bf16, {steps} steps of '
            f'32 rows and a val batch of 16 in {wall:.1f} s wall; losses '
            f'{[round(m["loss"], 3) for m in logged]}; launches '
            f'{ {k: v for k, v in launches.items() if v} }; {init_drawn(exp / name)}')
        log(check_ctc_calls(capture.calls, f'21.2 {name} train\'s first BPE-head call (C {vocab})'))
        del model
        return launches, capture.calls, sorted((exp / name).glob('checkpoint_*_iter*.pt'))[-1]

    steps = 4
    dual, dual_calls, dual_ckpt = train('dual', 'JasperNetBig', steps, [])
    # both heads' losses forward at each step and the val batch; both heads'
    # backward on the warp kernel (the BPE head's lattice classes staged)
    assert (dual['ctc_loss_alpha'], dual['ctc_loss_beta_grad_warp'],
            dual['ctc_loss_beta_grad']) == (2 * steps + 2, 2 * steps, 0), dual
    only, _, _ = train('bpe_only', 'JasperNetBigBpeOnly', 3, ['--bpe-only'])
    # --bpe-only: both losses forward, the BPE head's alone backward
    assert (only['ctc_loss_alpha'], only['ctc_loss_beta_grad_warp'],
            only['ctc_loss_beta_grad']) == (2 * 3 + 2, 3, 0), only

    # 21.3 transcribe on the dual-head checkpoint: each head, --align on the
    # BPE head (K3 at C = V), and --quantize int8 on the BPE head
    corpus, audio_seconds, num_segments = synthetic_corpus()

    def run(name, extra, capture=None):
        out_dir = work / name
        args = transcribe.build_parser().parse_args(
            ['--checkpoint', str(dual_ckpt), '-i', corpus, '-o', str(out_dir), '--device', 'cuda',
             '--output-json', '--mono'] + extra)
        reset()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        with capture or contextlib.nullcontext():
            transcribe.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        launches = counts()
        total.update(launches)
        segments = [s for o in sorted(os.listdir(out_dir)) if o.endswith('.json')
                    for s in json.load(open(out_dir / o))]
        assert len(segments) == num_segments, (name, len(segments))
        log(f'21.3 transcribe {" ".join(extra)}: {wall:.2f} s wall for {audio_seconds:.0f} s of '
            f'audio; {len(segments)} segments, first hyp {segments[0]["hyp"][:40]!r}; launches '
            f'{ {k: v for k, v in launches.items() if v} }')
        return launches, segments

    bpe_run, bpe_segments = run('bpe', ['--pipeline', 'bpe'])
    char_run, _ = run('char', ['--pipeline', 'char_legacy'])
    assert not any(bpe_run.values()) and not any(char_run.values()), (bpe_run, char_run)
    with CTCCapture(ctc_loss, align, classes=vocab) as capture:
        aligned, aligned_segments = run('bpe_align', ['--pipeline', 'bpe', '--align'])
    batches = aligned['ctc_viterbi_align_warp']
    # at C = V the route names the warp kernel, which stages only the
    # lattice's L+1 classes a frame (its C-wide rows would pass shared
    # memory), for every batch; the block pair never
    assert batches > 0 and aligned['ctc_viterbi_align'] == 0, aligned
    assert len(aligned_segments) == len(bpe_segments)
    log(check_ctc_calls(capture.calls, f'21.3 --pipeline bpe --align (C {vocab})',
                        expect=('viterbi',)))
    viterbi_call = capture.calls['viterbi']
    L_bpe = viterbi_call[0][1].shape[1]
    assert align.viterbi_route(L_bpe, vocab) == 'warp' and align.viterbi_gathers(L_bpe, vocab) \
        and align._library().ctc_viterbi_warp_gathers(L_bpe, vocab, align.LAYOUTS['rule']), \
        (L_bpe, vocab)
    with Int8Capture(int8, limit=46) as int8_capture:
        quant, _ = run('bpe_int8', ['--pipeline', 'bpe', '--quantize', 'int8',
                                    '--calibration-cache', str(work / 'act_scales.npz')])
    # 34 convs a batch (the backbone's 32, bpe_conv0 and bpe_conv1) and 12 GEMMs
    assert quant['int8_conv_wgmma'] == 34 * batches and quant['int8_gemm_wgmma'] == 12 * batches \
        and not (quant['int8_conv_mma_sync'] + quant['int8_gemm_whole_k']
                 + quant['int8_gemm_k_tiled']), quant
    shapes = check_int8_calls(int8, int8_capture.captured, '21.3 int8 --pipeline bpe',
                              expect=(34, 12))
    log(f'check: 21.3 the first int8 batch\'s 34 convs and 12 GEMMs bit-equal to their plain '
        f'versions (float64): {dict(shapes)}')

    # 21.4 the dual head's float32 log-probs on the card against the CPU
    cpu_model = create_model('JasperNetBig', num_input_features=64, num_classes=(38, vocab),
                             decoder_type='bpe',
                             frontend=LogFilterBankFrontend(64, SR, 0.02, 0.01, dither=0.0))
    cpu_model.load_state_dict(load_train_checkpoint(str(dual_ckpt), 'cpu')['model_state_dict'])
    cpu_model.eval()
    card_model = copy.deepcopy(cpu_model).to(device)
    x = torch.from_numpy((0.1 * np.random.RandomState(2).randn(2, SR)).astype(np.float32))
    xlen = torch.tensor([1.0, 0.7])
    with torch.inference_mode():
        on_card = [lp.cpu() for lp in card_model(x.to(device), xlen=xlen.to(device))['log_probs']]
        on_cpu = cpu_model(x, xlen=xlen)['log_probs']
    diffs = [float((a - b).abs().max()) for a, b in zip(on_card, on_cpu)]
    assert [tuple(lp.shape) for lp in on_card] == [(2, 51, 38), (2, 51, vocab)] and all(
        torch.isfinite(lp).all() for lp in on_card), [lp.shape for lp in on_card]
    assert max(diffs) < 1e-3, f'card vs CPU log-probs differ by {diffs}'
    log(f'check: 21.4 dual-head JasperNetBig float32 log-probs card vs CPU max |diff| char '
        f'{diffs[0]:.2e}, bpe {diffs[1]:.2e} (< 1e-3)')
    weights = work / 'dual_weights.pt'
    torch.save(dict(model_state_dict=cpu_model.state_dict()), weights)
    del card_model, cpu_model

    # 21.5 the kernels at the BPE head's width on their route (both staging
    # the lattice's L+1 classes a frame), K1b's block kernel beside the warp
    # kernel, timed with every launch queued beside their plain versions,
    # their bounds (whole C-wide rows; the gathered lattice) and the library
    rng = np.random.RandomState(21)
    (lp, y, xlen_, ylen, blank), _, _ = dual_calls['alpha']
    g = dual_calls['beta_grad'][0][6]
    B, T = 32, 446
    seeded = [torch.log_softmax(torch.from_numpy(rng.randn(B, T, vocab).astype(np.float32) * 3),
                                -1).to(device),
              torch.from_numpy(rng.randint(0, vocab - 1, size=(B, 40))).to(device),
              torch.full((B,), T, dtype=torch.int32, device=device),
              torch.from_numpy(rng.randint(20, 41, size=B).astype(np.int32)).to(device),
              vocab - 1, torch.full((B,), 1.0 / B, device=device)]

    def own_ms(fn):
        own = queued_ms(fn, reps=20)
        return cuda_ms(fn, reps=20) if own is None else own
    for label, (lp, y, xlen_, ylen, blank, g) in (
            ('train path', [lp, y, xlen_, ylen, blank, g]),
            (f'B{B} T{T} L40', seeded)):
        L = y.shape[1]
        assert ctc_loss.gathers(L, vocab, forward=True) and ctc_loss.gathers(L, vocab), label
        assert ctc_loss.beta_grad_warp_fits(L, vocab), label
        alpha, ll = ctc_loss.alpha_kernel(lp, y, xlen_, ylen, blank)
        grad = ctc_loss.beta_grad_kernel(lp, y, xlen_, ylen, alpha, ll, g, blank)
        block_grad = ctc_loss._beta_grad_route(lp, y, xlen_, ylen, alpha, ll, g, blank, 'block')
        ref_alpha, ref_ll = ctc_loss.alpha_plain(lp, y, xlen_, ylen, blank)
        ref_grad = ctc_loss.beta_grad_plain(lp, y, xlen_, ylen, ref_alpha, ref_ll, g, blank)
        torch.cuda.synchronize()
        feasible = ref_ll > -5e29
        assert torch.equal(ll > -5e29, feasible) and bool(feasible.any())
        assert torch.allclose(alpha, ref_alpha, rtol=1e-5, atol=1e-3), f'K1f alpha [{label}]'
        loss_err = float(((ll - ref_ll).abs() / ref_ll.abs().clamp(min=1))[feasible].max())
        assert loss_err < 1e-5, f'K1f at C {vocab} [{label}]: loss rel err {loss_err}'
        agree = {}
        for name, got in (('warp', grad), ('block', block_grad)):
            agree[name] = ctc_loss.grad_agreement(got, ref_grad, g)
            assert agree[name][0], (f'K1b {name} at C {vocab} [{label}]: gradient differs by '
                                    f'{agree[name][1]} per unit of g, row relative L2 '
                                    f'{agree[name][2]}')
        lp_tbc = lp.transpose(0, 1).contiguous()
        lib = F.ctc_loss(lp_tbc, y.long(), xlen_.long(), ylen.long(), blank=blank,
                         reduction='none')
        lib_err = float(((lib + ll).abs() / lib.abs().clamp(min=1))[feasible].max())
        assert lib_err < 1e-4, f'F.ctc_loss disagrees with K1f at C {vocab} ({lib_err})'
        leaf = lp_tbc.detach().requires_grad_()

        def lib_pair():
            out = F.ctc_loss(leaf, y.long(), xlen_.long(), ylen.long(), blank=blank,
                             reduction='none')
            torch.autograd.grad(out, leaf, g)

        def lib_fwd():
            return F.ctc_loss(lp_tbc, y.long(), xlen_.long(), ylen.long(), blank=blank,
                              reduction='none')

        def fwd():
            return ctc_loss.alpha_kernel(lp, y, xlen_, ylen, blank)

        def warp():
            return ctc_loss.beta_grad_kernel(lp, y, xlen_, ylen, alpha, ll, g, blank)

        def block():
            return ctc_loss._beta_grad_route(lp, y, xlen_, ylen, alpha, ll, g, blank, 'block')
        # in turns: kernel, library, library, kernel; the two backward kernels
        # warp, block, block, warp
        turns = collections.defaultdict(list)
        for name, fn in (('fwd', fwd), ('lib_fwd', lib_fwd), ('lib_fwd', lib_fwd), ('fwd', fwd),
                         ('warp', warp), ('block', block), ('lib_pair', lib_pair),
                         ('lib_pair', lib_pair), ('block', block), ('warp', warp)):
            turns[name].append(own_ms(fn))
        plain_fwd = cuda_ms(lambda: ctc_loss.alpha_plain(lp, y, xlen_, ylen, blank), reps=2)
        plain_bwd = cuda_ms(lambda: ctc_loss.beta_grad_plain(lp, y, xlen_, ylen, ref_alpha,
                                                             ref_ll, g, blank), reps=2)
        bounds = ctc_loss_bound_ms(xlen_, *lp.shape, L)
        gathered = ctc_loss_gathered_bound_ms(y, xlen_, ylen, blank, *lp.shape)

        def span(name):
            return f'{min(turns[name]):.4f}-{max(turns[name]):.4f}'
        log(f'ctc_loss at the BPE head [{label}] B={lp.shape[0]} T={lp.shape[1]} C={vocab} '
            f'L={L}: routes K1f ring of {ctc_loss.ALPHA_DEPTH} frames, K1b warp kernel, both '
            f'staging the lattice\'s {L + 1} classes a frame; loss rel err {loss_err:.2e}; grad '
            f'warp {agree["warp"][1]:.2e} per unit of g (worst row relative L2 '
            f'{agree["warp"][2]:.2e}), block {agree["block"][1]:.2e} ({agree["block"][2]:.2e}); '
            f'queued: K1f {span("fwd")} ms, K1b warp {span("warp")} ms, K1b block '
            f'{span("block")} ms; plain fwd {plain_fwd:.2f} ms, bwd {plain_bwd:.2f} ms; '
            f'F.ctc_loss fwd {span("lib_fwd")} ms, fwd+bwd {span("lib_pair")} ms (rel err '
            f'{lib_err:.2e}); K1f faster than F.ctc_loss fwd: '
            f'{max(turns["fwd"]) < min(turns["lib_fwd"])}, K1b warp faster than F.ctc_loss '
            f'fwd+bwd: {max(turns["warp"]) < min(turns["lib_pair"])}; bounds, whole rows: fwd '
            f'{bounds["alpha"][0]:.5f} ms ({bounds["alpha"][1]}), bwd '
            f'{bounds["beta_grad"][0]:.5f} ms ({bounds["beta_grad"][1]}); the gathered lattice: '
            f'fwd {gathered["alpha"][0]:.5f} ms ({gathered["alpha"][1]}), bwd '
            f'{gathered["beta_grad"][0]:.5f} ms ({gathered["beta_grad"][1]})')
        del alpha, ref_alpha, grad, block_grad, ref_grad, lp_tbc, leaf
    del seeded
    # K3 at C = V on the path's first batch: the warp kernel (gathered) and
    # the block pair, char frames and final alpha bit-equal to the plain
    # version, timed in turns (events and queued), beside both bounds
    a, kw, frames = viterbi_call
    ref_frames, ref_final = ctc_alignment(*a, return_final=True, **kw)
    for route in ('warp', 'block'):
        got_frames, got_final = align._alignment_route(*a, route=route, return_final=True, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got_frames, ref_frames) and torch.equal(got_final, ref_final), \
            f'21.5 K3 at C {vocab}: the {route} kernel differs from the plain version'
    events, queued = {r: [] for r in ('warp', 'block')}, {r: [] for r in ('warp', 'block')}
    for route in ('block', 'warp', 'warp', 'block'):
        events[route].append(cuda_ms(lambda: align._alignment_route(*a, route=route, **kw),
                                     reps=20))
        own = queued_ms(lambda: align._alignment_route(*a, route=route, **kw), reps=20)
        queued[route].append(events[route][-1] if own is None else own)
    plain_ms = cuda_ms(lambda: ctc_alignment(*a, **kw), reps=2)
    bound, bound_by = viterbi_bound_ms(a[0], a[1], a[2])
    blank = a[4] if len(a) > 4 else kw.get('blank')
    gathered, gathered_by = viterbi_gathered_bound_ms(
        a[1], a[2], a[3], vocab - 1 if blank is None else blank, a[0].shape[1], vocab)

    def span(v):
        return f'{min(v):.4f}-{max(v):.4f}'
    log(f'ctc_viterbi at the BPE head [transcribe --align path] B={a[0].shape[0]} '
        f'T={a[0].shape[1]} C={vocab} S={2 * L_bpe + 1}: route warp, staging the lattice\'s '
        f'{L_bpe + 1} classes a frame; char frames and final alpha of both kernels bit-equal to '
        f'the plain version; warp kernel {span(events["warp"])} ms (queued '
        f'{span(queued["warp"])}), the block pair in the same calls {span(events["block"])} ms '
        f'(queued {span(queued["block"])}); plain {plain_ms:.2f} ms; bound, the gathered '
        f'lattice {gathered:.5f} ms ({gathered_by}), whole rows {bound:.5f} ms ({bound_by})')
    for kind, x, w, args, kw, out in int8_capture.captured:
        wide = kind == 'conv' and x.shape[2] == 1024 and out.shape[2] in (1024, vocab) and \
            (kw['w_packed'] if w is None else w).shape[0] == 15
        deep = kind == 'gemm' and (x.shape[1] == 4096 or out.shape[1] == 38)
        if not (wide or deep):
            continue
        fn = int8.int8_conv1d if kind == 'conv' else int8.int8_matmul
        plain = int8.int8_conv1d_plain if kind == 'conv' else int8.int8_matmul_plain
        ms = cuda_ms(lambda: fn(x, w, *args, **kw), reps=20)
        own = queued_ms(lambda: fn(x, w, *args, **kw), reps=20)
        plain_ms = cuda_ms(lambda: plain(x, w, *args, **kw), reps=2)
        if kind == 'conv':
            B_, T_, Cin = x.shape
            K, Cout = 15, out.shape[2]
            ops = 2 * B_ * out.shape[1] * Cout * K * Cin
            nbytes = x.numel() + K * Cin * Cout + 4 * out.numel()
            xb = x.transpose(1, 2).to(torch.bfloat16).contiguous()
            wb = torch.from_numpy(rng.randint(-127, 128, size=(Cout, Cin, K)).astype(
                np.float32)).to(device, torch.bfloat16)
            lib_ms = cuda_ms(lambda: F.conv1d(xb, wb, padding=K // 2), reps=20)
            name = f'conv B{B_} T{T_} {Cin}->{Cout} K{K} ({"bpe_conv1" if Cout == vocab else "bpe_conv0"})'
            lib_name = 'bf16 cuDNN F.conv1d'
        else:
            M, K = x.shape
            N = out.shape[1]
            ops, nbytes = 2 * M * N * K, x.numel() + K * N + 4 * out.numel()
            bp = torch.zeros((K, (N + 7) // 8 * 8), dtype=torch.int8, device=device)
            lib_ms = cuda_ms(lambda: torch._int_mm(x, bp), reps=20)
            name = f'GEMM M{M} K{K} N{N}'
            lib_name = 'torch._int_mm (N padded to 8)'
        bound, bound_by = int8_bound_ms(ops, nbytes)
        log(f'int8 at the BPE head\'s forward [{name}]: bit-equal (above); kernel {ms:.4f} ms '
            f'(queued {"not measured" if own is None else f"{own:.4f} ms"}) = '
            f'{ops / ms / 1e9:.1f} TOPS; plain (float64) {plain_ms:.2f} ms; bound {bound:.5f} ms '
            f'({bound_by}); {lib_name} {lib_ms:.4f} ms')
    return dict(total), dict(ckpt=str(weights), text_config=str(text_config), vocab=vocab)


if __name__ == '__main__':
    sys.exit(main())
