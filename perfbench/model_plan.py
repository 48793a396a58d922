"""The benchmark's own arithmetic of a JasperNet configuration: the block
plan, the parameter names and shapes, the output frames of a padded input,
and the convolutions' FLOPs. It reads only the configuration file (a frozen
copy of the plan of convasr's `models.py` JasperNet), never the program, so
that a change to the program cannot move the counts the metrics divide by.
"""
import math


def block_plan(arch: dict) -> list:
    """One dict a backbone block: in/out channels, kernel, stride, dilation,
    repeat, dropout and the channels of its residual inputs (dense topology:
    every earlier main block's output)."""
    base = arch['base_width']
    on = arch['dropout'] != 0
    drop_pro = arch['dropout_prologue'] if on else 0.0
    drop_epi = arch['dropout_epilogue'] if on else 0.0
    drops = list(arch['dropouts']) if on else [0.0] * len(arch['dropouts'])
    nin = arch['num_input_features']
    plan = [dict(cin=nin, cout=arch['out_width_factors'][0] * base,
                 kernel=arch['kernel_size_prologue'], stride=arch['stride1'], dilation=1,
                 repeat=1, dropout=drop_pro, residual=())]
    residual, in_width = [], arch['out_width_factors'][0]
    for k, p, out_width in zip(arch['kernel_sizes'], drops, arch['out_width_factors']):
        for s in range(arch['num_subblocks']):
            last = s == arch['num_subblocks'] - 1
            cin = plan[-1]['cout']
            assert arch['residual'] == 'dense', 'the benchmark plans the dense topology only'
            residual.append(in_width * base)
            plan.append(dict(cin=cin, cout=(out_width if last else in_width) * base, kernel=k,
                             stride=1, dilation=1, repeat=arch['repeat'], dropout=p,
                             residual=tuple(residual)))
        in_width = out_width
    large = arch['out_width_factors_large']
    plan.append(dict(cin=plan[-1]['cout'], cout=large[0] * base,
                     kernel=arch['kernel_size_epilogue'], stride=1,
                     dilation=arch['dilation'], repeat=1, dropout=drop_epi, residual=()))
    plan.append(dict(cin=plan[-1]['cout'], cout=large[1] * base, kernel=1, stride=1,
                     dilation=1, repeat=1, dropout=drop_epi, residual=()))
    return plan


def head_plan(arch: dict, classes: list) -> list:
    """The CTC heads: the char head's 1x1 conv; with a second head, the BPE
    decoder's two K15 ConvBn blocks (no dropout) of convasr's
    decoder_type='bpe'."""
    width = arch['out_width_factors_large'][1] * arch['base_width']
    heads = [dict(cin=width, cout=classes[0], kernel=1)]
    if len(classes) > 1:
        heads.append(dict(blocks=[
            dict(cin=width, cout=width, kernel=15), dict(cin=width, cout=classes[1], kernel=15)]))
    return heads


def param_plan(arch: dict, classes: list) -> list:
    """(name, shape, kind) for every parameter, in the program's naming
    (`block{i}.conv{r}.conv.weight`, `bn{r}`, `conv_residual{j}`,
    `bn_residual{j}`, `decoder.head0`, `decoder.bpe_conv{n}`). kind is
    'conv' (drawn), 'bias' (0), 'scale' (1)."""
    out = []

    def convbn(prefix, cin, cout, kernel, repeat, residual):
        for r in range(repeat):
            out.append((f'{prefix}.conv{r}.conv.weight', (cout, cin if r == 0 else cout, kernel),
                        'conv'))
            out.append((f'{prefix}.bn{r}.weight', (cout,), 'scale'))
            out.append((f'{prefix}.bn{r}.bias', (cout,), 'bias'))
        for j, c in enumerate(residual):
            out.append((f'{prefix}.conv_residual{j}.weight', (cout, c, 1), 'conv'))
            out.append((f'{prefix}.conv_residual{j}.bias', (cout,), 'bias'))
            out.append((f'{prefix}.bn_residual{j}.weight', (cout,), 'scale'))
            out.append((f'{prefix}.bn_residual{j}.bias', (cout,), 'bias'))

    for i, b in enumerate(block_plan(arch)):
        convbn(f'block{i}', b['cin'], b['cout'], b['kernel'], b['repeat'], b['residual'])
    heads = head_plan(arch, classes)
    out.append(('decoder.head0.weight', (heads[0]['cout'], heads[0]['cin'], 1), 'conv'))
    out.append(('decoder.head0.bias', (heads[0]['cout'],), 'bias'))
    if len(heads) > 1:
        for n, b in enumerate(heads[1]['blocks']):
            convbn(f'decoder.bpe_conv{n}', b['cin'], b['cout'], b['kernel'], 1, ())
    return out


def frontend_frames(frontend: dict, samples: int) -> int:
    """Log-mel frames of a padded signal: reflect and zero padding of
    n_fft // 2 on each side, a window of n_fft, a hop of the stride."""
    win = int(frontend['window_size'] * frontend['sample_rate'])
    nfft = 2 ** math.ceil(math.log2(win))
    hop = int(frontend['window_stride'] * frontend['sample_rate'])
    return (samples + 2 * (nfft // 2) - nfft) // hop + 1


def output_frames(arch: dict, frontend: dict, samples: int) -> int:
    """Frames of the log-probs for `samples` padded samples: the prologue's
    stride over 'same' padding, every later conv at stride 1."""
    frames = frontend_frames(frontend, samples)
    k, s = arch['kernel_size_prologue'], arch['stride1']
    return (frames + 2 * (k // 2) - k) // s + 1


def valid_frames(out_frames: int, fraction: float) -> int:
    """The program's output length of a row: ceil(float32(fraction) * T')."""
    import numpy as np
    return int(math.ceil(float(np.float32(fraction) * np.float32(out_frames))))


def conv_flops_per_frame(arch: dict, classes: list) -> float:
    """Multiply-adds x 2 of every model convolution for one output frame:
    each conv, residual 1x1 conv and head runs at the output frame rate
    (the prologue's stride puts its outputs there too)."""
    total = 0
    for b in block_plan(arch):
        for r in range(b['repeat']):
            total += 2 * (b['cin'] if r == 0 else b['cout']) * b['kernel'] * b['cout']
        for c in b['residual']:
            total += 2 * c * b['cout']
    heads = head_plan(arch, classes)
    total += 2 * heads[0]['cin'] * heads[0]['cout']
    if len(heads) > 1:
        for b in heads[1]['blocks']:
            total += 2 * b['cin'] * b['kernel'] * b['cout']
    return float(total)


def stft_flops_per_frame(frontend: dict) -> float:
    """The frontend's float32 products a log-mel frame (twice an output
    frame at stride 2): the STFT, a conv of n_fft taps to 2 (n_fft/2 + 1)
    channels, and the mel projection of the n_fft/2 + 1 powers."""
    win = int(frontend['window_size'] * frontend['sample_rate'])
    nfft = 2 ** math.ceil(math.log2(win))
    bins = nfft // 2 + 1
    return float(2 * nfft * 2 * bins + 2 * bins * frontend['num_input_features'])


def int8_products(arch: dict, classes: list, frontend: dict, rows: int, samples: int) -> list:
    """Every int8 x int8 -> int32 product of an int8 post-training quantized
    forward of `rows` rows padded to `samples` samples (the plan of convasr's
    int8 inference: batch norm folded, each conv with taps one int8 conv,
    each one-tap conv at stride 1 one GEMM of (rows x frames, Cin) by
    (Cin, Cout), a block's two or more dense-residual 1x1 convs one GEMM over
    their concatenated inputs).

    dict(name, kind 'conv' or 'gemm', ops, bytes) each: ops 2 x the
    multiply-adds; bytes the int8 input and weight read once and the int32
    output written once."""
    in_frames = frontend_frames(frontend, samples)
    frames = output_frames(arch, frontend, samples)
    out = []

    def conv(name, cin, cout, kernel, t_in):
        out.append(dict(name=name, kind='conv', ops=2.0 * rows * frames * kernel * cin * cout,
                        bytes=float(rows * t_in * cin + kernel * cin * cout
                                    + 4 * rows * frames * cout)))

    def gemm(name, k, n):
        m = rows * frames
        out.append(dict(name=name, kind='gemm', ops=2.0 * m * k * n,
                        bytes=float(m * k + k * n + 4 * m * n)))

    for i, b in enumerate(block_plan(arch)):
        for r in range(b['repeat']):
            cin = b['cin'] if r == 0 else b['cout']
            if b['kernel'] == 1 and b['stride'] == 1:
                gemm(f'block{i}.conv{r}', cin, b['cout'])
            else:
                conv(f'block{i}.conv{r}', cin, b['cout'], b['kernel'],
                     in_frames if i == 0 else frames)
        if len(b['residual']) > 1:
            gemm(f'block{i}.resfused', sum(b['residual']), b['cout'])
        elif b['residual']:
            gemm(f'block{i}.res0', b['residual'][0], b['cout'])
    heads = head_plan(arch, classes)
    gemm('decoder.head0', heads[0]['cin'], heads[0]['cout'])
    if len(heads) > 1:
        for k, b in enumerate(heads[1]['blocks']):
            conv(f'decoder.bpe{k}.conv0', b['cin'], b['cout'], b['kernel'], frames)
    return out
