"""The plain reference of a JasperNet configuration: the log-mel frontend,
the dense-residual ConvBn backbone, the CTC heads, the CTC loss, the
global-norm clip and NovoGrad, written out in plain PyTorch in float32 with
TF32 off (a frozen copy of the semantics of convasr's `models.py`,
`optimizers.py` NovoGrad and the train step, read from the configuration
file). It imports nothing of the program and nothing of JAX.

`precision='fp8'` is the control: every model convolution computed as fp8
training computes it (input and weight in e4m3, the gradient flowing back in
e5m2, per-tensor scales), the step below the bfloat16 the configuration
states; it has to come out as not correct. `precision='int4'` is the control
of a configuration quantized to int8, the step below it: every model
convolution's input symmetric int4 with a per-tensor scale and its weight
symmetric int4 with a scale for each output channel (evaluation only).

Dropout and dither draw from a `torch.Generator` handed in by the benchmark,
in the order of the model's forward: the dither of the whole (B, T) signal,
then each ConvBn repeat's keep mask of its (B, C, T) float32 activation, as
`empty_like(x).bernoulli_(1 - rate)`, so that one generator state gives both
sides the same masks.
"""
import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import model_plan

F16_TINY = float(np.finfo(np.float16).tiny)


@contextlib.contextmanager
def exact_float32():
    """float32 convolutions and matmuls in full float32 (no TF32)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _fp8(t: torch.Tensor, dtype) -> torch.Tensor:
    """t rounded to a float8 type with a per-tensor scale that maps its
    largest magnitude to the type's largest finite value."""
    top = torch.finfo(dtype).max
    scale = top / t.abs().amax().clamp(min=1e-30)
    return (t * scale).to(dtype).to(t.dtype) / scale


def _int4(t: torch.Tensor, dims) -> torch.Tensor:
    """t rounded to symmetric int4 (-7 .. 7) with one scale over `dims`, which
    maps the largest magnitude there to 7."""
    scale = t.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / 7.0
    return torch.clamp(torch.round(t / scale), -7.0, 7.0) * scale


class Fp8Conv(torch.autograd.Function):
    """A conv computed as fp8 training computes it: the input and weight in
    e4m3, the gradient flowing back in e5m2, each product of the forward and
    of the backward taken on those rounded operands."""

    @staticmethod
    def forward(ctx, x, w, b, stride, padding, dilation):
        xq, wq = _fp8(x, torch.float8_e4m3fn), _fp8(w, torch.float8_e4m3fn)
        ctx.save_for_backward(xq, wq)
        ctx.conf = stride, padding, dilation, b is not None
        return F.conv1d(xq, wq, b, stride, padding, dilation)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding, dilation, has_bias = ctx.conf
        gq = _fp8(g, torch.float8_e5m2)
        gx = torch.nn.grad.conv1d_input(xq.shape, wq, gq, stride, padding, dilation)
        gw = torch.nn.grad.conv1d_weight(xq, wq.shape, gq, stride, padding, dilation)
        return gx, gw, (g.sum(dim=(0, 2)) if has_bias else None), None, None, None


class Frontend:
    """Log-mel features: peak normalisation, preemphasis, dither, masked
    samples, reflect and zero padding, a windowed real DFT as one strided
    conv, power, a slaney mel filterbank, log."""

    def __init__(self, fe: dict, device):
        self.sr = fe['sample_rate']
        self.win = int(fe['window_size'] * self.sr)
        self.hop = int(fe['window_stride'] * self.sr)
        self.nfft = 2 ** math.ceil(math.log2(self.win))
        self.fc = self.nfft // 2 + 1
        self.dither, self.preemphasis = fe['dither'], fe['preemphasis']
        n = np.arange(self.nfft)[:, None]
        k = np.arange(self.fc)[None, :]
        angle = 2.0 * np.pi * k * n / self.nfft
        window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(self.win) / self.win)   # periodic hann
        padded = np.zeros(self.nfft)
        left = (self.nfft - self.win) // 2
        padded[left:left + self.win] = window
        basis = (np.concatenate([np.cos(angle), -np.sin(angle)], axis=1) * padded[:, None])
        self.basis = torch.tensor(basis.T[:, None, :].astype(np.float32), device=device)
        self.mel = torch.tensor(_slaney_mel(self.sr, self.nfft, fe['num_input_features']).T,
                                device=device)

    def __call__(self, x, mask, generator):
        x = x / (x.abs().amax(dim=-1, keepdim=True) + 1e-5)
        x = torch.cat([x[:, :1], x[:, 1:] - self.preemphasis * x[:, :-1]], dim=-1)
        if self.dither > 0 and generator is not None:
            x = x + self.dither * torch.randn(x.shape, generator=generator, device=x.device)
        x = (x * mask.to(x.dtype))[:, None, :]
        pad = self.fc - 1
        x = F.pad(x, (pad, 0), mode='reflect' if pad < x.shape[-1] else 'constant')
        x = F.pad(x, (0, pad))
        spec = F.conv1d(x, self.basis, stride=self.hop).transpose(1, 2)
        power = spec[..., :self.fc] ** 2 + spec[..., self.fc:] ** 2
        return torch.log(power @ self.mel + F16_TINY)


def _slaney_mel(sr, n_fft, n_mels):
    """librosa's slaney mel filterbank, (n_mels, 1 + n_fft // 2)."""
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0

    def to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= min_log_hz,
                        min_log_mel + np.log(np.maximum(f, 1e-30) / min_log_hz) / logstep,
                        f / f_sp)

    def to_hz(m):
        return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                        f_sp * m)

    fft = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_f = to_hz(np.linspace(to_mel(0.0), to_mel(sr / 2), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1][:, None],
                                   ramps[2:] / fdiff[1:][:, None]))
    w *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def _lengths(frames: int, fraction):
    return torch.ceil(fraction.to(torch.float32) * frames).to(torch.int32)


def _mask(frames: int, lengths):
    return torch.arange(frames, device=lengths.device)[None, :] < lengths[:, None]


class Model:
    """forward(params, x_int16, xlen, train, generator) -> [log_probs (B, T', C)
    float32 per head], olen (B,). Batch norm: the batch's statistics in
    training, the running ones (0 and 1, as drawn) in evaluation."""

    def __init__(self, config: dict, device, precision: str = 'float32'):
        self.arch = dict(config['architecture'],
                         num_input_features=config['frontend']['num_input_features'])
        self.classes = [h['classes'] for h in config['heads']]
        self.plan = model_plan.block_plan(self.arch)
        self.frontend = Frontend(config['frontend'], device)
        if precision not in ('float32', 'fp8', 'int4'):
            raise ValueError(f'no reference precision {precision!r}')
        self.precision = precision

    def conv(self, x, w, b=None, stride=1, dilation=1):
        pad = dilation * w.shape[-1] // 2
        if self.precision == 'fp8':
            return Fp8Conv.apply(x, w, b, stride, pad, dilation)
        if self.precision == 'int4':
            x, w = _int4(x, (0, 1, 2)), _int4(w, (1, 2))
        return F.conv1d(x, w, b, stride, pad, dilation)

    @staticmethod
    def bn(x, p, name, train):
        c = x.shape[1]
        mean = torch.zeros(c, device=x.device)
        var = torch.ones(c, device=x.device)
        return F.batch_norm(x, mean, var, p[name + '.weight'], p[name + '.bias'], train, 0.1, 1e-5)

    def convbn(self, p, prefix, b, x, residual, train, generator):
        for r in range(b['repeat']):
            x = self.conv(x, p[f'{prefix}.conv{r}.conv.weight'], None, b['stride'], b['dilation'])
            x = self.bn(x, p, f'{prefix}.bn{r}', train)
            if r == b['repeat'] - 1:
                for j, res in enumerate(residual):
                    y = self.conv(res, p[f'{prefix}.conv_residual{j}.weight'],
                                  p[f'{prefix}.conv_residual{j}.bias'])
                    x = x + self.bn(y, p, f'{prefix}.bn_residual{j}', train)
            x = F.relu(x)
            if train and b['dropout'] > 0:
                keep = torch.empty_like(x).bernoulli_(1.0 - b['dropout'], generator=generator)
                x = x * keep / (1.0 - b['dropout'])
        return x

    def forward(self, p, x_int16, xlen, train=False, generator=None):
        generator = generator if train else None
        x = x_int16.to(torch.float32) / 32767.0
        T = x.shape[-1]
        feats = self.frontend(x, _mask(T, _lengths(T, xlen)), generator)
        fmask = _mask(feats.shape[1], _lengths(feats.shape[1], xlen)).to(torch.float32)[:, :, None]
        count = fmask.sum(dim=1, keepdim=True)
        mean = (feats * fmask).sum(dim=1, keepdim=True) / count
        centered = (feats - mean) * fmask
        var = (centered * centered).sum(dim=1, keepdim=True) / count
        x = (centered / torch.sqrt(var + F16_TINY)).transpose(1, 2)
        residual = []
        n = len(self.plan)
        for i, b in enumerate(self.plan):
            x = self.convbn(p, f'block{i}', b, x, residual, train, generator)
            residual = [] if i >= n - 3 else residual + [x]
        logits = [self.conv(x, p['decoder.head0.weight'], p['decoder.head0.bias'])]
        if len(self.classes) > 1:
            h = x
            for k in range(2):
                h = self.convbn(p, f'decoder.bpe_conv{k}', dict(repeat=1, stride=1, dilation=1,
                                                                dropout=0.0),
                                h, [], train, generator)
            logits.append(h)
        log_probs = [F.log_softmax(y.transpose(1, 2), dim=-1) for y in logits]
        return log_probs, _lengths(log_probs[0].shape[1], xlen)


def ctc_losses(log_probs, olen, y, ylen):
    """Per-row CTC loss summed over the heads, each divided by the first
    head's target length (blank = the last class)."""
    total = 0.0
    for i, lp in enumerate(log_probs):
        li = F.ctc_loss(lp.transpose(0, 1), y[:, i], olen.to(torch.int64), ylen[:, i],
                        blank=lp.shape[-1] - 1, reduction='none', zero_infinity=False)
        total = total + li / torch.clamp(ylen[:, 0].to(li.dtype), min=1.0)
    return total


class NovoGrad:
    """clip_by_global_norm(max_norm), then NovoGrad (the reference's first
    step: the EMA is g^2 and the momentum the normalised gradient), weight
    decay added to the normalised gradient, then times the rate."""

    def __init__(self, opt: dict, names):
        self.b1, self.b2 = opt['betas']
        self.eps, self.wd, self.lr = opt['eps'], opt['weight_decay'], opt['lr']
        self.max_norm = opt['max_norm']
        self.names = list(names)
        self.ema, self.momentum, self.step = None, None, 0

    def clip(self, grads):
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
        if self.max_norm and norm >= self.max_norm:
            return [g / norm * self.max_norm for g in grads]
        return grads

    def update(self, params, grads):
        """params updated in place; returns the gradients as the optimizer
        got them (after the clip)."""
        grads = self.clip(grads)
        g2 = torch.stack([(g ** 2).sum() for g in grads])
        self.ema = g2 if self.step == 0 else self.ema * self.b2 + g2 * (1.0 - self.b2)
        d = [g / torch.sqrt(e + self.eps) + self.wd * p
             for g, e, p in zip(grads, self.ema.unbind(0), params)]
        self.momentum = d if self.step == 0 else [m * self.b1 + di
                                                  for m, di in zip(self.momentum, d)]
        with torch.no_grad():
            for p, m in zip(params, self.momentum):
                p.add_(-self.lr * m)
        self.step += 1
        return grads


def train_steps(config: dict, weights: dict, batches: list, generator, device,
                precision: str = 'float32'):
    """The first len(batches) train steps from `weights` (a {name: tensor}
    copy), on host batches dict(x int16 (B, T), xlen, y (B, H, L), ylen (B, H)).
    Returns dict(losses, first_grads {name: the first step's gradient as the
    optimizer got it}, start and after {name: the parameters before the
    first step and after the last}), on the host."""
    model = Model(config, device, precision)
    names = sorted(weights)
    params = {n: weights[n].detach().to(device, torch.float32).clone().requires_grad_(True)
              for n in names}
    start = {n: weights[n].detach().to('cpu', torch.float32).clone() for n in names}
    opt = NovoGrad(config['train'], names)
    losses, first = [], None
    with exact_float32():
        for batch in batches:
            b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
            log_probs, olen = model.forward(params, b['x'], b['xlen'], True, generator)
            loss = ctc_losses(log_probs, olen, b['y'], b['ylen']).mean()
            grads = torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
            grads = [torch.zeros_like(params[n]) if g is None else g for n, g in zip(names, grads)]
            del log_probs
            got = opt.update([params[n] for n in names], grads)
            if first is None:
                first = {n: g.detach().cpu() for n, g in zip(names, got)}
            losses.append(float(loss.detach()))
            del grads, got, loss
    after = {n: params[n].detach().cpu() for n in names}
    return dict(losses=losses, first_grads=first, start=start, after=after)


def eval_log_probs(config: dict, weights: dict, x_int16, xlen, device, precision='float32',
                   rows: int = 8):
    """The head-0 log-probs (B, T', C) float32 on the host and olen (B,) of an
    evaluation forward, computed in blocks of `rows` rows (batch norm in
    evaluation keeps rows independent)."""
    model = Model(config, device, precision)
    params = {n: w.to(device, torch.float32) for n, w in weights.items()}
    outs, lens = [], []
    with torch.no_grad(), exact_float32():
        for i in range(0, x_int16.shape[0], rows):
            lp, olen = model.forward(params, torch.as_tensor(x_int16[i:i + rows]).to(device),
                                     torch.as_tensor(xlen[i:i + rows]).to(device))
            outs.append(lp[0].cpu())
            lens.append(olen.cpu())
    return torch.cat(outs), torch.cat(lens)
