"""Post-training int8 quantization (PTQ) for JasperNet inference
(counterpart of convasr_tpu/models/quantized.py).

Scheme (standard PTQ, cf. Jacob et al. 2017), as in the JAX package:
- batch norm folded into the conv weights and biases (inference only);
- weights per output channel, symmetric int8 (absmax / 127);
- activations per tensor, symmetric int8, with scales calibrated by running
  the folded float32 graph over calibration batches and recording the absmax
  (or a percentile of |x|) at every requantization point;
- every conv is an int8 x int8 -> int32 product (ops/int8.py: csrc/int8_conv.cu
  for convs with taps, csrc/int8_gemm.cu for one-tap convs), then a float32
  epilogue in PyTorch: `y * (s_in * s_w[c]) + b[c] (+ residuals) -> nonlinearity
  -> mask -> requant int8`.

Tensors are channels-last, (B, T, C), and weights (K, Cin, Cout), the JAX
package's layouts, so activation-scale caches and `.qtree.npz` trees pass
between the two packages both ways; `build_folded_layers` transposes the
port's (Cout, Cin, K) conv weights once. On the card a tree also holds each
conv weight with taps packed as (K, Cout, Cin) ('wqp', the wgmma conv
kernel's layout), made once by `to_device`; `save_qtree` leaves it out.
Weight quantization runs in numpy, as in the JAX package, so the int8
weights are bit-equal to its. Separable
models keep their depthwise halves in float32 (`F.conv1d`). `_forward` runs
in three modes: collect (a `_Recorder`), int8 (act scales given) and plain
folded float32, the oracle of the tests. Float32 convolutions run with
cuDNN's TF32 off, so calibration on the card sees float32 activations.

The requantization is `round(x / scale)` in float32 with a true division, and
`torch.round` rounds half to even as `jnp.round` does. An epilogue that
computes the same float32 operations in another order can still land within
an ulp of a .5 boundary and flip one int8 step, which then propagates: the
int8 outputs of the two packages agree to a tolerance, not bit for bit.
"""
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..frontend.logmel import compute_output_lengths, full_fp32, masked_instance_norm, \
    temporal_mask
from ..ops.int8 import int8_conv1d_auto, int8_matmul_auto, pack_conv_weight
from .jasper import apply_nonlinearity, check_xlen

BN_EPS = 1e-5


def _conv1d(x, w, stride=1, dilation=1, groups=1, out_dtype=torch.float32, w_packed=None):
    """Channels-last 1-D conv with the reference padding (pad = dilation * K // 2
    on both ends). x (B, T, Cin), w (K, Cin/groups, Cout). With out_dtype int32
    both are int8: one-tap convs (stride 1, groups 1) go to `int8_matmul` on
    (B*T, Cin) x (Cin, Cout), all others to `int8_conv1d` (with w_packed, w
    as (K, Cout, Cin), where the tree has it)."""
    K = w.shape[0]
    if out_dtype == torch.int32:
        if K == 1 and stride == 1 and groups == 1:
            B, T, C = x.shape
            return int8_matmul_auto(x.reshape(B * T, C), w[0]).reshape(B, T, -1)
        return int8_conv1d_auto(x, w, stride, dilation, groups, w_packed=w_packed)
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), stride=stride,
                 padding=dilation * K // 2, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def _fold_bn(kernel, bn, conv_bias=None):
    """Fold inference batch norm into a conv's weight and bias.
    kernel: (K, Cin/g, Cout); bn: dict(scale, bias, mean, var)."""
    s = bn['scale'] / np.sqrt(bn['var'] + BN_EPS)          # (Cout,)
    w = np.asarray(kernel, np.float32) * s
    b = bn['bias'] + ((conv_bias if conv_bias is not None else 0.0) - bn['mean']) * s
    return w.astype(np.float32), np.asarray(b, np.float32)


def _quantize_weight(w):
    """Per-out-channel symmetric int8. w: (K, Cin/g, Cout)."""
    sw = np.maximum(np.abs(w).max(axis=(0, 1)), 1e-12) / 127.0
    wq = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
    return wq, sw.astype(np.float32)


def _requant(x, scale):
    """float -> int8 with the given per-tensor scale: a float32 division, not a
    product with the reciprocal, which would flip int8 values."""
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127, 127).to(torch.int8)


def build_folded_layers(model, state_dict=None):
    """Execution-ordered {layer_name: dict(w, b)} of float32 numpy arrays with
    batch norm folded in, from the port's state_dict (the model's own by
    default); w is (K, Cin/g, Cout). Layer names, those of the JAX package:
      block{i}.conv{r}        main conv of repeat r   (+ .dw{r} for separable)
      block{i}.res{j}         dense/residual 1x1 conv j
      decoder.head0           char CTC head
      decoder.bpe{k}.conv0    optional BPE head convs
    """
    sd = {k: v.detach().cpu().numpy().astype(np.float32)
          for k, v in (state_dict if state_dict is not None else model.state_dict()).items()
          if v.is_floating_point()}
    layers = {}

    def kernel(key):                               # (Cout, Cin/g, K) -> (K, Cin/g, Cout)
        return np.ascontiguousarray(sd[key].transpose(2, 1, 0))

    def bn_of(prefix):
        return dict(scale=sd[f'{prefix}.weight'], bias=sd[f'{prefix}.bias'],
                    mean=sd[f'{prefix}.running_mean'], var=sd[f'{prefix}.running_var'])

    def add_convbn(layer_prefix, module_prefix, kwargs):
        for r in range(kwargs.get('repeat', 1)):
            conv = f'{module_prefix}.conv{r}'
            bn = bn_of(f'{module_prefix}.bn{r}')
            if kwargs.get('separable'):
                # depthwise (+bias) stays float; BN folds into the pointwise
                layers[f'{layer_prefix}.dw{r}'] = dict(w=kernel(f'{conv}.depthwise.weight'),
                                                       b=sd[f'{conv}.depthwise.bias'])
                w, b = _fold_bn(kernel(f'{conv}.pointwise.weight'), bn)
            else:
                w, b = _fold_bn(kernel(f'{conv}.conv.weight'), bn)
            layers[f'{layer_prefix}.conv{r}'] = dict(w=w, b=b)

    for i, block in enumerate(model._block_plan()):
        add_convbn(f'block{i}', f'block{i}', block['kwargs'])
        for j, ch in enumerate(block['residual_channels']):
            if ch is None:
                continue
            w, b = _fold_bn(kernel(f'block{i}.conv_residual{j}.weight'),
                            bn_of(f'block{i}.bn_residual{j}'),
                            conv_bias=sd[f'block{i}.conv_residual{j}.bias'])
            layers[f'block{i}.res{j}'] = dict(w=w, b=b)

    layers['decoder.head0'] = dict(w=kernel('decoder.head0.weight'), b=sd['decoder.head0.bias'])
    if model.decoder_type == 'bpe':
        for k in range(2):
            add_convbn(f'decoder.bpe{k}', f'decoder.bpe_conv{k}', dict(kernel_size=15))
    return layers


def percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """q-th percentile of all elements of float32 `a` with linear
    interpolation, in `jnp.percentile`'s float32 arithmetic. A sort, since
    torch.quantile refuses inputs of more than 2^24 elements."""
    flat = torch.sort(a.reshape(-1)).values
    pos = np.float32(q) / np.float32(100.0) * np.float32(flat.numel() - 1)
    lo, hi = int(np.floor(pos)), min(int(np.ceil(pos)), flat.numel() - 1)
    high_weight = pos - np.floor(pos)
    low_weight = np.float32(1.0) - high_weight
    return (flat[lo] * torch.tensor(low_weight, device=a.device)
            + flat[hi] * torch.tensor(high_weight, device=a.device))


class _Recorder:
    """Collect-mode activation statistics: |x| percentile per tensor name."""

    def __init__(self, percentile):
        self.percentile = percentile
        self.stats = {}

    def observe(self, name, x):
        a = x.to(torch.float32).abs()
        v = a.max() if self.percentile >= 100.0 else percentile(a, self.percentile)
        self.stats[name] = torch.maximum(self.stats[name], v) if name in self.stats else v


def _features(model, x, xlen):
    """Frontend + feature normalization, as JasperNet.forward (inference: no
    dither) -> float32 (B, T, C)."""
    if model.frontend is not None and x.ndim == 2:
        mask = None
        if xlen is not None:
            mask = temporal_mask(x.shape[-1], compute_output_lengths(x.shape[-1], xlen))
        x = model.frontend(x, mask=mask)
    if model.normalize_features:
        mask = None
        if model.normalize_features_temporal_mask and xlen is not None:
            mask = temporal_mask(x.shape[1], compute_output_lengths(x.shape[1], xlen))
        x = masked_instance_norm(x, mask=mask, eps=model.normalize_features_eps)
    return x.to(torch.float32)


def to_device(tree, device):
    """The same nested dict with every array leaf a tensor on `device` (a
    no-op for leaves already there): a quantized tree is put on the card once,
    as the JAX CLI device_puts it. On a CUDA device every int8 conv weight
    with taps, 'wq' (K > 1, Cin, Cout), gains 'wqp' = pack_conv_weight(wq),
    unless the tree has it already: weights are packed once per tree, never
    per call."""
    device = torch.device(device)
    if isinstance(tree, dict):
        out = {k: to_device(v, device) for k, v in tree.items()}
        wq = out.get('wq')
        if device.type == 'cuda' and wq is not None and wq.ndim == 3 and wq.shape[0] > 1 \
                and 'wqp' not in out:
            out['wqp'] = pack_conv_weight(wq)
        return out
    if torch.is_tensor(tree):
        return tree.to(device)
    return torch.as_tensor(np.array(tree), device=device)


def _forward(model, layers, x, xlen, act_scales=None, recorder=None,
             epilogue_dtype=torch.float32):
    """Shared folded-graph forward. recorder set -> float32 collect mode;
    act_scales set -> int8 mode; neither -> plain folded float32 (the oracle).
    `layers` and `act_scales` hold tensors on x's device (see to_device).

    epilogue_dtype (int8 mode): precision of the per-conv epilogue
    (scale + bias + residual + nonlinearity + requant); float32 by default."""
    quant = act_scales is not None
    # every backbone block shares the model's temporal_mask and nonlinearity
    use_temporal_mask, model_nonlinearity = model.block0.temporal_mask, model.block0.nonlinearity

    def observe(name, t):
        if recorder is not None:
            recorder.observe(name, t)

    def conv(name, t, t_scale, stride=1, dilation=1, groups=1):
        L = layers[name]
        if quant:
            y = _conv1d(t, L['wq'], stride, dilation, groups, out_dtype=torch.int32,
                        w_packed=L.get('wqp'))
            return (y.to(epilogue_dtype) * (t_scale * L['sw']).to(epilogue_dtype)
                    + L['b'].to(epilogue_dtype))
        return _conv1d(t, L['w'], stride, dilation, groups) + L['b']

    def mask_of(t):
        if not use_temporal_mask or xlen is None:
            return None
        lengths = compute_output_lengths(t.shape[1], xlen)
        return temporal_mask(t.shape[1], lengths)[:, :, None].to(t.dtype)

    def scale_of(name):
        return act_scales[name] if quant else None

    x = _features(model, x, xlen)
    observe('features', x)
    cur = _requant(x, act_scales['features']) if quant else x
    cur_scale = scale_of('features')

    plan = model._block_plan()
    num_epilogue = 2
    residual = []   # (tensor, scale, channels-or-None)

    def run_block(prefix, kwargs, block_residual=(), use_mask=True, nonlinearity=None):
        nonlocal cur, cur_scale
        nonlinearity = nonlinearity or model_nonlinearity
        repeat = kwargs.get('repeat', 1)
        for r in range(repeat):
            t = cur
            if kwargs.get('separable'):
                tf = (t.to(torch.float32) * cur_scale) if quant else t
                tf = tf.to(torch.float32)  # depthwise half stays float32
                dw = layers[f'{prefix}.dw{r}']
                tf = F.relu(_conv1d(tf, dw['w'], kwargs.get('stride', 1),
                                    groups=kwargs.get('groups', 1)) + dw['b'])
                observe(f'{prefix}.dw{r}', tf)
                t = _requant(tf, act_scales[f'{prefix}.dw{r}']) if quant else tf
                t_scale = scale_of(f'{prefix}.dw{r}')
                y = conv(f'{prefix}.conv{r}', t, t_scale)  # pointwise 1x1
            else:
                # stride/dilation/groups apply at EVERY repeat (jasper.py:115)
                y = conv(f'{prefix}.conv{r}', t, cur_scale,
                         stride=kwargs.get('stride', 1),
                         dilation=kwargs.get('dilation', 1),
                         groups=kwargs.get('groups', 1))
            if r == repeat - 1:
                conv_idx = [j for j, (_, _, ch) in enumerate(block_residual) if ch is not None]
                if quant and len(conv_idx) >= 2 and f'{prefix}.resfused' in layers:
                    # dense-residual fusion: the j 1x1 convs are ONE concat-GEMM
                    # with a deep contraction (see _fuse_residuals)
                    L = layers[f'{prefix}.resfused']
                    rt_cat = torch.cat([block_residual[j][0] for j in conv_idx], dim=-1)
                    yr = _conv1d(rt_cat, L['wq'], out_dtype=torch.int32)
                    y = y + (yr.to(epilogue_dtype) * L['s'].to(epilogue_dtype)
                             + L['b'].to(epilogue_dtype))
                    conv_idx = []
                for j, (rt, rs, ch) in enumerate(block_residual):
                    if ch is None:   # 'flat' topology: raw add, no 1x1
                        y = y + (rt.to(epilogue_dtype) * rs.to(epilogue_dtype)
                                 if quant else rt)
                    elif j in conv_idx:
                        y = y + conv(f'{prefix}.res{j}', rt, rs)
            y = apply_nonlinearity(y, nonlinearity)
            m = mask_of(y) if use_mask else None
            if m is not None:
                y = y * m
            observe(f'{prefix}.r{r}', y)
            cur_scale = scale_of(f'{prefix}.r{r}')
            cur = _requant(y, cur_scale) if quant else y

    for i, block in enumerate(plan):
        used = [residual[j] for j in range(len(block['residual_channels']))] \
            if block['residual_channels'] else []
        # 'flat' keeps channels=None markers aligned with residual tensors
        used = [(rt, rs, ch) for (rt, rs, _), ch in zip(used, block['residual_channels'])]
        run_block(f'block{i}', block['kwargs'], used)
        if i >= len(plan) - num_epilogue - 1:
            residual = []
        elif model.residual == 'dense':
            residual.append((cur, cur_scale, True))
        elif model.residual:
            residual = [(cur, cur_scale, True)]
        else:
            residual = []

    logits = [conv('decoder.head0', cur, cur_scale)]
    if model.decoder_type == 'bpe':
        # the decoder's ConvBn heads use relu and get NO lengths
        for k in range(2):
            run_block(f'decoder.bpe{k}', dict(kernel_size=15), use_mask=False,
                      nonlinearity=('relu',))
        logits.append((cur.to(torch.float32) * cur_scale) if quant else cur)
    log_probs = [F.log_softmax(lg.to(torch.float32), dim=-1) for lg in logits]
    olen = [compute_output_lengths(lg.shape[1], xlen).to(lg.device) if xlen is not None
            else torch.full((lg.shape[0],), lg.shape[1], dtype=torch.int32, device=lg.device)
            for lg in logits]
    return dict(logits=logits, log_probs=log_probs, olen=olen)


def _device_of(model):
    return next(model.parameters()).device


def folded_apply(model, x, xlen=None, layers=None):
    """Folded float32 forward: must match model(x, xlen) in eval mode. The
    oracle for the quantized graph."""
    device = x.device
    layers = to_device(layers if layers is not None else build_folded_layers(model), device)
    with torch.inference_mode(), full_fp32():
        return _forward(model, layers, x, xlen)


def calibrate(model, batches, percentile=100.0, layers=None):
    """Run the folded float32 graph over calibration batches on the model's
    device, return {tensor_name: absmax-or-percentile} as float32 numpy
    scalars. Batches: dicts (or pairs) of numpy x ((B, T) signal or (B, T, C)
    features) and xlen. cuDNN's TF32 is off throughout, so the statistics are
    those of the float32 graph."""
    device = _device_of(model)
    layers = to_device(layers if layers is not None else build_folded_layers(model), device)
    stats = {}
    for batch in batches:
        x, xlen = (batch['x'], batch.get('xlen')) if isinstance(batch, dict) else batch
        rec = _Recorder(percentile)
        with torch.inference_mode(), full_fp32():
            _forward(model, layers, torch.as_tensor(np.asarray(x), device=device),
                     None if xlen is None else torch.as_tensor(np.asarray(xlen), device=device),
                     recorder=rec)
        for k, v in rec.stats.items():
            stats[k] = max(stats.get(k, 0.0), float(v))
    return {k: np.float32(v) for k, v in stats.items()}


def save_act_scales(path, act_scales):
    """Persist calibrated activation scales (one float32 per requant point)."""
    np.savez(path, **{k: np.float32(v) for k, v in act_scales.items()})


def load_act_scales(path):
    with np.load(path) as z:
        return {k: np.float32(z[k]) for k in z.files}


def _fuse_residuals(model, layers, qlayers, act_scales):
    """Collapse each block's dense-residual 1x1 convs into ONE concat-GEMM.

    Concatenating the j residual inputs along channels turns
    sum_j(rt_j @ W_j) into one GEMM with a j-times-deeper contraction.
    Each residual input rt_j carries its own per-tensor scale rs_j, which cannot
    be factored out after the int32 sum over the concatenated axis. Fix at
    quantize time: per output channel c pick the common product scale
    s[c] = max_j(rs_j * absmax_c(W_j) / 127) and requantize W_j with weight
    scale s[c] / rs_j (>= its natural scale, so values still fit int8). The
    numpy code is the JAX package's, so `wq` is bit-equal to its.
    """
    plan = model._block_plan()
    num_epilogue = 2
    res_names = []   # act_scales key of each pending residual tensor
    for i, block in enumerate(plan):
        kwargs = block['kwargs']
        chs = block['residual_channels'] or []
        idxs = [j for j, ch in enumerate(chs) if ch is not None]
        if len(idxs) >= 2:
            Ws = [layers[f'block{i}.res{j}']['w'] for j in idxs]
            rss = [float(act_scales[res_names[j]]) for j in idxs]
            s = np.maximum.reduce(
                [rs * np.maximum(np.abs(W).max(axis=(0, 1)), 1e-12) / 127.0
                 for W, rs in zip(Ws, rss)])                      # (Cout,)
            qlayers[f'block{i}.resfused'] = dict(
                wq=np.concatenate(
                    [np.clip(np.round(W / (s / rs)), -127, 127).astype(np.int8)
                     for W, rs in zip(Ws, rss)], axis=1),
                s=s.astype(np.float32),
                b=np.sum([layers[f'block{i}.res{j}']['b'] for j in idxs],
                         axis=0).astype(np.float32))
        out_name = f'block{i}.r{kwargs.get("repeat", 1) - 1}'
        if i >= len(plan) - num_epilogue - 1:
            res_names = []
        elif model.residual == 'dense':
            res_names.append(out_name)
        elif model.residual:
            res_names = [out_name]
        else:
            res_names = []


def quantize(model, batches, percentile=100.0, act_scales=None):
    """PTQ: fold BN, quantize weights per channel, calibrate activations (on
    the model's device). Returns the quantized tree of numpy arrays, the JAX
    package's: dict(layers={name: dict(wq, sw, b) | dw dict(w, b) |
    resfused dict(wq, s, b)}, act_scales={name: float32}). Pass `act_scales`
    (from load_act_scales) to skip calibration."""
    layers = build_folded_layers(model)
    stats = None if act_scales is not None else calibrate(model, batches, percentile, layers)
    qlayers = {}
    for name, L in layers.items():
        if '.dw' in name:          # depthwise halves stay float
            qlayers[name] = dict(L)
        else:
            wq, sw = _quantize_weight(L['w'])
            qlayers[name] = dict(wq=wq, sw=sw, b=L['b'])
    if act_scales is None:
        act_scales = {k: np.float32(max(float(v), 1e-12) / 127.0) for k, v in stats.items()}
    _fuse_residuals(model, layers, qlayers, act_scales)
    return dict(layers=qlayers, act_scales=dict(act_scales))


def quantize_for_inference(model, batches, percentile=100.0):
    """CLI entry: PTQ with calibration on the model's device (the card under
    --device cuda). Batches are numpy, as the model's forward takes them."""
    return quantize(model, batches, percentile)


def quantize_cached(model, batches, percentile=100.0, cache_path=None):
    """quantize_for_inference with an on-disk activation-scales cache: if
    `cache_path` exists, calibration is skipped; else calibrate and write it.
    The cache is only valid for the same checkpoint and calibration setup."""
    if cache_path and os.path.exists(cache_path):
        return quantize(model, batches, percentile, act_scales=load_act_scales(cache_path))
    if batches is None:
        raise ValueError(f'no calibration batches and no existing scales cache ({cache_path})')
    qtree = quantize_for_inference(model, batches, percentile)
    if cache_path:
        save_act_scales(cache_path, qtree['act_scales'])
    return qtree


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def save_qtree(path, qtree):
    """Persist a quantized tree as one flat .npz with '/'-joined keys
    ('layers/block1.conv0/wq', 'act_scales/features', ...), the JAX
    package's format. Packed conv weights ('wqp', card-only) are left out."""
    np.savez(path, **{'/'.join(p): np.asarray(v.cpu() if torch.is_tensor(v) else v)
                      for p, v in _flatten(qtree) if p[-1] != 'wqp'})


def load_qtree(path):
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node, parts = out, key.split('/')
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = z[key]
    return out


def quantized_apply(model, qtree, x, xlen=None, epilogue_dtype=torch.float32):
    """int8 inference forward on x's device. `qtree` from quantize() or
    load_qtree(), as numpy arrays or already on the device (to_device)."""
    check_xlen(xlen, x.shape[0])
    if 'frontend_params' in qtree:
        raise NotImplementedError('a quantized tree with learned frontend parameters '
                                  '(Wav2VecFrontend) is not yet ported to convasr_tpu_torch')
    qtree = to_device(qtree, x.device)
    with torch.inference_mode(), full_fp32():
        return _forward(model, qtree['layers'], x, xlen, act_scales=qtree['act_scales'],
                        epilogue_dtype=epilogue_dtype)
