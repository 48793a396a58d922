"""The CTC kernels' share of their roofline in the traced window: the least
time their work needs (the forward's and the backward's operations over the
float32 peak or their bytes over the bandwidth, whichever is larger: the
lattice's L + 1 classes a frame read, at most the sectors of the frame's
row, and the C-wide gradient written; `measure.ctc_counts`) over
the device time of K1f (`ctc_alpha`) and K1b (`ctc_beta_grad_warp`,
`ctc_beta_grad`) in the trace."""
from perfbench import measure, trace


def is_ctc(name):
    return 'ctc_alpha' in name or 'ctc_beta_grad' in name


def read(run):
    if run.traced is None or run.values.get('kind') != 'train':
        return None
    spent = trace.kernel_seconds(run.traced, is_ctc)
    w = run.values.get('traced_ctc')
    if not spent or not w:
        return None
    least = (measure.least_seconds(w['fwd_ops'], w['fwd_bytes'], measure.PEAK_FP32_FLOPS)
             + measure.least_seconds(w['bwd_ops'], w['bwd_bytes'], measure.PEAK_FP32_FLOPS))
    return 100.0 * least / spent
