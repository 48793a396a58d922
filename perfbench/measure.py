"""The benchmark's own metric arithmetic: the peaks of the card, percentiles,
due-time latency, the union of device intervals, and the operation and byte
counts of the CTC kernels.

Peaks (one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at its 700 W
power limit): 989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s float32
outside the tensor cores, 3.35 TB/s of HBM. A roofline share is the least
time the card could take (each kernel's operations over its peak, or its
bytes over the bandwidth, whichever is larger) over the time its kernels
took.
"""
import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# float32 operations a lattice state and frame of the CTC recursions: a
# three-way log-sum-exp (two max/compare, two exp, two add, a log) and the
# emission's add; the backward's beta adds as much again and its gradient
# two more a state (gamma's exp and the class sum)
CTC_FWD_OPS_PER_STATE = 12
CTC_BWD_OPS_PER_STATE = 14
# the least a read from HBM moves
SECTOR_BYTES = 32


def percentile(values, q: float) -> float:
    """The q-th percentile with linear interpolation between the order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def due_latencies(due: np.ndarray, done: np.ndarray) -> np.ndarray:
    """Seconds from when each request was due on the open-loop schedule
    (not from when it was sent) to when its answer was delivered."""
    return np.asarray(done, np.float64) - np.asarray(due, np.float64)


def union_seconds(intervals, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] covered by the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, t0: float, t1: float) -> list:
    """(start, end) of every stretch of [t0, t1] that no interval covers."""
    gaps, at = [], t0
    for s, e in sorted((max(s, t0), min(e, t1)) for s, e in intervals if e > t0 and s < t1):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if at < t1:
        gaps.append((at, t1))
    return gaps


def ctc_counts(olen, ylen, frames: int, classes: int) -> dict:
    """Operations and bytes that one head's CTC loss and gradient need for a
    batch: the lattice of each row (2 L + 1 states over its valid frames),
    the float32 log-probs of its L + 1 classes read a frame, and the
    (B, T', C) float32 gradient the op has to write.

    A frame's read is a 32-byte sector a class (the least a read of a
    scattered float can move), but never more than the sectors of the
    frame's whole row of C log-probs, which lie side by side: at C 38 a
    frame reads its row's 5 sectors (160 bytes), at C 5000 its L + 1
    sectors.

    Returns dict(fwd_ops, fwd_bytes, bwd_ops, bwd_bytes)."""
    olen = np.asarray(olen, np.float64)
    ylen = np.asarray(ylen, np.float64)
    states = olen * (2 * ylen + 1)
    row = -(-classes * 4 // SECTOR_BYTES) * SECTOR_BYTES
    reads = float((olen * np.minimum((ylen + 1) * SECTOR_BYTES, row)).sum())
    grad = float(len(olen) * frames * classes * 4)
    return dict(fwd_ops=float(CTC_FWD_OPS_PER_STATE * states.sum()), fwd_bytes=reads,
                bwd_ops=float(CTC_BWD_OPS_PER_STATE * states.sum()), bwd_bytes=reads + grad)


def least_seconds(ops: float, nbytes: float, peak_ops: float) -> float:
    """The larger of the compute and the memory bound."""
    return max(ops / peak_ops, nbytes / PEAK_HBM_BYTES)
