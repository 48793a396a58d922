"""Traffic kind `transcribe_int8`: the `transcribe` kind's batches and window
(traffic/transcribe.py's session, imported and unchanged) on the port's int8
post-training quantized forward, as `transcribe --quantize int8` runs it:
`cli/transcribe.setup`, then `forward.calibrate` on the first
`calibration_batches` batches of the pool at `calibration_percentile`, in
set-up, before the first dispatch; from then on every `forward.fused_i16`
runs `models/quantized.quantized_apply` on the int8 conv and GEMM kernels.

Parameters: those of `transcribe`, and
    calibration_batches      batches of the pool the scales are calibrated on
    calibration_percentile   the |x| percentile of an activation scale

Faults (`options['fault']`, perfbench/calibrate.py and the tests):
    alter_token              as `transcribe`
    zero_calibration         the calibration fed batches of silence in place
                             of the pool's audio
The control (`options['control']`) is the reference with every conv in
int4, the step below the configuration's int8.
"""
import numpy as np

from perfbench import measure, model_plan, weights as weights_lib
from perfbench.traffic import transcribe

TINY = dict(calls=3, call_min_s=2.0, call_max_s=5.0, seg_median_s=1.0, seg_sigma=0.3,
            seg_min_s=0.5, seg_max_s=2.0, padding_multiple=16, check_batches=1)


class Session(transcribe.Session):

    def __init__(self, run):
        self.calibrated = False
        super().__init__(run)
        arch, fe = weights_lib.arch_of(self.config), self.config['frontend']
        classes = weights_lib.classes_of(self.config)
        # the least time of each batch's int8 products (every head's) at its
        # padded shape
        self.int8_least_s = [
            sum(measure.least_seconds(q['ops'], q['bytes'], measure.PEAK_INT8_OPS)
                for q in model_plan.int8_products(arch, classes, fe, *b['x'].shape))
            for b in self.pool.batches]

    def _dispatch(self, k):
        if not self.calibrated:          # set-up's first dispatch: the CLI calibrates first
            self.calibrate()
        return super()._dispatch(k)

    def calibrate(self):
        batches = self.pool.batches[:self.p['calibration_batches']]
        silent = self.options.get('fault') == 'zero_calibration'
        self.forward.calibrate(
            [dict(x=np.zeros_like(b['x']) if silent else b['x'], xlen=b['xlen'])
             for b in batches], percentile=self.p['calibration_percentile'])
        self.calibrated = True

    def window(self, run, seconds):
        super().window(run, seconds)
        run.values['kind'] = 'transcribe_int8'

    def traced_window(self, run, seconds):
        first = self.at
        super().traced_window(run, seconds)
        n = len(self.pool.batches)
        assert self.at - first == run.values['traced_batches'], (first, self.at)
        run.values['traced_int8_least_s'] = sum(self.int8_least_s[k % n]
                                                for k in range(first, self.at))


def setup(run):
    return Session(run)
