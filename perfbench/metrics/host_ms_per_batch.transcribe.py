"""Host milliseconds a transcribe batch costs: the harness's spans around the
dispatch (the int16 cast and the `forward.fused_i16` call, which queues the
forward) and the greedy generator, summed over the measured window, over
its batches. The fetch between them waits on the card and is left out."""


def read(run):
    v = run.values
    if v.get('kind') != 'transcribe' or not v.get('batches'):
        return None
    total = sum(sum(run.spans.get(k, [])) for k in ('dispatch', 'decode'))
    return 1e3 * total / v['batches']
