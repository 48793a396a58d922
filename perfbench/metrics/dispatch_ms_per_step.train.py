"""Host milliseconds a train step's dispatch takes: the harness's span around
the step path (transport cast, pinned copy, the step's call), the mean over
the measured window's steps."""


def read(run):
    spans = run.spans.get('dispatch') if run.values.get('kind') == 'train' else None
    return 1e3 * sum(spans) / len(spans) if spans else None
