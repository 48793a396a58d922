"""Host milliseconds an int8 transcribe batch's dispatch takes on the worker
thread: the program's `transcribe.dispatch` span (the upload and the int8
forward's launches in `forward.fused_i16`: per conv the int8 kernel's
wrapper and its float32 epilogue), the mean over the traced window's
batches."""
from perfbench import program_spans


def read(run):
    if run.values.get('kind') != 'transcribe_int8':
        return None
    return program_spans.mean_ms(run, 'transcribe.dispatch')
