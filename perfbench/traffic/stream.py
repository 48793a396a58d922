"""Traffic kind `stream`: real-time streams through the port's batched
streaming engine, built as `serve/grpc_google_api.start` builds it for
StreamingRecognize (`BatchedStreamingEngine` over `forward.fused` and
`forward.stream_logprobs`, the fused tick, int16 transport) and driven by
its `EngineTicker`; gRPC itself is left out.

Each of `slots` streams sends a chunk of `chunk_s` seconds every `chunk_s`
seconds on an open loop, its phase drawn from the seed; a chunk is due when
its last sample is spoken. Its latency runs from then until the end of the
engine tick that consumed it, when its interim result is in the session's
inbox. The streams start `lead_s` before the window; every chunk due in the
window is waited for, up to a minute past its close, and one never
delivered counts as failed.

Parameters:
    slots, window_s, chunk_s, max_lookahead_s, lookahead_s   the engine's
    lead_s              seconds of streaming before the window
    pool_s              seconds of audio the streams read from, each at
                        its own offset
    check_slots, check_ticks   the ticks of these many slots recorded, and
                        the ticks the check samples from them
    limits              the limit of each number `check` compares
"""
import gc
import threading
import time

import numpy as np
import torch

from perfbench import inference, measure, signals, weights as weights_lib
from perfbench.reference import jasper as reference
from perfbench.traffic.transcribe import gaps


class Session:
    def __init__(self, run, program=None):
        from convasr_tpu_torch.serve.streaming_batch import BatchedStreamingEngine, EngineTicker
        p, config = run.params, run.config
        self.p, self.config, self.seed = p, config, run.seed
        self.options = run.options
        self.text_pipeline, self.model, self.forward, _, _ = program or inference.setup(run)
        self.device = self.forward.device
        sr = config['frontend']['sample_rate']
        self.engine = BatchedStreamingEngine(
            self.forward.fused, sr, n_slots=p['slots'], window_sec=p['window_s'],
            chunk_sec=p['chunk_s'], logprobs_provider=self.forward.stream_logprobs,
            transport='int16', max_lookahead_sec=p['max_lookahead_s'], device=self.device)
        e = self.engine
        self.chunk, self.chunk_s = e.chunk, e.chunk_sec
        self.sessions = [e.open(self.text_pipeline.tokenizer, lookahead_sec=p['lookahead_s'])
                         for _ in range(p['slots'])]
        self.slots = [s.slot for s in self.sessions]
        g = signals.rng(run.seed, 4)
        self.pool = signals.speechlike(g, int(p['pool_s'] * sr), sr)
        self.offsets = g.integers(0, len(self.pool), size=p['slots'])
        self.phases = g.uniform(0.0, self.chunk_s, size=p['slots'])
        watch = g.choice(p['slots'], size=min(p['check_slots'], p['slots']), replace=False)
        self.watch = {self.slots[i]: i for i in watch}
        self.recorded = []           # (stream, chunks consumed, tail ids, tick start)
        self.consumed = np.zeros(p['slots'], int)
        self.delivered = {}          # (stream, chunk) -> tick end
        self.ticks = []              # (start, end) of each tick that ran a forward
        self.tracing = False
        self.stop = threading.Event()
        self.by_slot = {s: i for i, s in enumerate(self.slots)}
        # the engine's shapes, once, on silence (the rings hold zeros before
        # a stream's first chunk either way)
        silence = np.zeros(self.chunk, np.float32)
        for _ in range(2):
            for s in self.sessions:
                s.accept(silence)
            e.tick()
        for s in self.sessions:
            s.drain()
        self._tick = e.tick
        e.tick = self._timed_tick
        self.t0 = time.perf_counter() + 0.5
        self.feeder = threading.Thread(target=self._feed, daemon=True)
        self.ticker = EngineTicker(e)
        self.feeder.start()
        self.ticker.start()
        self.window_start = self.t0 + p['lead_s']
        _sleep_until(self.window_start)

    def chunk_audio(self, i: int, k: int) -> np.ndarray:
        at = (self.offsets[i] + k * self.chunk + np.arange(self.chunk)) % len(self.pool)
        return self.pool[at]

    def due(self, i: int, k: int) -> float:
        return self.t0 + self.phases[i] + (k + 1) * self.chunk_s

    def _feed(self):
        """The clients: each stream's chunks at their due times."""
        n = len(self.sessions)
        sent = np.zeros(n, int)
        while not self.stop.is_set():
            nxt = self.t0 + self.phases + (sent + 1) * self.chunk_s
            i = int(np.argmin(nxt))
            _sleep_until(nxt[i], self.stop)
            if self.stop.is_set():
                break
            if self.tracing:
                with torch.profiler.record_function('perfbench.accept'):
                    self.sessions[i].accept(self.chunk_audio(i, sent[i]))
            else:
                self.sessions[i].accept(self.chunk_audio(i, sent[i]))
            sent[i] += 1

    def _timed_tick(self):
        e = self.engine
        with e.lock:
            ready = [s for s, sess in e.sessions.items() if len(sess.pending) >= e.chunk]
            t = time.perf_counter()
            if self.tracing:
                with torch.profiler.record_function('perfbench.tick'):
                    n = self._tick()
            else:
                n = self._tick()
            done = time.perf_counter()
            if n:
                self.ticks.append((t, done))
                for s in ready:
                    i = self.by_slot[s]
                    self.delivered[(i, self.consumed[i])] = done
                    self.consumed[i] += 1
                    if s in self.watch:
                        self.recorded.append((i, int(self.consumed[i]),
                                              np.array(e.sessions[s].inbox[-1]), t))
        return n

    def window(self, run, seconds):
        w0, w1 = self.window_start, self.window_start + seconds
        _sleep_until(w1)
        due = [(i, k) for i in range(len(self.sessions))
               for k in range(int((w1 - self.t0 - self.phases[i]) / self.chunk_s) + 1)
               if w0 <= self.due(i, k) < w1]
        deadline = w1 + self.p.get('drain_s', 60.0)
        while time.perf_counter() < deadline and not all(d in self.delivered for d in due):
            time.sleep(0.05)
        got = [d for d in due if d in self.delivered]
        lat = list(measure.due_latencies([self.due(*d) for d in got],
                                         [self.delivered[d] for d in got]))
        ticks = [e - s for s, e in self.ticks if w0 <= s < w1]
        run.values.update(kind='stream', latencies=lat, due=[self.due(*d) for d in got],
                          tick_s=ticks, window_s=seconds,
                          attempted=len(due), failed=len(due) - len(lat), window=(w0, w1))

    def traced_window(self, run, seconds):
        self.tracing = True
        with torch.profiler.record_function('perfbench.window'):
            time.sleep(seconds)
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
        self.tracing = False

    def end_to_end(self, run):
        lat = run.values['latencies']
        return dict(stream_interim_p95_ms=1e3 * measure.percentile(lat, 95)) if lat else {}

    def close(self):
        self.stop.set()
        self.ticker.stop()
        self.feeder.join()
        self.ticker.join()

    def check(self, run):
        """Ticks sampled from the seed among the recorded ticks of the watched
        streams that started in the measured window (not the lead-in's, nor
        the traced window's): each tail's served ids against the reference's
        log-probs over that stream's window of audio as the ring held it."""
        self.close()
        self.engine = self.model = self.forward = self.sessions = None
        gc.collect()
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()
        w0, w1 = run.values['window']
        recorded = [r for r in self.recorded if w0 <= r[3] < w1]
        g = signals.rng(self.seed, 5)
        picks = g.choice(len(recorded), size=min(self.p['check_ticks'], len(recorded)),
                         replace=False)
        W = int(self.p['window_s'] * self.config['frontend']['sample_rate']) // 128 * 128
        rings, ids = [], []
        for j in picks:
            i, k, tail, _ = recorded[j]
            audio = np.concatenate([self.chunk_audio(i, c) for c in range(k)])
            ring = np.concatenate([np.zeros(W, np.float32), audio])[-W:]
            rings.append(signals.to_int16(ring))
            ids.append(tail)
        x = np.stack(rings)
        xlen = np.ones(len(rings), np.float32)
        start = weights_lib.draw(self.config, self.seed, self.device)
        ref, _ = reference.eval_log_probs(self.config, start, x, xlen, self.device)
        F = len(ids[0])
        ids = np.stack(ids).astype(np.int64)
        if self.options.get('fault') == 'alter_token':
            ids[:, ::7] = (ids[:, ::7] + 1) % self.config['heads'][0]['classes']
        tail = ref[:, -F:]
        full = np.full(len(ids), F)
        numbers = dict(token_gap=gaps(tail, full, ids, np.zeros(ids.shape))['token_gap'])
        if self.options.get('control'):
            low, _ = reference.eval_log_probs(self.config, start, x, xlen, self.device,
                                              self.options['control'])
            run.values['control_readings'] = dict(token_gap=gaps(
                tail, full, low[:, -F:].argmax(dim=-1).numpy(), np.zeros(ids.shape))['token_gap'])
        run.values['readings'] = numbers
        limits = self.p['limits']
        return [dict(name=k, value=v, limit=limits[k], ok=bool(v <= limits[k]))
                for k, v in numbers.items()]


def _sleep_until(t: float, stop: threading.Event = None):
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if stop is not None:
            if stop.wait(left):
                return
        else:
            time.sleep(left)


def setup(run):
    return Session(run)
