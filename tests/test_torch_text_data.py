"""The port's own copies of the host-side modules (text, data, decode,
metrics, audio) give what the JAX package's give."""
import json
import pathlib

import numpy as np
import pytest

import convasr_tpu.audio as jax_audio
import convasr_tpu.data.dataset as jax_dataset
import convasr_tpu.decode.generators as jax_generators
import convasr_tpu.metrics as jax_metrics
import convasr_tpu.text as jax_text
import convasr_tpu_torch.audio as audio
import convasr_tpu_torch.data.dataset as dataset
import convasr_tpu_torch.decode.generators as generators
import convasr_tpu_torch.metrics as metrics
import convasr_tpu_torch.text as text
from convasr_tpu.data.loader import prefetch_map as jax_prefetch_map
from convasr_tpu_torch.data.loader import prefetch_map

ROOT = pathlib.Path(__file__).resolve().parent.parent
TEXTS = ['Привет, мир! 25 раз', 'Hello, World 42 times', 'доброе   УТРО ёжик', 'ссылка на 1999 год', 'ааа оо кк', '']


def pipelines(pkg, lang, name):
    config = pkg.ProcessingPipeline.load_config(str(ROOT / 'configs' / f'{lang}_text_config.json'))
    return pkg.ProcessingPipeline.make(config, name)


@pytest.mark.parametrize('lang,name', [('ru', 'char_legacy'), ('ru', 'dataset'),
                                       ('ru', 'external'), ('ru', 'no_repeat'),
                                       ('en', 'char_en')])
def test_pipelines_match(lang, name):
    ref, ours = pipelines(jax_text, lang, name), pipelines(text, lang, name)
    assert ours.tokenizer.vocab == ref.tokenizer.vocab
    assert ours.tokenizer.eps_id == ref.tokenizer.eps_id
    for t in TEXTS:
        pre = ref.preprocess(t)
        assert ours.preprocess(t) == pre
        assert ours.encode([pre]) == ref.encode([pre])
        assert ours.postprocess(pre) == ref.postprocess(pre)
        assert ours.decode(ref.encode([pre])) == ref.decode(ref.encode([pre]))


def test_greedy_generator_matches():
    rng = np.random.RandomState(0)
    ref_pipe, pipe = pipelines(jax_text, 'ru', 'char_legacy'), pipelines(text, 'ru', 'char_legacy')
    C = pipe.tokenizer.vocab_size
    logits = rng.randn(3, 60, C).astype(np.float32)
    logits[..., pipe.tokenizer.eps_id] += 1.5  # blank runs, as in real posteriors
    ts = np.linspace(0, 0.6, 60)[None].repeat(3, 0)
    kw = dict(log_probs=logits, begin=np.array([0.0, 1.0, 2.0]), end=np.array([0.6, 1.6, 2.6]),
              output_lengths=np.array([60, 41, 17]), time_stamps=ts, segment_text_key='hyp',
              segment_extra_info=[dict(channel=k) for k in range(3)])
    ref = jax_generators.GreedyCTCGenerator(4).generate(tokenizer=ref_pipe.tokenizer, **kw)
    ours = generators.GreedyCTCGenerator(4).generate(tokenizer=pipe.tokenizer, **kw)
    assert json.dumps(ours, ensure_ascii=False) == json.dumps(ref, ensure_ascii=False)


def test_dataset_and_collate_match(tmp_path):
    rng = np.random.RandomState(1)
    entries = []
    for i in range(2):
        wav = str(tmp_path / f'u{i}.wav')
        jax_audio.write_audio(wav, (0.1 * rng.randn(1, 8000 * 2)).astype(np.float32), 8000)
        entries += [dict(audio_path=wav, ref=TEXTS[k], begin=0.4 * k, end=0.4 * k + 0.35)
                    for k in range(5)]
    path = str(tmp_path / 'data.json')
    with open(path, 'w') as f:
        json.dump(entries, f, ensure_ascii=False)
    for mode in ['batched_transcript', 'batched_channels']:
        ref_ds = jax_dataset.AudioTextDataset(
            [path], [pipelines(jax_text, 'ru', 'char_legacy')], 8000, mode=mode,
            time_padding_multiple=128, duration_from_transcripts=True)
        ds = dataset.AudioTextDataset(
            [path], [pipelines(text, 'ru', 'char_legacy')], 8000, mode=mode,
            time_padding_multiple=128, duration_from_transcripts=True)
        assert len(ds) == len(ref_ds) == 2
        for i in range(len(ds)):
            ref_b, ours_b = ref_ds.collate_fn(ref_ds[i]), ds.collate_fn(ds[i])
            as_json = lambda meta: json.dumps(meta, default=np.ndarray.tolist)
            assert as_json(ours_b[0]) == as_json(ref_b[0])
            for a, b in zip(ours_b[1:], ref_b[1:]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_audio_metrics_and_loader_match(tmp_path):
    x = (0.2 * np.random.RandomState(2).randn(2, 3000)).astype(np.float32)
    wav = str(tmp_path / 'a.wav')
    audio.write_audio(wav, x, 8000)
    ours, ref = audio.read_audio(wav, 16000, mono=False), jax_audio.read_audio(wav, 16000, mono=False)
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1] == ref[1]
    for hyp, ref_text in [('привет мир', 'привет мир'), ('превет мир', 'привет мир пир'),
                          ('', 'раз')]:
        assert metrics.cer(hyp=hyp, ref=ref_text) == jax_metrics.cer(hyp=hyp, ref=ref_text)
        assert metrics.wer(hyp=hyp, ref=ref_text) == jax_metrics.wer(hyp=hyp, ref=ref_text)
    for workers in (0, 2):
        assert list(prefetch_map(lambda v: v * v, range(9), num_workers=workers, lookahead=2)) \
            == list(jax_prefetch_map(lambda v: v * v, range(9), num_workers=workers, lookahead=2))
