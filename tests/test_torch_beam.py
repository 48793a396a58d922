"""The port's host decoders (decode/beam.py, native/ctc_beam.cpp, text/binlm
and text/ngram_lm) against the JAX package's. The JAX side runs its Python
path: its native library is set to None first, so these tests add no run of
the JAX package's g++ build. Tokens equal, scores within 1e-3 (the C++ beam
against the Python spec, as tests/test_beam.py holds them)."""
import gzip
import math

import numpy as np
import pytest

import convasr_tpu.decode.beam as jax_beam
from convasr_tpu.text import CharTokenizer
from convasr_tpu.text.binlm import build_binary_lm
from convasr_tpu_torch.decode import beam
from convasr_tpu_torch.native import build as native_build
from convasr_tpu_torch.text import binlm, ngram_lm

ARPA = '''\\data\\
ngram 1=5
ngram 2=3

\\1-grams:
-1.0\t<unk>
-0.5\tмир\t-0.3
-0.7\tдом\t-0.3
-0.9\tпривет\t-0.2
-2.0\tмип\t-0.1

\\2-grams:
-0.2\tпривет мир
-1.5\tпривет дом
-0.4\tмир дом

\\end\\
'''
CHAR_ARPA = '\\data\\\nngram 1=5\nngram 2=4\n\n\\1-grams:\n' \
            '-0.5\tа\t-0.3\n-0.7\tб\t-0.3\n-0.9\tв\t-0.3\n-1.1\tг\t-0.3\n' \
            '-2.0\t<unk>\n\n\\2-grams:\n' \
            '-0.2\tа б\n-0.3\tб в\n-0.4\tв г\n-1.5\tа а\n\n\\end\\\n'
CONTEXTS = [['мир'], ['привет', 'мир'], ['дом', 'мир'], ['ыыы'], ['привет', 'ыыы', 'дом'],
            ['мир', 'дом', 'привет']]


@pytest.fixture
def jax_python_path(monkeypatch):
    monkeypatch.setitem(jax_beam._lib_cache, 'lib', None)


@pytest.fixture
def lm_path(tmp_path):
    path = str(tmp_path / 'lm.arpa')
    with open(path, 'w') as f:
        f.write(ARPA)
    return path


def softlog(p):
    p = np.asarray(p, np.float64)
    p = p / p.sum(-1, keepdims=True)
    return np.log(np.maximum(p, 1e-10)).astype(np.float32)


def test_arpa_lm_equals_jax(lm_path, tmp_path):
    gz = str(tmp_path / 'lm.arpa.gz')
    with gzip.open(gz, 'wt') as f:
        f.write(ARPA)
    for path in (lm_path, gz):
        ours, ref = beam.ArpaLM(path), jax_beam.ArpaLM(path)
        assert ours.order == ref.order == 2 and ours.ngrams == ref.ngrams
        assert [ours.score(c) for c in CONTEXTS] == [ref.score(c) for c in CONTEXTS]
    assert ours.score(['мир']) == pytest.approx(-0.5 * math.log(10))


def test_binary_lm_equals_jax(lm_path, tmp_path):
    """A CNLM file written by the JAX package, read by the port."""
    path = build_binary_lm(lm_path, str(tmp_path / 'lm.binlm'))
    assert binlm.is_binary_lm(path) and not binlm.is_binary_lm(lm_path)
    ours = beam.load_lm(path)
    assert isinstance(ours, binlm.BinaryLM)
    ref = jax_beam.load_lm(path)
    assert [ours.score(c) for c in CONTEXTS] == [ref.score(c) for c in CONTEXTS]
    np.testing.assert_allclose([ours.score(c) for c in CONTEXTS],
                               [beam.ArpaLM(lm_path).score(c) for c in CONTEXTS], atol=1e-6)


def test_ngram_trainer_equals_jax(tmp_path):
    from convasr_tpu.text import ngram_lm as jax_ngram
    sentences = ['привет мир', 'мир дом', 'привет дом мир', 'дом']
    for tokenize in (str.split, ngram_lm.char_tokenize):
        for order in (2, 3):
            ours = ngram_lm.train_ngram_lm([tokenize(s) for s in sentences], order=order)
            assert ours == jax_ngram.train_ngram_lm([tokenize(s) for s in sentences], order)
    assert ngram_lm.char_tokenize(' а б ') == ['а', ngram_lm.SPACE_TOKEN, 'б']
    path = ngram_lm.save_arpa(ours, str(tmp_path / 'c.arpa.gz'))
    assert beam.ArpaLM(path).order == 3


def test_char_lm_table_equals_jax(tmp_path):
    path = str(tmp_path / 'char.arpa')
    with open(path, 'w') as f:
        f.write(CHAR_ARPA)
    vocab = ['а', 'б', ' ', 'в', 'г']
    ours = beam.char_lm_table(beam.ArpaLM(path), vocab)
    assert ours.shape == (6, 5)
    np.testing.assert_array_equal(ours, jax_beam.char_lm_table(jax_beam.ArpaLM(path), vocab))


def test_lm_word_scores_equals_jax(lm_path, tmp_path, jax_python_path):
    """The port scores in C++ (lm_rescore), the JAX side in Python."""
    texts = ['привет мир', 'мир дом привет', '', 'ыыы мир', 'дом']
    binary = build_binary_lm(lm_path, str(tmp_path / 'lm.binlm'))
    for path in (lm_path, binary):
        assert beam.load_native_lm(path) is not None
        scores, counts = beam.lm_word_scores(texts, beam.load_lm(path))
        ref_scores, ref_counts = jax_beam.lm_word_scores(texts, jax_beam.load_lm(path))
        np.testing.assert_array_equal(counts, ref_counts)
        np.testing.assert_allclose(scores, ref_scores, atol=1e-4)


def test_prefix_beam_search_collapse_and_greedy_equal_jax(lm_path):
    tok = CharTokenizer('деимпрстов')
    labels = [s.lower() for s in tok.vocab]
    rng = np.random.RandomState(1)
    lp = softlog(rng.dirichlet(np.ones(tok.vocab_size) * 2, size=10))
    kw = dict(beam_width=8, labels=labels, alpha=0.5, beta=1.0, topk=3)
    assert beam.prefix_beam_search(lp, tok.eps_id, lm=beam.ArpaLM(lm_path), **kw) == \
        jax_beam.prefix_beam_search(lp, tok.eps_id, lm=jax_beam.ArpaLM(lm_path), **kw)
    frames = softlog([[0.01, 0.01, 0.98] if k % 3 else [0.9, 0.05, 0.05] for k in range(12)])
    np.testing.assert_array_equal(beam.collapse_blanks(frames, 2),
                                  jax_beam.collapse_blanks(frames, 2))
    batch = softlog(rng.dirichlet(np.ones(5), size=(2, 6)))
    for K in (1, 2):
        assert beam.GreedyDecoder().decode(batch, [6, 4], K=K) == \
            jax_beam.GreedyDecoder().decode(batch, [6, 4], K=K)


BEAM_CASES = dict(
    no_lm=dict(alphabet='аб', seed=0, width=16, T=12, trials=3),
    lm_fusion=dict(alphabet='деимпрстов', seed=1, width=8, T=10, lm=True, alpha=0.5, beta=1.0),
    rescore=dict(alphabet='деимпрстов', seed=3, width=16, T=14, lm=True, alpha=0.7, beta=0.3,
                 rescore=True),
    topk3_collapse=dict(alphabet='аб', seed=4, width=8, T=20, topk=3, peaky=True),
)


@pytest.mark.parametrize('case', BEAM_CASES)
def test_native_beam_matches_jax_prefix_beam_search(case, lm_path, jax_python_path):
    """The port's C++ beam (BeamSearchDecoder) against the JAX package's
    BeamSearchDecoder on its Python path (prefix_beam_search)."""
    c = BEAM_CASES[case]
    tok = CharTokenizer(c['alphabet'])
    rng = np.random.RandomState(c['seed'])
    kw = dict(lm_path=lm_path if c.get('lm') else None, beam_width=c['width'],
              beam_alpha=c.get('alpha', 0.0), beam_beta=c.get('beta', 0.0),
              topk=c.get('topk', 1), rescore=c.get('rescore', False))
    ours, ref = beam.BeamSearchDecoder(tok, **kw), jax_beam.BeamSearchDecoder(tok, **kw)
    assert ref.handle is None and ours.handle
    for _ in range(c.get('trials', 1)):
        p = rng.dirichlet(np.ones(tok.vocab_size) * 2, size=c['T'])
        if c.get('peaky'):                       # long confident blank runs to collapse
            runs = np.arange(c['T']) % 4 < 2
            p[runs] = 1e-5
            p[runs, tok.eps_id] = 1.0
        lp = softlog(p)
        got, want = ours.decode_one(lp), ref.decode_one(lp)
        assert len(got) == len(want) == c.get('topk', 1)
        assert [h[0] for h in got] == [h[0] for h in want]
        np.testing.assert_allclose([h[1] for h in got], [h[1] for h in want], atol=1e-3)


def test_native_beam_batch_threads_and_gzip(lm_path, tmp_path, jax_python_path):
    tok = CharTokenizer('абв')
    rng = np.random.RandomState(3)
    lp = softlog(rng.dirichlet(np.ones(tok.vocab_size), size=(6, 20)))
    serial = beam.BeamSearchDecoder(tok, beam_width=8).decode(lp, [20, 17, 20, 9, 20, 20])
    threaded = beam.BeamSearchDecoder(tok, beam_width=8, num_workers=4).decode(
        lp, [20, 17, 20, 9, 20, 20])
    assert serial == threaded == jax_beam.BeamSearchDecoder(tok, beam_width=8).decode(
        lp, [20, 17, 20, 9, 20, 20])
    gz = str(tmp_path / 'lm.arpa.gz')
    with open(lm_path, 'rb') as f, gzip.open(gz, 'wb') as g:
        g.write(f.read())
    kw = dict(beam_width=8, beam_alpha=0.5, beam_beta=1.0)
    assert beam.BeamSearchDecoder(tok, lm_path=gz, **kw).decode(lp) == \
        beam.BeamSearchDecoder(tok, lm_path=lm_path, **kw).decode(lp)


@pytest.mark.parametrize('fault', ['compile_error', 'no_compiler'])
def test_failed_native_build_raises(fault, tmp_path, monkeypatch):
    """No fallback: a source that does not compile, or no g++, raises."""
    (tmp_path / 'broken.cpp').write_text('int f( {')
    monkeypatch.setattr(native_build, 'NATIVE_DIR', tmp_path)
    monkeypatch.setattr(native_build, 'BUILD_DIR', tmp_path / 'out')
    if fault == 'no_compiler':
        monkeypatch.setenv('PATH', str(tmp_path / 'empty'))
    with pytest.raises(RuntimeError, match='g\\+\\+ failed' if fault == 'compile_error'
                       else 'g\\+\\+ not found'):
        native_build.load_library('broken.cpp')
    assert not native_build.library_path('broken.cpp').exists()


def test_native_build_names_the_library_by_its_source(tmp_path, monkeypatch):
    """Built once into the build directory under a hashed name; a second load
    reuses the file, an edited source gets a new name."""
    (tmp_path / 'one.cpp').write_text('extern "C" int one() { return 1; }\n')
    monkeypatch.setattr(native_build, 'NATIVE_DIR', tmp_path)
    monkeypatch.setattr(native_build, 'BUILD_DIR', tmp_path / 'out')
    monkeypatch.setattr(native_build, '_LIBS', {})
    first = native_build.build_library('one.cpp')
    assert first.parent == tmp_path / 'out' and first.name.startswith('one_')
    assert native_build.load_library('one.cpp').one() == 1
    assert native_build.build_library('one.cpp') == first
    assert [p.name for p in (tmp_path / 'out').iterdir()] == [first.name]
    (tmp_path / 'one.cpp').write_text('extern "C" int one() { return 2; }\n')
    assert native_build.library_path('one.cpp') != first
