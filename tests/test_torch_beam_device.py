"""The port's device beam (ops/beam_device.py) against the JAX package's
`beam_search_device` on the CPU: the non-sharded cases of
tests/test_beam_device.py, the carried-state API fed in chunks, and the
hybrid decoder and its (alpha, beta) tuning (decode/beam.py). Tokens and
lengths bit-equal, scores within 1e-4."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import convasr_tpu.decode.beam as jax_beam
from convasr_tpu.ops import beam_device as jax_device
from convasr_tpu.text import CharTokenizer
from convasr_tpu_torch.decode import beam
from convasr_tpu_torch.ops import beam_device


def softlog(p):
    p = np.asarray(p, np.float64)
    p = p / p.sum(-1, keepdims=True)
    return np.log(np.maximum(p, 1e-10)).astype(np.float32)


def both(lp, lengths, blank, **kw):
    """(ours, JAX's) outputs of beam_search_device as numpy arrays."""
    table = kw.pop('lm_table', None)
    ours = beam_device.beam_search_device(torch.from_numpy(lp), torch.as_tensor(lengths),
                                          blank, lm_table=table, **kw)
    ref = jax_device.beam_search_device(jnp.asarray(lp), jnp.asarray(lengths, np.int32), blank,
                                        lm_table=None if table is None else jnp.asarray(table),
                                        **kw)
    return [t.numpy() for t in ours], [np.asarray(t) for t in ref]


def assert_same(ours, ref):
    for a, b in zip(ours[:2], ref[:2]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=1e-4)


def char_table(tmp_path):
    arpa = '\\data\\\nngram 1=5\nngram 2=4\n\n\\1-grams:\n' \
           '-0.5\tа\t-0.3\n-0.7\tб\t-0.3\n-0.9\tв\t-0.3\n-1.1\tг\t-0.3\n' \
           '-2.0\t<unk>\n\n\\2-grams:\n' \
           '-0.2\tа б\n-0.3\tб в\n-0.4\tв г\n-1.5\tа а\n\n\\end\\\n'
    path = tmp_path / 'char.arpa'
    path.write_text(arpa)
    return beam.char_lm_table(beam.ArpaLM(str(path)), ['а', 'б', 'в', 'г'])


def case(name, tmp_path):
    """-> (log_probs (B, T, C), lengths, blank, keyword arguments)."""
    if name == 'simple_path':
        return softlog([[[0.9, 0.05, 0.05], [0.05, 0.05, 0.9], [0.05, 0.9, 0.05]]]), [3], 2, \
            dict(beam_width=8, cutoff_top_n=2, max_len=32)
    if name == 'repeat_collapse_and_split':
        return softlog([[[0.95, 0.01, 0.04], [0.02, 0.01, 0.97], [0.95, 0.01, 0.04]]]), [3], 2, \
            dict(beam_width=8, cutoff_top_n=2, max_len=32)
    if name == 'random_parity':          # ten rows of test_random_parity's draws
        rng = np.random.RandomState(0)
        lp = np.stack([softlog(rng.dirichlet(np.ones(4) * 1.5, size=10)) for _ in range(10)])
        return lp, [10] * 10, 3, dict(beam_width=8, cutoff_top_n=3, max_len=32)
    if name == 'variable_lengths':
        rng = np.random.RandomState(1)
        return softlog(rng.dirichlet(np.ones(4), size=(2, 12))), [12, 6], 3, \
            dict(beam_width=4, cutoff_top_n=3, max_len=16)
    if name == 'scores_sorted':
        rng = np.random.RandomState(2)
        return softlog(rng.dirichlet(np.ones(5), size=(1, 15))), [15], 4, \
            dict(beam_width=8, cutoff_top_n=4, max_len=16)
    if name == 'batch':
        rng = np.random.RandomState(3)
        return softlog(rng.dirichlet(np.ones(6), size=(4, 20))), [20] * 4, 5, \
            dict(beam_width=8, cutoff_top_n=4, max_len=24)
    if name == 'lm_fusion':              # TestDeviceLMFusion.test_matches_bruteforce's input
        rng = np.random.RandomState(0)
        lp = np.log(rng.dirichlet(np.ones(5), size=6).astype(np.float64)).astype(np.float32)
        return lp[None], [6], 4, dict(beam_width=64, cutoff_top_n=4, max_len=8,
                                      lm_table=char_table(tmp_path), lm_alpha=0.5, lm_beta=0.1)
    if name == 'lm_strong_alpha':        # test_lm_changes_output's input
        rng = np.random.RandomState(1)
        lp = np.log(rng.dirichlet(np.ones(5) * 2, size=(1, 12)).astype(np.float32))
        return lp, [12], 4, dict(beam_width=16, max_len=13, lm_table=char_table(tmp_path),
                                 lm_alpha=5.0, lm_beta=0.0)
    if name == 'compact_tokens':
        rng = np.random.RandomState(7)
        lp = np.log(rng.dirichlet(np.ones(6) * 0.5, size=(3, 24)).astype(np.float32))
        return lp, [24, 17, 24], 5, dict(beam_width=8, cutoff_top_n=4, max_len=25,
                                         compact_tokens=True)
    if name == 'max_len':
        rng = np.random.RandomState(8)
        lp = np.log(rng.dirichlet(np.ones(4) * 0.3, size=(2, 30)).astype(np.float32))
        return lp, [30, 30], 3, dict(beam_width=4, cutoff_top_n=3, max_len=6)
    raise KeyError(name)


CASES = ['simple_path', 'repeat_collapse_and_split', 'random_parity', 'variable_lengths',
         'scores_sorted', 'batch', 'lm_fusion', 'lm_strong_alpha', 'compact_tokens', 'max_len']


@pytest.mark.parametrize('name', CASES)
def test_beam_search_device_equals_jax(name, tmp_path):
    lp, lengths, blank, kw = case(name, tmp_path)
    ours, ref = both(lp, lengths, blank, **kw)
    assert_same(ours, ref)
    if name == 'simple_path':
        assert ours[0][0, 0, :ours[1][0, 0]].tolist() == [0, 1]
    if name == 'repeat_collapse_and_split':
        assert ours[0][0, 0, :ours[1][0, 0]].tolist() == [0, 0]
    if name == 'scores_sorted':
        assert (np.diff(ours[2][0]) <= 1e-5).all()
    if name == 'compact_tokens':
        assert ours[0].dtype == np.uint8
    if name == 'max_len':
        assert ours[1].max() <= 5 and np.isfinite(ours[2][:, 0]).all()


def test_carried_state_in_chunks_equals_one_call():
    """beam_carry_steps over chunks of 7 frames, with a row frozen in the
    second chunk, against one beam_search_device call on the lengths that
    freezing gives; beam_carry_best against its JAX counterpart."""
    rng = np.random.RandomState(11)
    B, T, C, K, L = 3, 21, 6, 8, 22
    lp = softlog(rng.dirichlet(np.ones(C) * 0.5, size=(B, T)))
    state = beam_device.beam_carry_init(B, K, L)
    jstate = jax_device.beam_carry_init(B, K, L)
    for start in range(0, T, 7):
        active = torch.tensor([True, start != 7, True])
        seg = torch.from_numpy(lp[:, start:start + 7])
        state = beam_device.beam_carry_steps(state, seg, active, C - 1, cutoff_top_n=4)
        jstate = jax_device.beam_carry_steps(jstate, jnp.asarray(seg.numpy()),
                                             jnp.asarray(active.numpy()), C - 1, cutoff_top_n=4)
    for a, b in zip(state, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))
    best = [t.numpy() for t in beam_device.beam_carry_best(state, num_classes=C)]
    ref = [np.asarray(t) for t in jax_device.beam_carry_best(jstate, num_classes=C)]
    assert_same(best, ref)
    # the row frozen for frames 7-13 equals a call on those frames removed
    cut = np.concatenate([lp[1:2, :7], lp[1:2, 14:]], 1)
    one = beam_device.beam_search_device(torch.from_numpy(cut), torch.tensor([14]), C - 1,
                                         beam_width=K, cutoff_top_n=4, max_len=L)
    assert best[0][1, :best[1][1]].tolist() == one[0][0, 0, :one[1][0, 0]].tolist()


def test_decode_device_with_lm_equals_jax(tmp_path, monkeypatch):
    """The device beam + host word-LM rescoring flips the acoustically
    preferred 'мип' to the LM's 'мир', as the JAX hybrid does."""
    from test_torch_beam import ARPA
    monkeypatch.setitem(jax_beam._lib_cache, 'lib', None)
    lm_path = str(tmp_path / 'lm.arpa')
    with open(lm_path, 'w') as f:
        f.write(ARPA)
    tok = CharTokenizer('мипр')
    labels = [s.lower() for s in tok.vocab]
    m, i, p, r = [labels.index(c) for c in 'мипр']
    C = tok.vocab_size
    frames = []
    for target, alt, pr in [(m, m, 0.95), (i, i, 0.95), (p, r, 0.55)]:
        probs = np.full(C, 0.001)
        probs[target] = pr
        probs[alt] = 1.0 - pr - 0.001 * (C - 2)
        frames.append(probs)
    space = np.full(C, 0.001)
    space[tok.space_id] = 1.0 - 0.001 * (C - 1)
    rng = np.random.RandomState(12)
    lp = np.concatenate([softlog(np.stack(frames + [space]))[None],
                         softlog(rng.dirichlet(np.ones(C) * 0.4, size=(1, 4)))])
    decode = lambda toks: ''.join(labels[t] for t in toks).strip()  # noqa: E731
    for kw in (dict(lm_path=None), dict(lm_path=lm_path, alpha=2.0, beta=0.0)):
        ours = beam.decode_device_with_lm(torch.from_numpy(lp), torch.tensor([4, 3]), tok,
                                          beam_width=16, **kw)
        assert ours == jax_beam.decode_device_with_lm(lp, [4, 3], tok, beam_width=16, **kw)
        assert decode(ours[0]) == ('мип' if kw['lm_path'] is None else 'мир')


def test_tune_rescore_weights_equals_jax(monkeypatch, tmp_path):
    from test_beam_tune import REFS, TOK, TRAIN_TEXTS, make_posteriors, to_text
    from convasr_tpu_torch.text.ngram_lm import save_arpa, train_ngram_lm
    monkeypatch.setitem(jax_beam._lib_cache, 'lib', None)
    arpa = save_arpa(train_ngram_lm([s.split() for s in TRAIN_TEXTS], order=2),
                     str(tmp_path / 'word.arpa'))
    lp, olen = make_posteriors()
    kw = dict(beam_widths=(2, 4), alphas=(0.0, 0.5, 1.0), betas=(0.0, 0.5, 1.0))
    ours = beam.tune_rescore_weights(torch.from_numpy(lp), olen, REFS, TOK, to_text, arpa, **kw)
    ref = jax_beam.tune_rescore_weights(lp, olen, REFS, TOK, to_text, arpa, **kw)
    assert set(ours) == set(ref) == {2, 4}
    for K in ref:
        assert ours[K]['alpha'] == ref[K]['alpha'] and ours[K]['beta'] == ref[K]['beta']
        for key in ('dev_wer', 'eval_wer', 'oracle_wer'):
            assert ours[K][key] == pytest.approx(ref[K][key], abs=1e-9)
