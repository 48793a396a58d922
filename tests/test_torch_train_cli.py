"""The port's train CLI on the CPU: the smoke run of the JAX CLI's tests
(JasperNetSmall, 16 features, a synthetic corpus made with numpy), exact
resume, a checkpoint on SIGTERM, validation with the beam decoders, unported
flags."""
import json
import os
import pathlib
import signal

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
SR = 8000


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    from convasr_tpu_torch.audio import write_audio
    tmp = tmp_path_factory.mktemp('torch_train_cli')
    rng = np.random.RandomState(0)
    entries = []
    for i in range(8):
        path = str(tmp / f'u{i}.wav')
        dur = 0.5 + 0.25 * (i % 2)
        write_audio(path, (0.1 * rng.randn(1, int(SR * dur))).astype(np.float32), SR)
        entries.append(dict(audio_path=path, ref=['привет', 'мир'][i % 2], begin=0.0, end=dur))
    for name, items in (('train.json', entries), ('val.json', entries[:4])):
        with open(tmp / name, 'w') as f:
            json.dump(items, f, ensure_ascii=False)
    return tmp


def make_args(corpus, exp_dir, *extra):
    from convasr_tpu_torch.cli.train import build_parser
    return build_parser().parse_args([
        '--device', 'cpu', '--model', 'JasperNetSmall', '--num-input-features', '16',
        '--base-width', '8',
        '--train-data-path', str(corpus / 'train.json'),
        '--val-data-path', str(corpus / 'val.json'),
        '--experiments-dir', str(exp_dir), '--experiment-id', 'smoke',
        '--train-batch-size', '2', '--val-batch-size', '4', '--iterations', '4',
        '--log-iteration-interval', '1', '--val-iteration-interval', '4', '--epochs', '2',
        '--bf16', 'false', '--num-workers', '0', '--batch-time-padding-multiple', '128',
        '--text-config', str(ROOT / 'configs' / 'ru_text_config.json'),
        '--val-config', str(ROOT / 'configs' / 'ru_val_config.json')] + list(extra))


def log_lines(exp_dir):
    return (exp_dir / 'smoke' / 'log.txt').read_text().splitlines()


def final_weights(exp_dir, iteration):
    from convasr_tpu_torch.train.checkpoints import load_train_checkpoint
    paths = sorted((exp_dir / 'smoke').glob(f'checkpoint_epoch*_iter{iteration:07d}.pt'))
    assert paths, os.listdir(exp_dir / 'smoke')
    return load_train_checkpoint(str(paths[-1]))


def test_smoke_train_logs_and_checkpoint(corpus, tmp_path):
    from convasr_tpu_torch.cli import train
    train.main(make_args(corpus, tmp_path))
    lines = log_lines(tmp_path)
    steps = [l for l in lines if ' iter ' in l and ' loss ' in l and 'grad_norm' in l]
    assert len(steps) == 4 and all(' lr ' in l for l in steps), lines
    assert any('WER:' in l and 'CER:' in l for l in lines), lines
    logged = [json.loads(l) for l in (tmp_path / 'smoke' / 'log.json').read_text().splitlines()]
    assert [l['iteration'] for l in logged] == [1, 2, 3, 4]
    assert all(np.isfinite(l['loss']) for l in logged)
    args = json.loads((tmp_path / 'smoke' / 'args.json').read_text())
    assert args['model'] == 'JasperNetSmall' and args['optimizer'] == 'NovoGrad'
    ckpt = final_weights(tmp_path, 4)
    assert ckpt['step'] == 4 and ckpt['opt_state'] is not None


def test_resume_is_exact(corpus, tmp_path):
    """2 iterations, a checkpoint, a new process's worth of state from it,
    2 more: the same weights as 4 straight (dropout 0.2 and dither on; the
    generator's state rides in the checkpoint)."""
    from convasr_tpu_torch.cli import train
    train.main(make_args(corpus, tmp_path / 'straight'))
    train.main(make_args(corpus, tmp_path / 'cut', '--iterations', '2',
                         '--val-iteration-interval', '2'))
    first = tmp_path / 'cut' / 'smoke' / 'checkpoint_epoch00_iter0000002.pt'
    assert first.exists()
    train.main(make_args(corpus, tmp_path / 'cut', '--checkpoint', str(first)))
    straight, resumed = final_weights(tmp_path / 'straight', 4), final_weights(tmp_path / 'cut', 4)
    for name, value in straight['model_state_dict'].items():
        assert torch.equal(value, resumed['model_state_dict'][name]), name
    logged = [json.loads(l) for l in (tmp_path / 'cut' / 'smoke' / 'log.json').read_text().splitlines()]
    assert [l['iteration'] for l in logged] == [1, 2, 3, 4]


def test_sigterm_saves_a_checkpoint(corpus, tmp_path, monkeypatch):
    """A real SIGTERM during step 3: the run saves a checkpoint at iteration
    3 and returns; resuming from it ends where an uninterrupted run ends."""
    from convasr_tpu_torch.cli import train
    make_step = train.make_train_step

    def step_with_sigterm(*a, **kw):
        step = make_step(*a, **kw)

        def wrapped(state, batch, generator=None):
            if state.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(state, batch, generator)
        return wrapped

    monkeypatch.setattr(train, 'make_train_step', step_with_sigterm)
    before = signal.getsignal(signal.SIGTERM)
    train.main(make_args(corpus, tmp_path / 'pre'))
    assert signal.getsignal(signal.SIGTERM) is before
    saved = tmp_path / 'pre' / 'smoke' / 'checkpoint_epoch00_iter0000003.pt'
    assert saved.exists(), os.listdir(tmp_path / 'pre' / 'smoke')
    assert any('SIGTERM' in l for l in log_lines(tmp_path / 'pre'))
    monkeypatch.setattr(train, 'make_train_step', make_step)
    train.main(make_args(corpus, tmp_path / 'pre', '--checkpoint', str(saved)))
    train.main(make_args(corpus, tmp_path / 'base'))
    ours, base = final_weights(tmp_path / 'pre', 4), final_weights(tmp_path / 'base', 4)
    for name, value in base['model_state_dict'].items():
        assert torch.equal(value, ours['model_state_dict'][name]), name


@pytest.mark.parametrize('decoder', [['BeamSearchDecoderDevice'],
                                     ['BeamSearchDecoder', '--decoder-topk', '2']],
                         ids=['device_beam', 'host_beam_oracle_top2'])
def test_validation_with_a_beam_decoder(corpus, tmp_path, monkeypatch, decoder):
    """Validation decodes with --decoder: the device beam on the log-probs
    where the model left them, or the host C++ beam with oracle error rates
    over its top 2 hypotheses."""
    from convasr_tpu_torch.cli import train
    from convasr_tpu_torch.decode import beam
    from convasr_tpu_torch.ops import beam_device
    calls = []
    if decoder[0] == 'BeamSearchDecoderDevice':
        search = beam_device.beam_search_device

        def spy(log_probs, *a, **kw):
            calls.append(torch.is_tensor(log_probs))
            return search(log_probs, *a, **kw)
        monkeypatch.setattr(beam_device, 'beam_search_device', spy)
    else:
        decode_one = beam.BeamSearchDecoder.decode_one

        def spy(self, *a, **kw):
            hyps = decode_one(self, *a, **kw)
            calls.append(len(hyps) == 2)
            return hyps
        monkeypatch.setattr(beam.BeamSearchDecoder, 'decode_one', spy)
    train.main(make_args(corpus, tmp_path, '--iterations', '2', '--val-iteration-interval', '2',
                         '--decoder', *decoder, '--beam-width', '4'))
    assert calls and all(calls), calls
    lines = log_lines(tmp_path)
    assert any('WER:' in l and 'CER:' in l for l in lines), lines


@pytest.mark.parametrize('flag', [['--spec-augment'], ['--device-cache'], ['--remat'],
                                  ['--adapt-bn'], ['--num-processes', '2']])
def test_unported_flags_raise(corpus, tmp_path, flag):
    from convasr_tpu_torch.cli import train
    with pytest.raises(NotImplementedError, match='not yet ported'):
        train.main(make_args(corpus, tmp_path, *flag))


def test_reference_checkpoint_raises(corpus, tmp_path):
    """A reference convasr .pt (backbone.* keys) is not read yet."""
    from convasr_tpu_torch.cli import train
    path = tmp_path / 'reference.pt'
    torch.save(dict(model_state_dict={'backbone.0.conv.0.0.weight': torch.zeros(2, 2, 3)},
                    args={}), path)
    with pytest.raises(NotImplementedError, match='not yet ported'):
        train.main(make_args(corpus, tmp_path, '--checkpoint', str(path)))


def test_cuda_default_raises_without_card(corpus, tmp_path, monkeypatch):
    from convasr_tpu_torch.cli import train
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = make_args(corpus, tmp_path)
    args.device = train.build_parser().get_default('device')
    assert args.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train.main(args)
