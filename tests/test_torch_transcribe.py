"""The port's transcribe CLI against the JAX package's: the same wav and
reference JSON, the JAX CLI on an orbax checkpoint and the port's CLI on the
weights carried across, both on the CPU in float32."""
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parent.parent
SR = 8000
REFS = ['привет мир', 'раз два три', 'доброе утро']


@pytest.fixture(scope='module')
def checkpoints_and_audio(tmp_path_factory):
    from convasr_tpu.audio import write_audio
    from convasr_tpu.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu.models.zoo import create_model
    from convasr_tpu.train.checkpoints import restore_checkpoint, save_checkpoint
    from convasr_tpu.train.loop import TrainState
    from convasr_tpu_torch.models.convert import from_jax_params

    tmp = tmp_path_factory.mktemp('torch_transcribe')
    frontend = LogFilterBankFrontend(out_channels=16, sample_rate=SR, window_size=0.02,
                                     window_stride=0.01, dither=0.0)
    model = create_model('JasperNetSmall', num_input_features=16, num_classes=(38,),
                         frontend=frontend, base_width=8)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, SR), jnp.float32),
                           xlen=jnp.ones((1,), jnp.float32))
    state = TrainState(step=jnp.zeros([], jnp.int32), params=variables['params'],
                       batch_stats=variables['batch_stats'], opt_state={})
    args = dict(model='JasperNetSmall', sample_rate=SR, window_size=0.02,
                window_stride=0.01, window='hann_window', num_input_features=16,
                text_config=str(ROOT / 'configs' / 'ru_text_config.json'),
                text_pipelines=['char_legacy'], base_width=8)
    jax_ckpt = str(tmp / 'ckpt')
    save_checkpoint(jax_ckpt, state, epoch=0, args=args)

    payload, meta = restore_checkpoint(jax_ckpt)
    torch_ckpt = str(tmp / 'ckpt.pt')
    torch.save(dict(model_state_dict=from_jax_params(payload['params'], payload['batch_stats']),
                    args=meta['args']), torch_ckpt)

    wav_path = str(tmp / 'utt.wav')
    rng = np.random.RandomState(0)
    write_audio(wav_path, (0.1 * rng.randn(1, SR * 3)).astype(np.float32), SR)
    ref_json = str(tmp / 'utt.json')
    with open(ref_json, 'w') as f:
        json.dump([dict(audio_path=wav_path, ref=r, begin=float(k), end=k + 0.9)
                   for k, r in enumerate(REFS)], f, ensure_ascii=False)
    return jax_ckpt, torch_ckpt, ref_json, tmp


@pytest.fixture(scope='module')
def dual_head_checkpoints(tmp_path_factory, checkpoints_and_audio):
    """A char + BPE two-head JasperNetSmall, saved by the JAX package and
    carried across to the port."""
    from convasr_tpu.frontend.logmel import LogFilterBankFrontend
    from convasr_tpu.models.zoo import create_model
    from convasr_tpu.text import ProcessingPipeline, train_bpe
    from convasr_tpu.train.checkpoints import save_checkpoint
    from convasr_tpu.train.loop import TrainState
    from convasr_tpu_torch.models.convert import from_jax_params

    tmp = tmp_path_factory.mktemp('torch_transcribe_dual')
    bpe_model = str(tmp / 'bpe.json')
    train_bpe(REFS * 3, vocab_size=24, model_path=bpe_model)
    config = json.load(open(ROOT / 'configs' / 'ru_text_config.json'))
    config['tokenizers']['bpe'] = {'class': 'BPETokenizer', 'model_path': bpe_model}
    config['pipelines']['bpe'] = dict(tokenizer='bpe', preprocessor='default',
                                      postprocessor='default')
    text_config = str(tmp / 'text_config.json')
    json.dump(config, open(text_config, 'w'), ensure_ascii=False)
    pipes = [ProcessingPipeline.make(config, n) for n in ('char_legacy', 'bpe')]
    model = create_model('JasperNetSmall', num_input_features=16,
                         num_classes=tuple(p.tokenizer.vocab_size for p in pipes),
                         decoder_type='bpe', base_width=8, frontend=LogFilterBankFrontend(
                             out_channels=16, sample_rate=SR, window_size=0.02,
                             window_stride=0.01, dither=0.0))
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, SR), jnp.float32),
                           xlen=jnp.ones((1,), jnp.float32))
    args = dict(model='JasperNetSmall', sample_rate=SR, window_size=0.02,
                window_stride=0.01, window='hann_window', num_input_features=16,
                text_config=text_config, text_pipelines=['char_legacy', 'bpe'], base_width=8)
    jax_ckpt = str(tmp / 'ckpt')
    save_checkpoint(jax_ckpt, TrainState(step=jnp.zeros([], jnp.int32),
                                         params=variables['params'],
                                         batch_stats=variables['batch_stats'], opt_state={}),
                    epoch=0, args=args)
    torch_ckpt = str(tmp / 'ckpt.pt')
    torch.save(dict(model_state_dict=from_jax_params(variables['params'],
                                                     variables['batch_stats']),
                    args=args), torch_ckpt)
    return jax_ckpt, torch_ckpt, checkpoints_and_audio[2], tmp


def run(package, ckpt, ref_json, out_dir, extra):
    if package == 'jax':
        from convasr_tpu.cli.transcribe import build_parser, main
    else:
        from convasr_tpu_torch.cli.transcribe import build_parser, main
    main(build_parser().parse_args(
        ['--checkpoint', ckpt, '-i', ref_json, '-o', out_dir, '--device', 'cpu',
         '--bf16', 'false', '--mono', '--output-json'] + extra))
    with open(os.path.join(out_dir, 'utt.wav.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('extra', [['--align'], [], ['--quantize', 'int8'],
                                   ['--quantize', 'int8', '--align']],
                         ids=['align', 'fused_int16', 'int8', 'int8_align'])
def test_port_cli_matches_jax_cli(checkpoints_and_audio, extra, capsys):
    """Under --quantize int8 both CLIs read one activation-scales cache,
    written by the JAX run's calibration."""
    jax_ckpt, torch_ckpt, ref_json, tmp = checkpoints_and_audio
    name = '_'.join(extra) or 'fused'
    if '--quantize' in extra:
        extra = extra + ['--calibration-cache', str(tmp / f'act_scales_{name}.npz')]
    ref = run('jax', jax_ckpt, ref_json, str(tmp / f'jax_{name}'), extra)
    if '--quantize' in extra:
        assert os.path.exists(extra[-1])
    capsys.readouterr()
    ours = run('torch', torch_ckpt, ref_json, str(tmp / f'torch_{name}'), extra)
    if '--quantize' in extra:
        assert 'int8 PTQ: calibrated on 1 batch(es)' in capsys.readouterr().out
    assert len(ours) == len(ref) == len(REFS)
    for o, r in zip(ours, ref):
        assert o['hyp'] == r['hyp'] and o['ref'] == r['ref']
        assert o['cer'] == r['cer']
        np.testing.assert_allclose([o['begin'], o['end']], [r['begin'], r['end']], atol=1e-6)
        assert set(o) == set(r)


@pytest.mark.parametrize('pipeline', ['char_legacy', 'bpe'])
def test_dual_head_pipeline_matches_jax(dual_head_checkpoints, pipeline):
    jax_ckpt, torch_ckpt, ref_json, tmp = dual_head_checkpoints
    extra = ['--align', '--pipeline', pipeline]
    ref = run('jax', jax_ckpt, ref_json, str(tmp / f'jax_{pipeline}'), extra)
    ours = run('torch', torch_ckpt, ref_json, str(tmp / f'torch_{pipeline}'), extra)
    assert [(o['hyp'], o['ref'], o['cer']) for o in ours] == \
        [(r['hyp'], r['ref'], r['cer']) for r in ref]
    np.testing.assert_allclose([[o['begin'], o['end']] for o in ours],
                               [[r['begin'], r['end']] for r in ref], atol=1e-6)


def test_unported_flag_raises(checkpoints_and_audio):
    _, torch_ckpt, ref_json, tmp = checkpoints_and_audio
    with pytest.raises(NotImplementedError, match='not yet ported'):
        run('torch', torch_ckpt, ref_json, str(tmp / 'beam'),
            ['--decoder', 'BeamSearchDecoder'])


def test_cuda_default_raises_without_card(checkpoints_and_audio, monkeypatch):
    from convasr_tpu_torch.cli.transcribe import build_parser, setup
    _, torch_ckpt, ref_json, _ = checkpoints_and_audio
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    args = build_parser().parse_args(['--checkpoint', torch_ckpt, '-i', ref_json])
    assert args.device == 'cuda'
    with pytest.raises(RuntimeError, match='no CUDA device'):
        setup(args)
