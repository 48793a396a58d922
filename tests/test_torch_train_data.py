"""The port's copies of the training slice's host modules against the JAX
package's: samplers, dataset persistence, the prefetching loader, the error
analyzer, and the checkpoint helpers."""
import json
import pathlib

import numpy as np
import pytest
import torch

from convasr_tpu.data import sampler as jax_sampler
from convasr_tpu.data.dataset import AudioTextDataset as JaxDataset
from convasr_tpu.data.dataset import frame_count_bucket_fn as jax_bucket_fn
from convasr_tpu.metrics import ErrorAnalyzer as JaxAnalyzer
from convasr_tpu.text import ProcessingPipeline as JaxPipeline
from convasr_tpu_torch.data import sampler
from convasr_tpu_torch.data.dataset import AudioTextDataset, frame_count_bucket_fn
from convasr_tpu_torch.data.loader import PrefetchLoader
from convasr_tpu_torch.metrics import ErrorAnalyzer
from convasr_tpu_torch.text import ProcessingPipeline
from convasr_tpu_torch.train import checkpoints

ROOT = pathlib.Path(__file__).resolve().parent.parent
SR = 8000


@pytest.fixture(scope='module')
def manifest(tmp_path_factory):
    from convasr_tpu_torch.audio import write_audio
    tmp = tmp_path_factory.mktemp('torch_train_data')
    rng = np.random.RandomState(0)
    entries = []
    for i in range(11):
        dur = 0.4 + 0.3 * (i % 4)
        path = str(tmp / f'u{i}.wav')
        write_audio(path, (0.1 * rng.randn(1, int(SR * dur))).astype(np.float32), SR)
        entries.append(dict(audio_path=path, ref=['привет мир', 'раз два', 'три'][i % 3],
                            begin=0.0, end=dur))
    path = tmp / 'train.json'
    path.write_text(json.dumps(entries, ensure_ascii=False))
    return str(path)


def datasets(manifest):
    config = str(ROOT / 'configs' / 'ru_text_config.json')
    ours = AudioTextDataset(manifest, [ProcessingPipeline.make(
        ProcessingPipeline.load_config(config), 'char_legacy')], SR,
        time_padding_multiple=128, bucket_fn=frame_count_bucket_fn(0.01, 32))
    ref = JaxDataset(manifest, [JaxPipeline.make(JaxPipeline.load_config(config), 'char_legacy')],
                     SR, time_padding_multiple=128, bucket_fn=jax_bucket_fn(0.01, 32))
    return ours, ref


@pytest.mark.parametrize('batch_size,epoch', [(2, 0), (3, 1), (4, 5)])
def test_bucketing_sampler_matches_jax(manifest, batch_size, epoch):
    ours, ref = datasets(manifest)
    np.testing.assert_array_equal(ours.bucket, ref.bucket)
    s, r = sampler.BucketingBatchSampler(ours, batch_size), \
        jax_sampler.BucketingBatchSampler(ref, batch_size)
    s.set_epoch(epoch)
    r.set_epoch(epoch)
    assert list(s) == list(r) and len(s) == len(r)
    s.batch_idx = r.batch_idx = 2
    resumed = sampler.BucketingBatchSampler(ours, batch_size)
    resumed.set_epoch(epoch)
    resumed.load_state_dict(s.state_dict())
    assert list(resumed) == list(r)


def test_mixing_sampler_matches_jax(manifest):
    ours, ref = datasets(manifest)
    s = sampler.MixingBatchSampler([sampler.BucketingBatchSampler(ours, 2),
                                    sampler.BucketingBatchSampler(ours, 3)], [0.3, 0.7], seed=4)
    r = jax_sampler.MixingBatchSampler([jax_sampler.BucketingBatchSampler(ref, 2),
                                        jax_sampler.BucketingBatchSampler(ref, 3)],
                                       [0.3, 0.7], seed=4)
    assert list(s) == list(r)


def test_dataset_state_dict_round_trip(manifest):
    ours, _ = datasets(manifest)
    copy = AudioTextDataset([], ours.text_pipelines, SR, time_padding_multiple=128)
    copy.load_state_dict(ours.state_dict())
    assert len(copy) == len(ours) and copy.ref.tolist() == ours.ref.tolist()
    assert copy.unpack_transcript(3) == ours.unpack_transcript(3)


@pytest.mark.parametrize('num_workers', [0, 2])
def test_prefetch_loader_collates_in_order(manifest, num_workers):
    ours, ref = datasets(manifest)
    batches = [[0, 1], [2, 3, 4], [5]]
    for got, indices in zip(PrefetchLoader(ours, batches, num_workers=num_workers), batches):
        want = ref.collate_fn([ref[i] for i in indices])
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(a, b)


def test_error_analyzer_matches_jax():
    config = json.loads((ROOT / 'configs' / 'ru_val_config.json').read_text())['error_analyzer']
    pairs = [('привет мир', 'привет мир'), ('превет ми', 'привет мир'), ('раз три', 'раз два три'),
             ('', 'доброе утро'), ('один два три четыре', 'один две три')]
    ours, ref = ErrorAnalyzer(configs=config), JaxAnalyzer(configs=config)
    a = [ours.analyze(h, r, detailed=True) for h, r in pairs]
    b = [ref.analyze(h, r, detailed=True) for h, r in pairs]
    assert a == b
    assert json.dumps(ours.aggregate(a), sort_keys=True) == json.dumps(ref.aggregate(b),
                                                                       sort_keys=True)


def test_checkpoint_helpers(tmp_path):
    model = torch.nn.Linear(3, 2)
    paths = []
    for it, w in enumerate([1.0, 2.0, 6.0]):
        with torch.no_grad():
            model.weight.fill_(w)
        paths.append(checkpoints.save_checkpoint(
            checkpoints.checkpoint_path(str(tmp_path), 0, it + 1), model, dict(model='x')))
    assert paths[0].endswith('checkpoint_epoch00_iter0000001.pt')
    avg = checkpoints.average_checkpoints(paths)
    assert torch.allclose(avg['weight'], torch.full((2, 3), 3.0))
    removed = checkpoints.remove_old_checkpoints(str(tmp_path), keep_last=1, keep_iterations=[1])
    assert removed == [paths[1]]
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ['checkpoint_epoch00_iter0000001.pt', 'checkpoint_epoch00_iter0000003.pt']
