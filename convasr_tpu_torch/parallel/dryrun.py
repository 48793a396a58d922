"""The port's multi-rank dry run (counterpart of
__graft_entry__.dryrun_multichip): one train step of JasperNetBig at base
width 16 (float32, NovoGrad, the global-norm clip at 100) over a data x model
grid of processes, then the step through the train CLI's data path, a step
from the sharded device cache, sharded inference and the sharded device beam.

    python -m convasr_tpu_torch.parallel.dryrun --ranks N [--device cuda|cpu]
        [--backend gloo|nccl]

N ranks, spawned, meet at a file:// rendezvous. n_model is 2 when N >= 4 and
even, else 1, as in the JAX package, so N = 4 is 2 data x 2 model: every leaf
at least 32 wide (min_channels 32, the JAX dryrun's for its tiny widths) is
sharded over the model group (parallel/tensor_parallel.py). The batch is B =
N / n_model rows of 2048 samples with 8 targets each, B / n_data rows a data
index. Legs 1-3 run on the ranks; legs 4-5 (the
parameters replicated, as in the JAX dryrun) run in this process with the
batch of N + 1 rows split over N devices (parallel/mesh.split_rows), each
checked against the single-device forward and beam. It prints the JAX
dryrun's five lines in the same words.

--device defaults to cuda: rank r takes card r modulo the visible cards and
raises where there is none. --backend defaults to NCCL where every rank has
a card of its own and to Gloo where ranks share one (NCCL refuses that).
--weights FILE starts legs 1-3 from FILE's 'train' state_dict and legs 4-5
from its 'inference' one (default: seeded as the JAX keys 0 and 4 are
used, drawn as flax draws them); --results FILE writes every leg's numbers
(torch.save) for a caller to check.
"""
import argparse
import copy
import json
import multiprocessing
import os
import sys
import tempfile

import numpy as np
import torch

SR = 8000
T, L = 2048, 8
MIN_CHANNELS = 32


def flagship(seed=None):
    """JasperNetBig at base width 16, float32, the 64-band log-mel frontend
    and the 38-class ru char head (__graft_entry__._flagship(16, float32));
    with `seed`, its conv weights drawn as flax draws them."""
    from ..frontend.logmel import LogFilterBankFrontend
    from ..models.jasper import init_as_flax
    from ..models.zoo import create_model
    with torch.random.fork_rng(devices=[]):
        if seed is not None:
            torch.manual_seed(seed)
        model = create_model('JasperNetBig', num_input_features=64, num_classes=(38,),
                             base_width=16, frontend=LogFilterBankFrontend(
                                 out_channels=64, sample_rate=SR, window_size=0.02,
                                 window_stride=0.01, dither=0.0))
        if seed is not None:
            init_as_flax(model)
    return model


def grid_shape(ranks: int):
    """(n_data, n_model) of `ranks` processes, as __graft_entry__.py:74."""
    n_model = 2 if ranks >= 4 and ranks % 2 == 0 else 1
    return ranks // n_model, n_model


def rank_device(device: str, rank: int) -> torch.device:
    if device == 'cpu':
        return torch.device('cpu')
    if not torch.cuda.is_available():
        raise RuntimeError(f'--device {device}: no CUDA device is visible')
    return torch.device('cuda', rank % torch.cuda.device_count())


def _rank(rank, world, device, backend, rdv, inputs_path, out_path):
    """Legs 1-3 on one rank of the grid; the results go to out_path."""
    from ..cli.train import to_host_batch
    from ..data.dataset import AudioTextDataset, frame_count_bucket_fn
    from ..data.device_cache import DeviceDatasetCache, sharded_gather
    from ..data.sampler import BucketingBatchSampler
    from ..ops import ctc_loss
    from ..text import ProcessingPipeline
    from ..train import loop, optim
    from . import mesh, tensor_parallel
    dev = rank_device(device, rank)
    if dev.type == 'cpu':
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    inputs = torch.load(inputs_path, weights_only=False)
    mesh.init_distributed(rdv, world, rank, timeout=600, backend=backend, device=dev)
    try:
        grid = mesh.make_groups(grid_shape(world)[1])
        model = flagship()
        model.load_state_dict(inputs['train'])
        model.to(dev)
        layout = tensor_parallel.state_shardings(model, grid.n_model, min_channels=MIN_CHANNELS)
        tensor_parallel.shard_model_(model, layout, grid)
        tx = loop.make_optimizer_with_accum(
            optim.make_optimizer('novograd', optim.multistep_lr(1e-2, 0.1, [25000, 50000]),
                                 betas=(0.95, 0.98), weight_decay=1e-3), max_grad_norm=100.0)
        state = loop.init_train_state(model, tx)
        step = loop.make_train_step(model, tx)
        ctc_loss.ALPHA_LAUNCHES = ctc_loss.BETA_GRAD_LAUNCHES = 0
        ctc_loss.BETA_GRAD_WARP_LAUNCHES = 0

        def run(batch):
            m = step(state, {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
            return {k: float(v) for k, v in m.items()}

        # 1. a train step on this data index's rows of the batch
        rows = mesh.process_local_batch_slice(inputs['batch']['x'].shape[0])
        metrics = [run({k: v[rows] for k, v in inputs['batch'].items()})]
        # 2. the CLI data path: dataset, bucketing sampler (its data index's
        # share of each global batch), collate, host batch
        config = ProcessingPipeline.load_config(inputs['text_config'])
        ds = AudioTextDataset(inputs['manifest'], [ProcessingPipeline.make(config, 'char_legacy')],
                              SR, time_padding_multiple=128,
                              bucket_fn=frame_count_bucket_fn(0.01, 128), mono=True, pop_meta=True)
        per = inputs['batch']['x'].shape[0] // grid.n_data
        sampler = BucketingBatchSampler(ds, batch_size=per, world_size=grid.n_data)
        idx = next(sampler.shard(grid.data_index))
        _, host = to_host_batch(ds.collate_fn([ds[i] for i in idx]))
        metrics.append(run(host))
        # 3. the sharded device cache: rows over the data indices, gathered
        # over the data group
        cache = DeviceDatasetCache.build(ds, time_padding_multiple=128)
        bucket, cache_rows = cache.locate(idx)
        cache.upload_sharded(grid.data_index, grid.n_data, dev)
        metrics.append(run(sharded_gather(cache.device[bucket],
                                          torch.from_numpy(cache_rows.astype(np.int64)).to(dev),
                                          grid.data_index, grid.n_data, grid.data)))
        torch.save(dict(grid=tuple(grid[:4]), metrics=metrics, launches=dict(
            ctc_loss_alpha=ctc_loss.ALPHA_LAUNCHES,
            ctc_loss_beta_grad_warp=ctc_loss.BETA_GRAD_WARP_LAUNCHES,
            ctc_loss_beta_grad=ctc_loss.BETA_GRAD_LAUNCHES),
            sharded=sum(d is not None for d in layout.values()), leaves=len(layout)), out_path)
    except BaseException:
        mesh.shutdown()      # no barrier: a peer may be stuck in a collective
        raise
    mesh.shutdown(wait=True)


def synthetic_inputs(ranks: int, work: str):
    """The JAX dryrun's data, drawn in its order from RandomState(0): the
    batch, the 2B quarter-second wavs of the CLI data path's manifest, the
    N + 1 inference rows."""
    from ..audio import write_audio
    B = ranks // grid_shape(ranks)[1]
    rng = np.random.RandomState(0)
    batch = dict(x=rng.randn(B, T).astype(np.float32) * 0.1, xlen=np.ones((B,), np.float32),
                 y=rng.randint(0, 37, size=(B, 1, L)).astype(np.int32),
                 ylen=np.full((B, 1), L, np.int32))
    entries = []
    for i in range(2 * B):
        path = os.path.join(work, f'u{i}.wav')
        write_audio(path, (0.1 * rng.randn(1, SR // 4)).astype(np.float32), SR)
        entries.append(dict(audio_path=path, ref=['привет', 'мир'][i % 2], begin=0.0, end=0.25))
    manifest = os.path.join(work, 'train.json')
    with open(manifest, 'w') as f:
        json.dump(entries, f, ensure_ascii=False)
    infer = (rng.randn(ranks + 1, T) * 0.1).astype(np.float32)
    return batch, manifest, infer


def inference_legs(model, x, devices):
    """Legs 4-5: the forward and greedy ids with the rows split over
    `devices`, and the device beam sharded likewise, each against the
    single-device call. Returns their numbers."""
    from ..ops.beam_device import beam_search_device, beam_search_device_sharded
    from .mesh import split_rows
    first = devices[0]
    model = model.to(first).eval()
    models = {d: model if d == first else copy.deepcopy(model).to(d) for d in devices}
    x = torch.from_numpy(x)
    xlen = torch.ones(x.shape[0])

    def fwd(k, xk, xlenk):
        out = models[devices[k]](xk, xlen=xlenk)
        return out['log_probs'][0], out['olen'][0]
    with torch.no_grad():
        lp_1, olen_1 = fwd(0, x.to(first), xlen.to(first))
        lp_dp, olen_dp = split_rows(fwd, devices, x, xlen)
    lp_err = float((lp_dp - lp_1).abs().max())
    assert lp_err <= 1e-5, f'sharded inference log-probs differ by {lp_err}'
    assert torch.equal(lp_dp.argmax(-1), lp_1.argmax(-1)) and torch.equal(olen_dp, olen_1), \
        'sharded greedy ids differ from single-device'
    kw = dict(beam_width=16, cutoff_top_n=8, max_len=int(lp_1.shape[1]) + 1, compact_tokens=True)
    t1, l1, s1 = beam_search_device(lp_1, olen_1.to(torch.int32), 37, **kw)
    tn, ln, sn = beam_search_device_sharded(lp_1, olen_1, 37, devices, **kw)
    assert torch.equal(t1, tn) and torch.equal(l1, ln), 'sharded beam hypotheses differ'
    score_err = float((s1 - sn).abs().max())
    assert score_err <= 1e-4, f'sharded beam scores differ by {score_err}'
    return dict(log_probs=lp_1.cpu(), olen=olen_1.cpu(), lp_err=lp_err, tokens=t1.cpu(),
                lengths=l1.cpu(), scores=s1.cpu(), score_err=score_err)


def run(ranks: int, device: str = 'cuda', backend=None, weights=None, results=None):
    """The five legs at `ranks` processes; prints the JAX dryrun's lines and
    returns the results."""
    from . import dryrun as this    # the ranks' target by its module name
    if device != 'cpu' and not torch.cuda.is_available():
        raise RuntimeError(f'--device {device}: no CUDA device is visible')
    cards = torch.cuda.device_count() if device != 'cpu' else 0
    if backend is None:
        backend = 'nccl' if device != 'cpu' and cards >= ranks else 'gloo'
    given = torch.load(weights, weights_only=False) if weights else {}
    with tempfile.TemporaryDirectory() as work:
        batch, manifest, infer = synthetic_inputs(ranks, work)
        inputs = os.path.join(work, 'inputs.pt')
        torch.save(dict(batch=batch, manifest=manifest, train=given.get('train') or
                        flagship(seed=0).state_dict(), text_config=os.path.join(
                            os.path.dirname(__file__), '..', '..', 'configs',
                            'ru_text_config.json')), inputs)
        ctx = multiprocessing.get_context('spawn')
        outs = [os.path.join(work, f'r{r}.pt') for r in range(ranks)]
        procs = [ctx.Process(target=this._rank, args=(r, ranks, device, backend,
                                                        f'file://{work}/rdv', inputs, outs[r]))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=900)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * ranks:
            raise RuntimeError(f'dryrun ranks exited with {codes}')
        per_rank = [torch.load(o, weights_only=False) for o in outs]
    metrics = per_rank[0]['metrics']
    for r in per_rank[1:]:
        for a, b in zip(r['metrics'], metrics):
            np.testing.assert_allclose(a['loss'], b['loss'], rtol=1e-6)
    losses = [m['loss'] for m in metrics]
    assert np.isfinite(losses).all(), f'non-finite loss in the dryrun: {losses}'
    print(f'dryrun_multichip({ranks}): loss={losses[0]:.4f} '
          f'grad_norm={metrics[0]["grad_norm"]:.4f}')
    print(f'dryrun_multichip({ranks}) CLI data path: loss={losses[1]:.4f}')
    print(f'dryrun_multichip({ranks}) sharded-device-cache path: loss={losses[2]:.4f}')
    first = rank_device(device, 0)
    devices = [torch.device('cuda', k) for k in range(ranks)] if cards >= ranks \
        else [first] * ranks
    model = flagship(seed=None if 'inference' in given else 4)
    if 'inference' in given:
        model.load_state_dict(given['inference'])
    inference = inference_legs(model, infer, devices)
    print(f'dryrun_multichip({ranks}) sharded-inference path: B={ranks + 1} greedy ids match '
          f'single-device')
    print(f'dryrun_multichip({ranks}) sharded-device-beam path: B={ranks + 1} top-16 '
          f'hypotheses match single-device')
    out = dict(ranks=per_rank, losses=losses, grad_norm=metrics[0]['grad_norm'],
               backend=backend, grid=grid_shape(ranks), **inference)
    if results:
        torch.save(out, results)
    return out


def build_parser():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--ranks', type=int, default=4)
    parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    parser.add_argument('--backend', default=None, choices=['gloo', 'nccl'])
    parser.add_argument('--weights', default=None,
                        help="torch.save'd {'train': state_dict, 'inference': state_dict}")
    parser.add_argument('--results', default=None, help="write every leg's numbers here")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    run(args.ranks, args.device, args.backend, args.weights, args.results)
    return 0


if __name__ == '__main__':
    sys.exit(main())
