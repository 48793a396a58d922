"""The program's inference entry that the transcribe and stream cells share:
`cli/transcribe.setup` of the port, as the transcribe CLI and the gRPC server
call it, given a checkpoint file that holds the configuration's
architecture and no weights, then the seeded weights copied in by name."""
import pathlib

import torch

from perfbench import weights as weights_lib

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def args_checkpoint(config: dict) -> str:
    """A checkpoint of the configuration's arguments and no weights, at a
    fixed path inside the checkout (a few hundred bytes)."""
    path = CHECKOUT / 'build' / 'perfbench' / f'{config["name"]}.args.pt'
    path.parent.mkdir(parents=True, exist_ok=True)
    fe = config['frontend']
    args = dict(config['architecture'], model=config['model'],
                sample_rate=fe['sample_rate'], window_size=fe['window_size'],
                window_stride=fe['window_stride'], window=fe['window'],
                num_input_features=fe['num_input_features'],
                text_pipelines=[h['pipeline'] for h in config['heads']])
    torch.save(dict(model_state_dict={}, args=args), path)
    return str(path)


def setup(run, **flags):
    """(text_pipeline, model, forward, generator, args) of the port's
    transcribe setup at the run's configuration and device; `flags` set
    other arguments of the transcribe CLI."""
    from convasr_tpu_torch.cli import transcribe as cli
    config = run.config
    args = cli.build_parser().parse_args(['--checkpoint', args_checkpoint(config), '-i', '-'])
    args.device = torch.device(run.device).type
    args.bf16 = config['dtype'] == 'bfloat16'
    args.model = config['model']
    for k, v in flags.items():
        setattr(args, k, v)
    text_pipeline, _, model, forward, generator, decoder = cli.setup(args)
    assert decoder is None, 'the greedy path has no decoder object'
    weights_lib.load_into(model, weights_lib.draw(config, run.seed, forward.device))
    return text_pipeline, model, forward, generator, args
