"""Weights made from the seed on the device, the same for the program and the
reference: every conv kernel lecun-normal (std 1 / sqrt(fan_in)) out of one
draw of a `torch.Generator` on the card, every bias 0, every norm scale 1.
The names and shapes come from the configuration (model_plan.param_plan),
and the program's model takes them by name, as from a checkpoint."""
import math

import torch

from . import model_plan


def draw(config: dict, seed: int, device) -> dict:
    """{name: float32 tensor on `device`} for every parameter of `config`."""
    plan = model_plan.param_plan(arch_of(config), classes_of(config))
    convs = [(n, s) for n, s, kind in plan if kind == 'conv']
    total = sum(math.prod(s) for _, s in convs)
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in plan:
        if kind == 'conv':
            n = math.prod(shape)
            w = flat[at:at + n].view(shape)
            w.mul_(float(shape[1] * shape[2]) ** -0.5)
            out[name] = w
            at += n
        elif kind == 'scale':
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def load_into(model: torch.nn.Module, weights: dict):
    """Copies the drawn weights into the program's parameters by name; the
    two sets of names and shapes must be equal."""
    params = dict(model.named_parameters())
    assert set(params) == set(weights), (sorted(set(params) ^ set(weights)))[:8]
    with torch.no_grad():
        for name, p in params.items():
            assert tuple(p.shape) == tuple(weights[name].shape), name
            p.copy_(weights[name])


def arch_of(config: dict) -> dict:
    return dict(config['architecture'],
                num_input_features=config['frontend']['num_input_features'])


def classes_of(config: dict) -> list:
    return [h['classes'] for h in config['heads']]
