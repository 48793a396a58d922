"""NovoGrad's fused update (csrc/novograd_update.cu) alone on the card: the
kernel part of chip_smoke.py's phase 6 (`fused_update_phase`) without the
rest of the script, at the train cells' two leaf sets: the fused update held
to the chain it replaces for 4 steps, the batch norms' stash and restore,
and the kernels' times beside the chain's and the bound.

    python scripts/novograd_update_probe.py [--out build/measurements/novograd_update_probe.json]

Prints the card's name and power limit, the phase's lines and the kernels'
records; writes the records as JSON. Any failed check raises.
"""
import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import SPLITS, fused_update_phase  # noqa: E402
from convasr_tpu_torch.ops import novograd_update  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--out', default=str(ROOT / 'build' / 'measurements' /
                                             'novograd_update_probe.json'))
    args = parser.parse_args()
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True).stdout.strip()
    print(f'card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}', flush=True)
    records = fused_update_phase(torch.device('cuda'))
    print(json.dumps(dict(kernels=records)), flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, kernels=records), indent=1))
    print(f'wrote {out}; kernel splits not measured: {SPLITS["unmeasured"]} of '
          f'{SPLITS["asked"]}; build: {novograd_update.build.BUILD_LOG.get("novograd_update")}')


if __name__ == '__main__':
    main()
