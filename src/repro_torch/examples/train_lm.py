"""End-to-end LM training example: train a reduced config for a few
dozen steps with checkpoint/restart fault tolerance (counterpart of the
JAX package's ``examples/train_lm.py``, with its arguments).

Run:  python -m repro_torch.examples.train_lm [--device cpu] [--ckpt-dir D]
(the checkpoints go to ``repro_torch_train_ck`` under the temporary
directory unless ``--ckpt-dir`` names another; a second run resumes
from them; larger runs: ``python -m repro_torch.launch.train --arch
internlm2-1.8b --smoke --steps 300``)
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_lm",
        description="train internlm2-1.8b's smoke config for 60 steps")
    ap.add_argument("--device", default="",
                    help="one torch device, e.g. cpu (default: every CUDA card)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ck"))
    args = ap.parse_args(argv)
    extra = ["--device", args.device] if args.device else []
    return train_main(["--arch", "internlm2-1.8b", "--smoke", "--steps", "60",
                       "--batch", "8", "--seq", "64", "--lr", "3e-3",
                       "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "25",
                       "--log-every", "10", *extra])


if __name__ == "__main__":
    sys.exit(main())
