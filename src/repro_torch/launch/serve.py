"""Retired entry point -- use :mod:`repro_torch.serve` instead.

Counterpart of ``repro.launch.serve``: the module that served token
decoding for the language-model code the repo was seeded from is a stub.
The serving surface of this package is the sweep farm:

    python -m repro_torch serve DIR          # the server
    python -m repro_torch.serve.smoke        # its crash drill

``main`` prints that pointer and returns 2.
"""
from __future__ import annotations

import sys

_MSG = ("repro_torch.launch.serve is retired: it served language-model "
        "token decoding, not Ising sweeps.  Use the sweep-farm service "
        "instead: `python -m repro_torch serve DIR` (repro_torch.serve).")


def main(argv=None) -> int:
    print(_MSG, file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
