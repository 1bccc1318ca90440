"""Vanilla-NeRF driver (port of ``plnerf/cli/run_vanilla.py``): the same
task surface as ``run_plnerf`` but one joint Adam over coarse + fine and
no constant-init warm-up, as the reference ``run_nerf_vanilla.py``."""
from __future__ import annotations

from .run_plnerf import main as _main


def main(argv=None):
    return _main(argv, vanilla=True)


if __name__ == "__main__":
    main()
