"""Export a checkpoint of the port or of the JAX package to the reference's
``.tar`` format (port of ``tools/export_reference_ckpt.py``):

    python -m plnerf_torch.tools.export_reference_ckpt \\
        --ckpt logs/exp/050000.ckpt --out exp_050000.tar [--lr 5e-4] \\
        [--fresh_opt]

The input is told by its first bytes (``checkpoint.flax_msgpack``): a
port checkpoint (``torch.save``) or a JAX package one (flax msgpack).
Neither needs the training args: both are keyed by field name.  The fine
Adam's moments go out in the reference's parameter order for the viewdirs
topology (``checkpoint.convert_torch``); ``--fresh_opt`` writes a
pre-first-step Adam state instead.  A joint checkpoint (run_vanilla,
run_depth: no coarse optimizer) exports its Adam over coarse then fine.
The depth script's scale / shift tensors go out when present.  Runs on
the CPU.
"""
from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoint import convert_jax, convert_torch, flax_msgpack


def _tensors(sd: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in sd.items()}


def read_checkpoint(path: str, fresh_opt: bool = False):
    """(step, coarse state dict, fine state dict or None, fine_adam or
    None, joint, extras) of a port or JAX package checkpoint."""
    if flax_msgpack.is_flax_file(path):
        raw = flax_msgpack.read_state(path)

        def sd(tree):
            return _tensors(convert_jax.params_to_state_dict(tree))
        step = int(np.asarray(raw["step"]))
        sd_c = sd(raw["params_coarse"])
        sd_f = sd(raw["params_fine"]) if raw.get("params_fine") else None
        joint = raw.get("opt_coarse") is None and sd_f is not None
        fine_adam = None
        adam = convert_jax.find_adam(raw.get("opt_fine"))
        if not fresh_opt and sd_f is not None and adam is not None:
            mu, nu = ((tuple(sd(t) for t in adam[m]) if joint
                       else sd(adam[m])) for m in ("mu", "nu"))
            fine_adam = (mu, nu, int(np.asarray(adam["count"])))
        extras = {k: torch.as_tensor(np.asarray(raw[k], np.float32))
                  for k in ("depth_scales", "depth_shifts")
                  if raw.get(k) is not None}
        return step, sd_c, sd_f, fine_adam, joint, extras

    ck = torch.load(path, map_location="cpu", weights_only=True)
    sd_c, sd_f = ck["params_coarse"], ck.get("params_fine")
    joint = ck.get("opt_coarse") is None and sd_f is not None
    fine_adam: Optional[Any] = None
    if not fresh_opt and sd_f is not None and "opt_fine" in ck:
        fine_adam = convert_torch.adam_moments(
            ck["opt_fine"], [sd_c, sd_f] if joint else [sd_f])
    extras = {k: ck[k] for k in ("depth_scales", "depth_shifts")
              if ck.get(k) is not None}
    return int(ck["step"]), sd_c, sd_f, fine_adam, joint, extras


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True,
                    help="a .ckpt of the port or of the JAX package")
    ap.add_argument("--out", required=True, help="output .tar path")
    ap.add_argument("--lr", type=float, default=5e-4,
                    help="lr recorded in the exported Adam param_group "
                         "(the reference overwrites it every step)")
    ap.add_argument("--fresh_opt", action="store_true",
                    help="write a pre-first-step Adam state instead of the "
                         "checkpoint's real moments")
    args = ap.parse_args(argv)
    step, sd_c, sd_f, fine_adam, joint, extras = read_checkpoint(
        args.ckpt, args.fresh_opt)
    kind = convert_torch.save_reference_checkpoint(
        args.out, step, sd_c, sd_f, fine_adam=fine_adam, lr=args.lr,
        joint=joint, extras=extras)
    print(f"wrote {args.out}: step {step}, "
          f"fine={'yes' if sd_f is not None else 'no'}, {kind}"
          + (f", extras={sorted(extras)}" if extras else ""))


if __name__ == "__main__":
    main()
