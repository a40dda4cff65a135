"""Convert a reference PyTorch-Lightning checkpoint to a state-dict file of
the port (`interdiff_tpu/cli/convert_checkpoint.py`, which writes an orbax
save instead).

The reference distributes `diffusion.ckpt`, `diffusion_skeleton.ckpt`,
`correction.ckpt` and `obj_skeleton.ckpt` (`interdiff/README.md`).  The
eval entry points read them directly (`cli/common.py::load_mdm`,
``load_correction_variables``); this tool keeps the converted weights, to
fine-tune them with the port's trainers or to skip the unpickling at every
start.  It writes ``<out>/state_dict.pt`` (`utils/convert.py::
save_state_dict`, which every ``--diffusion_ckpt``/``--correction_ckpt``/
``--resume_checkpoint`` reads) and ``<out>/hparams.json``: the
checkpoint's hyper_parameters plus ``kind`` and, for an SMPL MDM,
``use_pointnet2`` (whether the weights hold PointNet++) and ``fps_groups``
1 (a PointNet++ checkpoint needs exact FPS).  The eval entry points build
the MDM of a ``--diffusion_ckpt`` with such a file beside it from there
(`cli/common.py::load_mdm`), as they build it from the ``.ckpt``, so both
routes run the same module; a module built by hand for the state dict
must take its sizes, ``use_pointnet2`` and ``fps_groups=1`` from it too.

Usage:
  python -m interdiff_torch.cli.convert_checkpoint \\
      --ckpt /path/diffusion.ckpt --kind mdm_smpl --out /path/converted
"""

from __future__ import annotations

import json
import os
from argparse import ArgumentParser
from typing import Dict

from interdiff_torch.utils import checkpoint as ck
from interdiff_torch.utils.convert import (
    flax_to_torch_state_dict,
    save_state_dict,
)

KINDS = ("mdm_smpl", "mdm_skeleton", "correction_smpl",
         "correction_skeleton")
STATE_FILE = "state_dict.pt"


def convert(ckpt: str, kind: str, out: str) -> Dict:
    """Write ``<out>/state_dict.pt`` and ``<out>/hparams.json`` (the
    embedded hyper_parameters, ``kind`` and for ``mdm_smpl`` its
    ``use_pointnet2`` and ``fps_groups``) from the Lightning checkpoint
    ``ckpt`` of ``kind``; ``out`` must not exist.  Returns the embedded
    hyper_parameters."""
    if os.path.exists(out):
        raise FileExistsError(f"--out {out} exists; give a new directory")
    loader = {"mdm_smpl": ck.load_mdm_smpl,
              "mdm_skeleton": ck.load_mdm_skeleton,
              "correction_smpl": ck.load_correction_smpl,
              "correction_skeleton": ck.load_correction_skeleton}[kind]
    variables, hp = loader(ckpt)
    state = flax_to_torch_state_dict(variables)
    os.makedirs(out)
    save_state_dict(os.path.join(out, STATE_FILE), state)
    hp_json = {k: v for k, v in hp.items()
               if isinstance(v, (int, float, str, bool, type(None)))}
    hp_json["kind"] = kind
    if kind == "mdm_smpl":
        hp_json["use_pointnet2"] = "batch_stats" in variables
        hp_json["fps_groups"] = 1
    with open(os.path.join(out, ck.HPARAMS_FILE), "w") as f:
        json.dump(hp_json, f, indent=1)
    return hp


def main(argv=None) -> Dict:
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ckpt", required=True,
                        help="Lightning .ckpt file (state_dict under "
                             "'model.', as LitInteraction saves)")
    parser.add_argument("--kind", required=True, choices=KINDS)
    parser.add_argument("--out", required=True,
                        help="output directory (must not exist)")
    args = parser.parse_args(argv)
    if os.path.exists(args.out):
        parser.error(f"--out {args.out} exists; give a new directory")
    hp = convert(args.ckpt, args.kind, args.out)
    print(f"converted {args.ckpt} ({args.kind}) -> "
          f"{os.path.join(args.out, STATE_FILE)}; hparams keys: "
          f"{sorted(hp)}")
    return hp


if __name__ == "__main__":
    main()
