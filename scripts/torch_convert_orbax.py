"""Write an orbax save of the JAX package as a state-dict file of the port.

    JAX_PLATFORMS=cpu python scripts/torch_convert_orbax.py \\
        --save artifacts/smpl_real_params --kind mdm_smpl --out mdm_smpl.pt

It imports both packages and runs on the CPU.  ``--kind`` names the module
the save belongs to: ``mdm_smpl`` and ``mdm_skeleton`` (the track configs'
default widths, as the JAX trainers save them; restored into the module's
initialised tree, as `tests/test_artifacts.py` does), ``correction``
(either track's projector; the raw saved tree).  The flax variables go
through `interdiff_torch/utils/convert.py::flax_to_torch_state_dict` into a
`save_state_dict` file, which the port's ``--diffusion_ckpt``,
``--correction_ckpt`` and ``--resume_checkpoint`` read.

The port's flags read the orbax directories themselves
(`interdiff_torch/utils/orbax_read.py`, without JAX or tensorstore); this
script is the tests' oracle of that route: the same save through JAX and
orbax (`tests/test_torch_orbax_read.py`, `tests/test_torch_eval_cli.py`).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KINDS = ("mdm_smpl", "mdm_skeleton", "correction")


def restore_variables(save: str, kind: str):
    """The flax variables (nested dicts of numpy arrays) of the orbax save
    ``save`` of ``kind``."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    if kind == "correction":
        from interdiff_tpu.cli.common import load_correction_variables

        return jax.device_get(load_correction_variables(save))
    B = 2
    if kind == "mdm_smpl":
        from interdiff_tpu.config import SmplTrackConfig
        from interdiff_tpu.models.mdm_smpl import MDMSmpl

        track = SmplTrackConfig()
        T = track.past_len + track.future_len
        model = track.build_model()
        args = (jnp.zeros((B, T, 144)), jnp.zeros((B, 64, 6)))
        method = MDMSmpl.init_forward
    elif kind == "mdm_skeleton":
        from interdiff_tpu.config import SkeletonTrackConfig
        from interdiff_tpu.models.mdm_skeleton import MDMSkeleton

        track = SkeletonTrackConfig()
        T = track.past_len + track.future_len
        model = track.build_model()
        args = (jnp.zeros((B, T, 21, 3)), jnp.zeros((B, T, 12, 3)),
                jnp.zeros((B, T, 7)), jnp.zeros((B, 12, 3)))
        method = MDMSkeleton.init_forward
    else:
        raise ValueError(f"--kind must be one of {KINDS}, got {kind}")
    template = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), *args, jnp.zeros((B,), jnp.int32),
        method=method))
    return jax.device_get(ocp.StandardCheckpointer().restore(
        os.path.abspath(save), target=template))


def convert(save: str, kind: str, out: str) -> None:
    """Write the save ``save`` of ``kind`` to the state-dict file ``out``."""
    from interdiff_torch.utils.convert import (
        flax_to_torch_state_dict,
        save_state_dict,
    )

    save_state_dict(out, flax_to_torch_state_dict(
        restore_variables(save, kind)))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--save", required=True,
                        help="orbax directory (e.g. artifacts/"
                             "smpl_real_params)")
    parser.add_argument("--kind", required=True, choices=KINDS)
    parser.add_argument("--out", required=True,
                        help="state-dict file to write")
    args = parser.parse_args(argv)
    convert(args.save, args.kind, args.out)
    print(f"wrote {args.out} from {args.save} ({args.kind})")


if __name__ == "__main__":
    main()
