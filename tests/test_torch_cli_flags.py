"""Every parser of the port's nine entry points against its counterpart's in
`interdiff_tpu/cli/`: the same option names, with the same default,
choices, type and action, except the flags listed below.  The JAX CLIs
build their parser inside ``main``; both sides' parsers are captured at
``parse_args``."""

import argparse
import importlib

import pytest

pytest.importorskip("torch")

# flags of the JAX package that the port's parser does not know yet (none
# since both evals took --mesh_devices)
TO_PORT = {
    "eval_smpl_short": set(),
    "eval_smpl_long": set(),
    "eval_skeleton": set(),
    "train_diffusion_smpl": set(),
    "train_diffusion_skeleton": set(),
    "train_correction_smpl": set(),
    "train_correction_skeleton": set(),
    "optimization": set(),
    "convert_checkpoint": set(),
}
# flags of the port alone: every entry point's --device (the CPU on
# request), the skeleton trainer's widths (as the SMPL trainer has them) and
# the synthetic body's and cloud's sizes of the SMPL correction trainer
PORT_ONLY = {name: {"--device"} for name in TO_PORT}
PORT_ONLY["train_diffusion_skeleton"] |= {"--embedding_dim", "--num_layers"}
PORT_ONLY["train_correction_smpl"] |= {"--synthetic_points",
                                       "--synthetic_verts"}
PORT_ONLY["convert_checkpoint"] = set()
# shared flags whose defaults differ: the JAX package defaults the
# correction checkpoint to a path of the reference's checkout, which the
# port does not carry (a path or nothing)
DEFAULTS_DIFFER = {("eval_smpl_short", "--correction_ckpt"),
                   ("eval_smpl_long", "--correction_ckpt"),
                   ("eval_skeleton", "--correction_ckpt")}


class _Captured(Exception):
    pass


def _options(module: str, monkeypatch) -> dict:
    """option -> (default, choices, type, action) of the parser that
    ``module.main`` builds."""
    def grab(self, *args, **kwargs):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    main = importlib.import_module(module).main
    with pytest.raises(_Captured) as captured:
        main() if module.startswith("interdiff_tpu") else main([])
    parser = captured.value.args[0]
    return {s: (a.default, a.choices, getattr(a.type, "__name__", None),
                type(a).__name__)
            for a in parser._actions for s in a.option_strings
            if s.startswith("--") and s != "--help"}


@pytest.mark.parametrize("name", sorted(TO_PORT))
def test_port_parser_matches_jax(monkeypatch, name):
    jax_opts = _options(f"interdiff_tpu.cli.{name}", monkeypatch)
    port_opts = _options(f"interdiff_torch.cli.{name}", monkeypatch)
    assert set(jax_opts) - set(port_opts) == TO_PORT[name]
    assert set(port_opts) - set(jax_opts) == PORT_ONLY[name]
    for flag in set(jax_opts) & set(port_opts):
        if (name, flag) in DEFAULTS_DIFFER:
            continue
        assert port_opts[flag] == jax_opts[flag], flag
