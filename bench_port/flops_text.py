"""FLOPs of MDM's text-to-motion sampling from shapes (two a multiply-add,
matrix products only, as `flops.py` counts them): CLIP's text tower over
every position of the context, and the guided denoiser, whose conditioned
and null halves are one call of 2B rows over the condition token and the
frames."""

from __future__ import annotations

from bench_port.flops import ff, linear, mha


def tower(cfg: dict, B: int) -> int:
    """The tower over B captions: each layer's attention and 4x MLP at
    every position of the context, then the EOT rows' projection."""
    T, W = cfg["context_length"], cfg["transformer_width"]
    per_layer = mha(B, T, T, W) + ff(B * T, W, 4 * W)
    return cfg["transformer_layers"] * per_layer \
        + linear(B, W, cfg["clip_dim"])


def guided_denoise(cfg: dict, B: int) -> int:
    """One guided call of B rows: 2B rows of the timestep MLP, the text
    embedding, the pose projection of every frame, the encoder over the
    frames and the condition token, and the output projection."""
    R, F, D = 2 * B, cfg["num_frames"], cfg["latent_dim"]
    J, T = cfg["njoints"], cfg["num_frames"] + 1
    return (2 * linear(R, D, D) + linear(R, cfg["clip_dim"], D)
            + linear(R * F, J, D)
            + cfg["num_layers"] * (mha(R, T, T, D) + ff(R * T, D,
                                                        cfg["ff_size"]))
            + linear(R * F, D, J))


def batch(cfg: dict, B: int, steps: int) -> int:
    """A batch: the tower once and ``steps`` guided calls."""
    return tower(cfg, B) + steps * guided_denoise(cfg, B)
