"""The seams of the port's sampling core: both InterDiff sampler builders
refuse an unknown sampler when they are built (the name is checked by
`GaussianDiffusion.check_sampler`), and every builder and
step factory that needs full-f32 products leaves both TF32 flags off after
it is built (`interdiff_torch.full_f32`)."""

import pytest
import torch

from interdiff_torch.config import (
    CorrectionConfig,
    DiffusionConfig,
    SkeletonTrackConfig,
    SmplTrackConfig,
    TextTrackConfig,
)
from interdiff_torch.eval import skeleton, smpl_short, text
from interdiff_torch.train import trainer

SMALL = dict(embedding_dim=32, num_heads=4, ff_size=32, num_layers=2)
TEXT_SMALL = dict(latent_dim=64, ff_size=128, num_layers=2, num_heads=2,
                  clip_dim=64, vocab_size=100, transformer_width=64,
                  transformer_layers=2, transformer_heads=2)


def _diffusion():
    return DiffusionConfig(timestep_respacing="10").build("cpu")


def _smpl_sampler(**kw):
    return smpl_short.make_sampler(
        smpl_short.SmplEvalConfig(),
        SmplTrackConfig(**SMALL).build_model("cpu"), _diffusion(), **kw)


def _skeleton_sampler(**kw):
    return skeleton.make_skeleton_sampler(
        skeleton.SkeletonEvalConfig(),
        SkeletonTrackConfig(**SMALL).build_model("cpu"), _diffusion(), **kw)


BUILDERS = {"make_sampler": _smpl_sampler,
            "make_skeleton_sampler": _skeleton_sampler}

FULL_F32 = {
    **BUILDERS,
    "make_text_sampler": lambda: text.make_text_sampler(
        text.TextEvalConfig(num_frames=12),
        TextTrackConfig(**TEXT_SMALL).build_model("cpu"), _diffusion()),
    "make_skeleton_train_step": lambda: trainer.make_skeleton_train_step(
        SkeletonTrackConfig(**SMALL).build_model("cpu"), _diffusion()),
    "make_correction_smpl_train_step":
        lambda: trainer.make_correction_smpl_train_step(
            CorrectionConfig(num_nodes=40, dct=4).build_model("cpu")),
    "make_correction_skeleton_train_step":
        lambda: trainer.make_correction_skeleton_train_step(
            CorrectionConfig(track="skeleton", num_nodes=21,
                             future_len=10).build_model("cpu")),
}


@pytest.mark.parametrize("builder", sorted(BUILDERS))
def test_unknown_sampler_raises_at_build(builder):
    with pytest.raises(ValueError, match="unknown sampler 'euler': the port "
                       "has 'ddpm', 'ddim' and 'plms'"):
        BUILDERS[builder](sampler="euler")


@pytest.fixture
def tf32_on():
    """Both TF32 flags on for the test, as they were after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("factory", sorted(FULL_F32))
def test_builders_turn_tf32_off(tf32_on, factory):
    FULL_F32[factory]()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
