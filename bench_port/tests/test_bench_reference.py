"""The reference against the port on the CPU at small sizes: each module
on the same weights and inputs, and whole runs of both eval cells through
the harness, with every gap under the cell's limits."""

import numpy as np
import pytest
import torch

from bench_port import body as bodymod
from bench_port import harness, traffic, weights
from bench_port.reference import geometry as geo
from bench_port.reference import nets
from bench_port.tests import small


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _smpl_models():
    from interdiff_torch.config import CorrectionConfig, SmplTrackConfig

    wl, cfg = small.cell("smpl_eval_ddpm1000")
    keys = ("smpl_dim", "embedding_dim", "num_heads", "ff_size",
            "activation", "num_layers", "latent_usage", "use_pointnet2",
            "fps_groups", "past_len", "future_len")
    model = SmplTrackConfig(**{k: cfg[k] for k in keys}).build_model("cpu")
    sd = weights.seeded_state(model, 11)
    weights.rest_pose(sd, cfg["smpl_dim"], cfg["rest_pose_object"])
    model.load_state_dict(sd)
    proj = CorrectionConfig(num_nodes=67, dct=cfg["dct"]).build_model("cpu")
    psd = weights.seeded_state(proj, 12)
    proj.load_state_dict(psd)
    return wl, cfg, model, sd, proj, psd


@torch.no_grad()
def test_smpl_encoder_denoiser_and_projector():
    from interdiff_torch.models.mdm_smpl import smpl_gt_from_raw

    wl, cfg, model, sd, proj, psd = _smpl_models()
    tr = {**wl["traffic_params"], "past_len": 10, "future_len": 25}
    b = {k: torch.as_tensor(v) for k, v in
         traffic.smpl_clips(harness.rng(3), tr).items()}
    gt = smpl_gt_from_raw(b["body_pose"][..., :66], b["body_trans"],
                          b["obj_angles"], b["obj_trans"])
    ref_gt = nets.smpl_gt(b["body_pose"][..., :66], b["body_trans"],
                          b["obj_angles"], b["obj_trans"])
    assert torch.allclose(gt, ref_gt, atol=1e-6)
    mem = model.encode(gt, b["obj_points"])
    ref_mem = nets.smpl_encode(sd, cfg, gt, b["obj_points"])
    assert (mem - ref_mem).abs().max() < 1e-5
    t = torch.tensor([999, 3])
    x = torch.randn_like(gt)
    assert (model.denoise(x, t, mem) - nets.smpl_denoise(
        sd, cfg, x, t, ref_mem)).abs().max() < 1e-5
    markers = torch.randn(2, 35, 67, 3)
    contact = torch.randint(0, 3, (2, 67)).float()
    assert (proj.sample(gt[..., 135:], markers, contact)
            - nets.projector_smpl(psd, cfg, gt[..., 135:], markers, contact)
            ).abs().max() < 1e-5


@torch.no_grad()
def test_smpl_forward_kinematics_and_nearest():
    from interdiff_torch.config import build_smpl_body
    from interdiff_torch.geometry.normals import vertex_normals
    from interdiff_torch.ops.signed_distance import signed_nearest
    from interdiff_torch.smpl.model import smpl_forward

    arrays = bodymod.stand_in_arrays(harness.rng(4), 512, 52)
    smpl = build_smpl_body(arrays, device="cpu")
    body = bodymod.reference_body(arrays, np.arange(67), "cpu")
    g = torch.Generator().manual_seed(0)
    pose = torch.randn(3, 156, generator=g) * 0.3
    betas = torch.randn(3, 10, generator=g)
    trans = torch.randn(3, 3, generator=g)
    verts, joints, _, _ = smpl_forward(smpl, pose, betas, trans)
    rv, rj = geo.smpl_fk(body, pose, betas, trans)
    assert (verts - rv).abs().max() < 1e-5
    assert (joints - rj).abs().max() < 1e-5
    n = vertex_normals(verts, smpl.faces_idx, smpl.incident)
    rn = geo.vertex_normals(rv, body["faces_t"], body["incident"])
    assert (n - rn).abs().max() < 1e-5
    q = torch.randn(3, 40, 3, generator=g) * 0.3
    sq, dot = signed_nearest(q, verts, n)
    rsq, rdot = geo.signed_nearest(q, rv, rn)
    assert (sq - rsq).abs().max() < 1e-5
    assert torch.equal(dot < 0, rdot < 0)


@pytest.mark.parametrize("name", small.EVAL_CELLS)
def test_a_run_agrees_with_the_reference(name):
    wl, cfg = small.cell(name)
    result, compared = small.run_module().measure(
        wl, cfg, 2 ** 31 + 7, 0.1, False, "cpu")
    assert result["correct"] and result["attempted"] > 0
    for k, c in compared.items():
        assert c["value"] <= c["limit"], (k, c)
