"""The reference's PyTorch-Lightning checkpoints -> the port's modules (the
Lightning half of `interdiff_tpu/utils/checkpoint.py`).

The reference distributes four Lightning checkpoints (`interdiff/README.md`:
`diffusion.ckpt`, `diffusion_skeleton.ckpt`, `correction.ckpt`,
`obj_skeleton.ckpt`), each a ``state_dict`` under the ``model.`` prefix
(`LitInteraction.model`) plus the training run's ``hyper_parameters``.  The
key maps below turn such a state dict into the flax layout of the JAX
package (nested dicts of numpy arrays), and `utils/convert.py::
flax_to_torch_state_dict` turns that into the port's ``state_dict``, so one
renaming rule serves every weight that reaches the port.

Key map of one ST-GCNN layer (`interdiff/model/layers.py:271-345`):

  ``...{i}.gcn.T / .gcn.A / .gcn.S``    -> ``gcn{i}.gcn.T|A|S``
  ``...{i}.tcn.0.weight [O,I,1,1]``     -> ``gcn{i}.tcn_conv`` kernel [I,O]
  ``...{i}.tcn.1.*`` (BatchNorm2d)      -> ``gcn{i}.tcn_bn`` scale/bias and
                                           batch_stats mean/var
  ``...{i}.residual.0/1.*``             -> ``gcn{i}.res_conv``, ``res_bn``
  ``...{i}.prelu.weight [1]``           -> ``gcn{i}.prelu`` (0-d)

A key that no map reads fails the conversion (:func:`_assert_all_consumed`)
unless it is one of the deterministic buffers the port recomputes or one of
the reference's unused MDM layers; a key a map needs and the file lacks
raises ``KeyError``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from interdiff_torch.utils.convert import flax_to_torch_state_dict


def load_lightning_state_dict(path: str
                              ) -> Tuple[Dict[str, np.ndarray], Dict]:
    """A Lightning checkpoint -> (numpy state dict, hyper_parameters).

    ``torch.load(weights_only=False)``: Lightning pickles the run's
    hyper_parameters as Python objects, which the restricted unpickler
    refuses.  Read only checkpoints whose origin you trust; this is the one
    place in the port that unpickles more than tensors."""
    ck = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.numpy() for k, v in ck["state_dict"].items()}
    return sd, dict(ck.get("hyper_parameters", {}))


class _TrackedSD(dict):
    """A state dict that records the keys a conversion read.  Membership
    tests (``in``) do not count as reads, so a layout probe cannot hide a
    dropped tensor."""

    def __init__(self, sd):
        super().__init__(sd)
        self.consumed: set = set()

    def __getitem__(self, key):
        self.consumed.add(key)
        return super().__getitem__(key)


# the reference's MDM builds these layers and never runs them
# (`model/diffusion_smpl.py:177-183`): dropped
_MDM_UNUSED = ("finalLinear.", "bodyFutureEmbedding", "objFutureEmbedding")

# buffers the port recomputes from the hyper-parameters: sinusoidal tables,
# the QaN rotary frequencies, BatchNorm step counters
_DETERMINISTIC_BUFFER_SUFFIXES = (".pe", ".rel_pos.inv_freq",
                                  ".num_batches_tracked")


def _assert_all_consumed(sd: _TrackedSD, *, torch_prefix: str,
                         unused_prefixes: Tuple[str, ...] = ()) -> None:
    """Raise if a key was neither read nor allowed to remain."""
    allowed = tuple(torch_prefix + p for p in unused_prefixes)
    leftovers = sorted(
        k for k in sd
        if k not in sd.consumed
        and not k.endswith(_DETERMINISTIC_BUFFER_SUFFIXES)
        and not k.startswith(allowed))
    if leftovers:
        raise ValueError(
            f"checkpoint conversion left {len(leftovers)} state-dict key(s) "
            f"unconsumed (unrecognised layout?): {leftovers[:8]}"
            + (" ..." if len(leftovers) > 8 else ""))


def _to_f32(tree: Mapping) -> Dict[str, Any]:
    return {k: _to_f32(v) if isinstance(v, Mapping)
            else np.asarray(v, dtype=np.float32) for k, v in tree.items()}


def _conv1x1_kernel(w: np.ndarray) -> np.ndarray:
    """Conv2d [O, I, 1, 1] -> dense kernel [I, O]."""
    return np.ascontiguousarray(w[:, :, 0, 0].T)


def _linear_p(sd, key: str) -> Dict[str, np.ndarray]:
    """nn.Linear -> dense kernel [in, out] and bias."""
    return {"kernel": np.ascontiguousarray(sd[f"{key}.weight"].T),
            "bias": sd[f"{key}.bias"]}


def _ln_p(sd, key: str) -> Dict[str, np.ndarray]:
    return {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}


def _mha_p(sd, key: str) -> Dict[str, Any]:
    """nn.MultiheadAttention -> the packed ``in_proj_kernel`` [D, 3D]."""
    return {"in_proj_kernel": np.ascontiguousarray(
                sd[f"{key}.in_proj_weight"].T),
            "in_proj_bias": sd[f"{key}.in_proj_bias"],
            "out_proj": _linear_p(sd, f"{key}.out_proj")}


def _stgcnn_layer(sd, prefix: str, has_residual_conv: bool
                  ) -> Tuple[Dict, Dict]:
    """One ST_GCNN_layer -> (params, batch_stats)."""
    gcn = {name: sd[f"{prefix}.gcn.{name}"] for name in ("T", "A", "S")
           if f"{prefix}.gcn.{name}" in sd}
    params: Dict[str, Any] = {
        "gcn": gcn,
        "tcn_conv": {"kernel": _conv1x1_kernel(sd[f"{prefix}.tcn.0.weight"]),
                     "bias": sd[f"{prefix}.tcn.0.bias"]},
        "tcn_bn": {"scale": sd[f"{prefix}.tcn.1.weight"],
                   "bias": sd[f"{prefix}.tcn.1.bias"]}}
    stats: Dict[str, Any] = {
        "tcn_bn": {"mean": sd[f"{prefix}.tcn.1.running_mean"],
                   "var": sd[f"{prefix}.tcn.1.running_var"]}}
    if has_residual_conv:
        params["res_conv"] = {
            "kernel": _conv1x1_kernel(sd[f"{prefix}.residual.0.weight"]),
            "bias": sd[f"{prefix}.residual.0.bias"]}
        params["res_bn"] = {"scale": sd[f"{prefix}.residual.1.weight"],
                            "bias": sd[f"{prefix}.residual.1.bias"]}
        stats["res_bn"] = {"mean": sd[f"{prefix}.residual.1.running_mean"],
                           "var": sd[f"{prefix}.residual.1.running_var"]}
    params["prelu"] = sd[f"{prefix}.prelu.weight"].reshape(())
    return params, stats


def convert_obj_projector(sd: Dict[str, np.ndarray], *,
                          torch_prefix: str = "model.",
                          channels: Tuple[int, ...] = (9, 32, 16, 32, 9),
                          fusion_channels: Tuple[int, ...] = (9, 32, 16, 32,
                                                              9)
                          ) -> Dict[str, Any]:
    """A correction network's state dict -> ``{"params", "batch_stats"}``
    of the projector's ``core`` (`ObjProjectorSmpl`,
    `ObjProjectorSkeleton`)."""
    sd = _TrackedSD(sd)
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for stack, chans in (("st_gcnns_relative", channels),
                         ("st_gcnns", channels),
                         ("st_gcnns_all", fusion_channels)):
        params[stack], stats[stack] = {}, {}
        for i in range(len(chans) - 1):
            p, s = _stgcnn_layer(sd, f"{torch_prefix}{stack}.{i}",
                                 chans[i] != chans[i + 1])
            params[stack][f"gcn{i}"] = p
            stats[stack][f"gcn{i}"] = s
    _assert_all_consumed(sd, torch_prefix=torch_prefix)
    return _to_f32({"params": {"core": params},
                    "batch_stats": {"core": stats}})


def _mdm_stack_params(sd, prefix: str, num_layers: int, cross: bool
                      ) -> Dict[str, Any]:
    """One TransformerEncoder/Decoder stack (`model/layers.py:177-269`):
    layers 1 and N vanilla, 2..N-1 QaN -> ``layer_{i}``."""
    out: Dict[str, Any] = {}
    for i in range(num_layers):
        lp = f"{prefix}.layers.{i}"
        p: Dict[str, Any] = {
            "norm1": _ln_p(sd, f"{lp}.norm1"),
            "norm2": _ln_p(sd, f"{lp}.norm2"),
            "ff": {"linear1": _linear_p(sd, f"{lp}.linear1"),
                   "linear2": _linear_p(sd, f"{lp}.linear2")}}
        if i in (0, num_layers - 1):
            p["self_attn"] = _mha_p(sd, f"{lp}.self_attn")
        else:
            p["queries"] = sd[f"{lp}.queries"]
            p["wk"] = sd[f"{lp}.wk"]
        if cross:
            p["norm3"] = _ln_p(sd, f"{lp}.norm3")
            p["multihead_attn"] = _mha_p(sd, f"{lp}.multihead_attn")
        out[f"layer_{i}"] = p
    return out


def _pointnet_params(sd, prefix: str) -> Tuple[Dict, Dict]:
    """pointnet2_ops `PointnetSAModuleMSG` weights (`build_shared_mlp`:
    Sequential indices conv, bn, relu per stage) -> ``sa{i}.mlp{s}.conv{k}``
    (bias-free) and ``bn{k}``, and the head ``Linear``."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for i in (0, 1):
        sa_p: Dict[str, Any] = {}
        sa_s: Dict[str, Any] = {}
        for s in (0, 1):
            seq = f"{prefix}.SA_modules.{i}.mlps.{s}"
            mp: Dict[str, Any] = {}
            ms: Dict[str, Any] = {}
            k = 0
            while f"{seq}.{3 * k}.weight" in sd:
                mp[f"conv{k}"] = {
                    "kernel": _conv1x1_kernel(sd[f"{seq}.{3 * k}.weight"])}
                mp[f"bn{k}"] = {"scale": sd[f"{seq}.{3 * k + 1}.weight"],
                                "bias": sd[f"{seq}.{3 * k + 1}.bias"]}
                ms[f"bn{k}"] = {"mean": sd[f"{seq}.{3 * k + 1}.running_mean"],
                                "var": sd[f"{seq}.{3 * k + 1}.running_var"]}
                k += 1
            if not mp:
                raise KeyError(f"no shared-MLP weights under {seq}: "
                               "unrecognised pointnet2 checkpoint layout")
            sa_p[f"mlp{s}"], sa_s[f"mlp{s}"] = mp, ms
        params[f"sa{i}"], stats[f"sa{i}"] = sa_p, sa_s
    params["Linear"] = _linear_p(sd, f"{prefix}.Linear")
    return params, stats


def _mdm_common(sd, P: str, num_layers: int, latent_usage: str
                ) -> Dict[str, Any]:
    return {
        "bodyEmbedding": _linear_p(sd, f"{P}bodyEmbedding"),
        "objEmbedding": _linear_p(sd, f"{P}objEmbedding"),
        "embedTimeStep": {
            "fc1": _linear_p(sd, f"{P}embedTimeStep.time_embed.0"),
            "fc2": _linear_p(sd, f"{P}embedTimeStep.time_embed.2")},
        "encoder": _mdm_stack_params(sd, f"{P}encoder", num_layers,
                                     cross=False),
        "decoder": _mdm_stack_params(sd, f"{P}decoder", num_layers,
                                     cross=latent_usage == "memory"),
        "bodyFinalLinear": _linear_p(sd, f"{P}bodyFinalLinear"),
        "objFinalLinear": _linear_p(sd, f"{P}objFinalLinear")}


def convert_mdm_smpl(sd: Dict[str, np.ndarray], *,
                     torch_prefix: str = "model.", num_layers: int = 8,
                     latent_usage: str = "memory") -> Dict[str, Any]:
    """The SMPL-track `MDM` state dict (`model/diffusion_smpl.py:8-246`)
    -> the flax layout of `MDMSmpl`.  A 2-D ``pcEmbedding.weight`` is the
    linear object encoder (``use_pointnet2=0``); otherwise the PointNet++
    weights are mapped, their BatchNorm statistics into ``batch_stats``."""
    sd = _TrackedSD(sd)
    P = torch_prefix
    params = _mdm_common(sd, P, num_layers, latent_usage)
    tree: Dict[str, Any] = {"params": params}
    if f"{P}pcEmbedding.weight" in sd and \
            sd[f"{P}pcEmbedding.weight"].ndim == 2:
        params["pcEmbedding"] = _linear_p(sd, f"{P}pcEmbedding")
    else:
        pc_p, pc_s = _pointnet_params(sd, f"{P}pcEmbedding")
        params["pcEmbedding"] = pc_p
        tree["batch_stats"] = {"pcEmbedding": pc_s}
    _assert_all_consumed(sd, torch_prefix=P, unused_prefixes=_MDM_UNUSED)
    return _to_f32(tree)


def convert_mdm_skeleton(sd: Dict[str, np.ndarray], *,
                         torch_prefix: str = "model.", num_layers: int = 8,
                         latent_usage: str = "memory") -> Dict[str, Any]:
    """The skeleton-track `MDM` state dict (`model/diffusion_skeleton.py:
    7-257`) -> the flax layout of `MDMSkeleton`."""
    sd = _TrackedSD(sd)
    P = torch_prefix
    params = _mdm_common(sd, P, num_layers, latent_usage)
    params["shapeEmbedding"] = _linear_p(sd, f"{P}shapeEmbedding")
    _assert_all_consumed(sd, torch_prefix=P, unused_prefixes=_MDM_UNUSED)
    return _to_f32({"params": params})


def load_mdm_smpl(path: str) -> Tuple[Dict[str, Any], Dict]:
    """SMPL-track MDM checkpoint -> (flax-layout variables, hparams)."""
    sd, hp = load_lightning_state_dict(path)
    return convert_mdm_smpl(
        sd, num_layers=int(hp.get("num_layers", 8)),
        latent_usage=hp.get("latent_usage", "memory")), hp


def load_mdm_skeleton(path: str) -> Tuple[Dict[str, Any], Dict]:
    """Skeleton-track MDM checkpoint -> (flax-layout variables, hparams)."""
    sd, hp = load_lightning_state_dict(path)
    return convert_mdm_skeleton(
        sd, num_layers=int(hp.get("num_layers", 8)),
        latent_usage=hp.get("latent_usage", "memory")), hp


def load_correction_smpl(path: str) -> Tuple[Dict[str, Any], Dict]:
    """-> (flax-layout variables, hparams) of `ObjProjectorSmpl`."""
    sd, hp = load_lightning_state_dict(path)
    return convert_obj_projector(sd), hp


def load_correction_skeleton(path: str) -> Tuple[Dict[str, Any], Dict]:
    """-> (flax-layout variables, hparams) of `ObjProjectorSkeleton`
    (fusion stack 9-64-32-64-9, `correction_skeleton.py:39-50`)."""
    sd, hp = load_lightning_state_dict(path)
    return convert_obj_projector(
        sd, fusion_channels=(9, 64, 32, 64, 9)), hp


HPARAMS_FILE = "hparams.json"


def mdm_smpl_from_hparams(hp: Mapping, *, use_pointnet2: bool,
                          device=None):
    """`MDMSmpl` on ``device`` with the sizes of the hyper_parameters ``hp``
    and initial weights.  With PointNet++ it gets exact FPS
    (``fps_groups=1``): the grouped FPS changes the order of the selected
    keypoints and is only right for weights trained under it."""
    from interdiff_torch.models.mdm_smpl import MDMSmpl

    return MDMSmpl(
        smpl_dim=int(hp.get("smpl_dim", 132)),
        embed_dim=int(hp.get("embedding_dim", 256)),
        num_heads=int(hp.get("num_heads", 4)),
        ff_size=int(hp.get("ff_size", 1024)),
        num_layers=int(hp.get("num_layers", 8)), dropout=0.0,
        activation=hp.get("activation", "gelu"),
        past_len=int(hp.get("past_len", 10)),
        future_len=int(hp.get("future_len", 25)),
        latent_usage=hp.get("latent_usage", "memory"),
        use_pointnet2=use_pointnet2, fps_groups=1, device=device)


def mdm_skeleton_from_hparams(hp: Mapping, device=None):
    """`MDMSkeleton` on ``device`` with the sizes of ``hp``."""
    from interdiff_torch.models.mdm_skeleton import MDMSkeleton

    return MDMSkeleton(
        embed_dim=int(hp.get("embedding_dim", 256)),
        num_heads=int(hp.get("num_heads", 4)),
        ff_size=int(hp.get("ff_size", 256)),
        num_layers=int(hp.get("num_layers", 8)),
        past_len=int(hp.get("past_len", 10)),
        latent_usage=hp.get("latent_usage", "memory"), device=device)


def mdm_smpl_from_checkpoint(path: str, device=None):
    """-> (`MDMSmpl` on ``device`` with the checkpoint's weights, hparams).

    The module is built from the embedded hyper_parameters
    (:func:`mdm_smpl_from_hparams`, exact FPS); a checkpoint without
    PointNet++ weights (no BatchNorm statistics) gets the linear object
    encoder (``use_pointnet2=False``)."""
    variables, hp = load_mdm_smpl(path)
    model = mdm_smpl_from_hparams(
        hp, use_pointnet2="batch_stats" in variables, device=device)
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    return model, hp


def mdm_skeleton_from_checkpoint(path: str, device=None):
    """-> (`MDMSkeleton` on ``device`` with the checkpoint's weights,
    hparams), built from the embedded hyper_parameters."""
    variables, hp = load_mdm_skeleton(path)
    model = mdm_skeleton_from_hparams(hp, device)
    model.load_state_dict(flax_to_torch_state_dict(variables), strict=True)
    return model, hp


def converted_hparams(path: Optional[str]) -> Optional[Dict[str, Any]]:
    """The ``hparams.json`` that `cli/convert_checkpoint.py` wrote beside the
    state-dict file ``path``, or None when there is none (a state dict the
    port's trainers saved)."""
    if not path or not os.path.isfile(path):
        return None
    beside = os.path.join(os.path.dirname(os.path.abspath(path)),
                          HPARAMS_FILE)
    if not os.path.isfile(beside):
        return None
    with open(beside) as f:
        hp = json.load(f)
    return hp if "kind" in hp else None


def correction_state_dict(path: str, kind: str = "smpl"
                          ) -> Dict[str, torch.Tensor]:
    """A correction checkpoint of ``kind`` ('smpl' | 'skeleton') -> the
    projector's ``state_dict``."""
    loader = {"smpl": load_correction_smpl,
              "skeleton": load_correction_skeleton}[kind]
    return flax_to_torch_state_dict(loader(path)[0])
