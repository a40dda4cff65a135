"""Chumpy-free SMPL / SMPL-H pkl loader (`interdiff_tpu/smpl/loader.py`).

The official model pickles hold `chumpy.Ch` objects and a scipy sparse
`J_regressor`; the reference loads them through the legacy chumpy stack
(`interdiff/libsmpl/smplpytorch/native/webuser/serialization.py:52-85`).
Here a shim unpickler rebuilds any chumpy class as a plain container and the
numpy arrays inside are taken out: a one-time conversion on the host, with
neither chumpy nor cv2.  Unpickling the sparse `J_regressor` needs scipy
importable; nothing here imports it.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Any, Dict

import numpy as np

from interdiff_torch.smpl.model import SmplModel


class _ChShim:
    """Stands in for chumpy.Ch / ch.ch.Ch during unpickling: keeps the
    pickled state dict and exposes the wrapped ndarray as ``.r``."""

    def __init__(self, *args, **kwargs):
        self.__dict__["_state"] = dict(kwargs)

    def __setstate__(self, state):
        self.__dict__["_state"] = state

    @property
    def r(self) -> np.ndarray:
        state = self.__dict__["_state"]
        for key in ("x", "a", "v"):  # Ch stores its array under 'x'
            if key in state and isinstance(state[key], np.ndarray):
                return state[key]
        for value in state.values():
            if isinstance(value, np.ndarray):
                return value
        raise ValueError(f"no ndarray in chumpy state: {list(state)}")


class _ShimUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module.startswith("chumpy"):
            return _ChShim
        return super().find_class(module, name)


def _to_array(value: Any) -> Any:
    if isinstance(value, _ChShim):
        return np.asarray(value.r)
    if hasattr(value, "toarray"):  # scipy sparse J_regressor
        return np.asarray(value.toarray())
    return value


def load_smpl_pkl(path: str | Path) -> Dict[str, Any]:
    """Unpickle a SMPL/SMPL-H model file into plain numpy arrays."""
    with open(path, "rb") as f:
        data = _ShimUnpickler(f, encoding="latin1").load()
    return {k: _to_array(v) for k, v in data.items()}


def smpl_model_from_pkl(path: str | Path, *, num_betas: int = 10,
                        device=None) -> SmplModel:
    """A model pkl as a :class:`SmplModel` on ``device`` (CUDA unless
    given).  SMPL-H male/female have 52 joints; plain SMPL has 24."""
    data = load_smpl_pkl(path)
    shapedirs = np.asarray(data["shapedirs"], dtype=np.float64)
    return SmplModel.create(
        v_template=np.asarray(data["v_template"], dtype=np.float64),
        shapedirs=shapedirs[:, :, :num_betas],
        posedirs=np.asarray(data["posedirs"], dtype=np.float64),
        j_regressor=np.asarray(data["J_regressor"], dtype=np.float64),
        weights=np.asarray(data["weights"], dtype=np.float64),
        parents=np.asarray(data["kintree_table"][0], dtype=np.int64),
        faces=np.asarray(data["f"], dtype=np.int32),
        device=device,
    )


def convert_pkl_to_npz(pkl_path: str | Path, npz_path: str | Path,
                       *, num_betas: int = 10) -> None:
    """One-time conversion, so that a run never touches pickles."""
    data = load_smpl_pkl(pkl_path)
    np.savez_compressed(
        npz_path,
        v_template=data["v_template"],
        shapedirs=np.asarray(data["shapedirs"])[:, :, :num_betas],
        posedirs=data["posedirs"],
        j_regressor=data["J_regressor"],
        weights=data["weights"],
        parents=np.asarray(data["kintree_table"][0]),
        faces=data["f"],
    )


def smpl_model_from_npz(npz_path: str | Path, *, device=None) -> SmplModel:
    """A file of :func:`convert_pkl_to_npz` as a :class:`SmplModel`."""
    z = np.load(npz_path)
    return SmplModel.create(
        v_template=z["v_template"], shapedirs=z["shapedirs"],
        posedirs=z["posedirs"], j_regressor=z["j_regressor"],
        weights=z["weights"], parents=z["parents"], faces=z["faces"],
        device=device)


def get_body_model(path: str | Path, model_type: str, gender: str,
                   *, num_betas: int = 10, ext: str = "pkl",
                   device=None) -> SmplModel:
    """Body-model factory after `interdiff/data/utils.py:413-447`: resolves
    ``{path}/{model_type}/{MODEL_TYPE}_{GENDER}.{ext}`` and returns a
    :class:`SmplModel` on ``device``; the reference's ``batch_size`` has no
    meaning here (shapes are per call)."""
    gender = str(gender).upper()
    model_path = Path(path) / model_type / f"{model_type.upper()}_{gender}.{ext}"
    if ext == "npz":
        return smpl_model_from_npz(model_path, device=device)
    return smpl_model_from_pkl(model_path, num_betas=num_betas, device=device)
