"""One-time converter: MANO_RIGHT.pkl (chumpy-pickled) -> plain .npz
(a copy of dsf_tpu/mano/convert.py: the port imports nothing of
dsf_tpu).

    python -m dsf_tpu_torch.mano.convert MANO_RIGHT.pkl mano_right.npz

The official MANO pickle stores some fields as chumpy arrays and the
joint regressor as a scipy sparse matrix (ref loads it with
pickle(encoding='latin1'), render_model/mano_layer.py:97-148).  We
convert once to a plain-numpy npz so the runtime has zero non-array
dependencies.  A chumpy stub is injected for unpickling machines without
chumpy installed.
"""

from __future__ import annotations

import pickle
import sys
import types

import numpy as np

FIELDS = (
    "v_template",
    "shapedirs",
    "J_regressor",
    "hands_components",
    "hands_mean",
    "posedirs",
    "kintree_table",
    "weights",
    "f",
)


class _ChStub:
    """Minimal stand-in for chumpy.Ch: keeps the pickled state dict and
    exposes the wrapped ndarray."""

    def __init__(self, *args, **kwargs):
        self.__dict__["_state"] = {}

    def __setstate__(self, state):
        self.__dict__["_state"] = state

    def __array__(self, dtype=None):
        arr = _extract_array(self.__dict__.get("_state", {}))
        if arr is None:
            raise ValueError("chumpy stub holds no ndarray")
        return np.asarray(arr, dtype=dtype) if dtype else np.asarray(arr)


def _extract_array(state):
    if isinstance(state, np.ndarray):
        return state
    if isinstance(state, dict):
        for key in ("x", "_data", "a", "v"):
            if key in state:
                return _extract_array(state[key])
        for v in state.values():
            arr = _extract_array(v)
            if arr is not None:
                return arr
    if hasattr(state, "__array__"):
        return np.asarray(state)
    return None


def _install_chumpy_stub():
    if "chumpy" in sys.modules:
        return
    mod = types.ModuleType("chumpy")
    ch = types.ModuleType("chumpy.ch")
    for m in (mod, ch):
        m.Ch = _ChStub
    mod.ch = ch
    sys.modules["chumpy"] = mod
    sys.modules["chumpy.ch"] = ch
    # chumpy pickles sometimes reference these submodules
    for name in ("chumpy.ch_ops", "chumpy.reordering", "chumpy.utils"):
        sub = types.ModuleType(name)
        sub.Ch = _ChStub
        sys.modules[name] = sub


def _to_dense(x):
    if hasattr(x, "toarray"):  # scipy sparse
        return np.asarray(x.toarray())
    return np.asarray(x)


def convert_mano_pkl(pkl_path: str, npz_path: str) -> dict:
    """Convert a MANO pickle to a plain npz with float32/int32 arrays."""
    try:
        with open(pkl_path, "rb") as f:
            model = pickle.load(f, encoding="latin1")
    except ModuleNotFoundError:
        _install_chumpy_stub()
        with open(pkl_path, "rb") as f:
            model = pickle.load(f, encoding="latin1")

    out = {}
    for k in FIELDS:
        arr = _to_dense(model[k])
        if k in ("f", "kintree_table"):
            out[k] = arr.astype(np.int32)
        else:
            out[k] = arr.astype(np.float32)
    np.savez(npz_path, **out)
    return out


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="MANO_RIGHT.pkl -> the .npz Config.mano_model_path names")
    parser.add_argument("pkl")
    parser.add_argument("npz")
    args = parser.parse_args(argv)
    out = convert_mano_pkl(args.pkl, args.npz)
    print(f"{args.npz}: " + ", ".join(f"{k} {v.shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
