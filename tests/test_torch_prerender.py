"""The slice as a whole: the port's offline pre-render
(dsf_tpu_torch/tools/prerender.py, the dense raster's path) against the
JAX package's (dsf_tpu/tools/prerender.py) on the CPU, with the same
synthetic MANO asset and parameter bank, read back with OpenCV.

Both write truncated uint16 depth in mm.  XLA contracts the depth plane
into a fused multiply-add and the two packages sum the LBS in other
orders (vertices ~6e-5 mm apart), so a depth that lies within a few 1e-4
mm of an integer may truncate to the next one, and a silhouette pixel may
flip: exact equality is not expected.  Each side is held against the
port's float64 render (float64 MANO constants, LBS and raster)."""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from dsf_tpu.mano import synthetic
from dsf_tpu.tools.prerender import prerender_dataset as jax_prerender
from dsf_tpu_torch.config import CAMERA
from dsf_tpu_torch.mano import model as TM
from dsf_tpu_torch.ops import rasterize as R
from dsf_tpu_torch.tools import prerender as TP

torch.set_num_threads(2)

N = 3
# share of a frame's pixels whose uint16 depth may differ from float64's:
# truncation at an integer (|z - round(z)| within float32 rounding of
# ~600 mm) and silhouette flips (measured, the port and JAX against each
# other: 30-39 of 307200 pixels, 1.3e-4)
DIFF_SHARE = 1e-3
# ... by more than 1 mm: silhouette flips only (measured 2-5, 1.6e-5)
FAR_SHARE = 1e-4


@pytest.fixture(scope="module")
def renders(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prerender")
    npz = str(tmp / "m.npz")
    synthetic.save_synthetic_mano(npz)
    rng = np.random.RandomState(0)
    params = np.zeros((N, 62), np.float32)
    params[:, :3] = rng.randn(N, 3) * 0.2
    params[:, 58] = 1.0                              # scale
    params[:, 59:62] = [0.0, 0.0, 600.0]             # in front of the camera
    out = {}
    for name, fn in (("port", lambda o: TP.prerender_dataset(
            npz, params, o, batch_size=2, device="cpu")),
                     ("jax", lambda o: jax_prerender(npz, params, o,
                                                     batch_size=2))):
        assert fn(str(tmp / name)) == N
        out[name] = str(tmp / name)
    # the float64 witness, truncated as both tools truncate
    m = TM.load_model(npz, device="cpu")
    m = dataclasses.replace(m, **{
        f.name: getattr(m, f.name).double() for f in dataclasses.fields(m)
        if torch.is_tensor(getattr(m, f.name))
        and getattr(m, f.name).is_floating_point()})
    paras, (W, H) = CAMERA["nyu"]
    verts, _ = TM.get_mano_vertices(
        m, *TM.split_params(torch.from_numpy(params).double()))
    with torch.no_grad():
        z = R.rasterize_depth(verts, m.faces,
                              R.full_frame_pixel_rays((W, H)).double(), paras)
    out["float64"] = z.reshape(N, H, W).numpy().astype(np.uint16)
    return out


def _read(d, i):
    img = cv2.imread(os.path.join(d, f"render_{i + 1:07d}.png"),
                     cv2.IMREAD_ANYDEPTH)
    assert img is not None and img.dtype == np.uint16
    assert img.shape == (480, 640)
    return img


def test_prerender_files_and_reader(renders):
    """The same file names; the port's PNGs read back the same with OpenCV
    and with the port's own reader (which chip_smoke.py uses)."""
    names = sorted(os.listdir(renders["port"]))
    assert names == sorted(os.listdir(renders["jax"]))
    assert names == [f"render_{i:07d}.png" for i in range(1, N + 1)]
    for i in range(N):
        img = _read(renders["port"], i)
        assert np.array_equal(
            img, TP.read_png16(os.path.join(renders["port"], names[i])))


@pytest.mark.parametrize("i", range(N))
def test_prerender_matches_jax(renders, i):
    """Each frame of both tools against the float64 render: at most
    DIFF_SHARE of its pixels differ, at most FAR_SHARE by more than 1 mm;
    the hand renders at ~600 mm (foreground median in 400-800 mm, as
    tests/test_prerender.py checks the JAX tool)."""
    ref = renders["float64"][i].astype(np.int64)
    assert (ref > 0).sum() > 5000
    for name in ("port", "jax"):
        img = _read(renders[name], i).astype(np.int64)
        diff = np.abs(img - ref)
        assert (diff > 0).mean() <= DIFF_SHARE, (name, (diff > 0).sum())
        assert (diff > 1).mean() <= FAR_SHARE, (name, (diff > 1).sum())
        assert 400 < np.median(img[img > 0]) < 800
    port = _read(renders["port"], i).astype(np.int64)
    jax_img = _read(renders["jax"], i).astype(np.int64)
    assert (port != jax_img).mean() <= DIFF_SHARE
    assert (np.abs(port - jax_img) > 1).mean() <= FAR_SHARE
