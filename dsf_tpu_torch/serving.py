"""Production inference on one GPU or data-parallel over several
(counterpart of dsf_tpu/serving.py).

The engine serves the two-stage ManoOCRStage from pre-cropped normalized
depth: requests of any size are padded up to the nearest batch bucket
(rows beyond the request repeat its last row and are dropped on return)
and requests above the largest bucket run in chunks of it.  Outputs are
world-frame millimetre joints (pixel and MANO branch), the 779-vertex
MANO mesh and the 62-D MANO parameters of each stage.

The predict body runs the skip-raster kernel once (stage-2 render),
the codec encode once (stage-2 remap) and the codec decode once per
stage.  Matmuls and convolutions run without TF32.  ``cfg.compute_dtype``
"bfloat16" runs the net in bfloat16, as the JAX package's engine does;
the stage-2 render, the codec and MANO's LBS stay float32 (the decode
reads the bfloat16 field in float32), and the ``mano_para_*`` outputs are
bfloat16 tensors, float32 arrays with ``as_numpy``.

With ``cfg.num_devices`` n above 1 the engine holds one replica of the
net and the renderer on each of ``devices`` (``cuda:0`` ... ``cuda:n-1``
by default): each bucket is split into n equal chunks, one a device, and
the results are concatenated in request order on the first device; a
bucket that does not divide by n raises, as the JAX engine's mesh does.

Raw frames go through ``predict_from_depth`` (the host crop of
``data.crop``, centred on the given or the foreground's centre of mass),
and a run directory of the port's loop loads through ``from_run_dir``.
``export`` writes one bucket's predict body as a ``torch.export``
program, which ``load_exported`` (``dsf_tpu_torch.exported``, re-exported
here) loads without the model code.

Example::

    eng = InferenceEngine(cfg, variables)          # device defaults to cuda
    out = eng.predict(img, center, M, cube)        # normalized crops
    out["joint_xyz_mm"]                            # (B, J_dataset, 3)

    eng = InferenceEngine.from_run_dir("checkpoint/nyu/<run>")
    out = eng.predict_from_depth(depth_frame)      # raw (480, 640) mm

    eng.export("predict_b8.pt2", bucket=8)
    call = load_exported("predict_b8.pt2")         # no model code needed
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from dsf_tpu_torch import exported
from dsf_tpu_torch import geometry as geo
from dsf_tpu_torch.config import CAMERA, Config, check_devices, net_depth
from dsf_tpu_torch.device import (compute_dtype, exact_float32,
                                  resolve_device, widen)
from dsf_tpu_torch.exported import load_exported  # noqa: F401 (re-export)
from dsf_tpu_torch.mano import model as mano_model
from dsf_tpu_torch.mano.constants import transfer_for_dataset
from dsf_tpu_torch.models.backbone import ManoOCRStage
from dsf_tpu_torch.models.weights import (load_into, load_reference_state_dict,
                                          reference_depth,
                                          state_dict_from_jax)
from dsf_tpu_torch.ops.offset_codec import offset2joint_softmax
from dsf_tpu_torch.render import renderer as rnd


def _load_config(run_dir: str) -> Config:
    """The ``Config`` of a run directory's config.json (its values are
    strings, as ``training.loop.run`` writes them; parsed back by field
    type)."""
    with open(os.path.join(run_dir, "config.json")) as f:
        raw = json.load(f)
    kwargs = {}
    for fld in dataclasses.fields(Config):
        if fld.name not in raw:
            continue
        s = raw[fld.name]
        if not isinstance(s, str):
            kwargs[fld.name] = s
        elif isinstance(fld.default, bool):
            kwargs[fld.name] = s in ("True", "true", "1")
        elif isinstance(fld.default, tuple):
            kwargs[fld.name] = tuple(ast.literal_eval(s))
        elif isinstance(fld.default, (int, float)):
            kwargs[fld.name] = type(fld.default)(s)
        else:
            kwargs[fld.name] = s
    return Config(**kwargs)


def _predict_body(cfg: Config, net, r: rnd.Renderer, tm, img, center, M,
                  cube) -> Dict[str, torch.Tensor]:
    """The predict body (dsf_tpu/serving.py:189-210): the net on one bucket,
    each stage's decode and MANO mesh in world millimetres."""
    outputs = net(img, r, center, cube)
    out = {}
    half = cube[:, None, 2:] / 2.0
    for idx, (pixel_pd, para_pd) in enumerate(outputs):
        juvd = offset2joint_softmax(pixel_pd, img, cfg.feature_para[0])
        jxyz = geo.uvd_nl_to_xyz_nl(juvd, center, M, cube, r.paras,
                                    cfg.input_size, r.flip)
        mano_jxyz, mano_mesh = rnd.get_mesh_xyz(r, widen(para_pd))
        out[f"joint_xyz_mm_{idx}"] = jxyz * half + center[:, None]
        out[f"mano_joint_xyz_mm_{idx}"] = mano_jxyz * half + center[:, None]
        out[f"mano_mesh_mm_{idx}"] = mano_mesh * half + center[:, None]
        out[f"mano_para_{idx}"] = para_pd
        out[f"joint_uvd_nl_{idx}"] = juvd
    last = len(outputs) - 1
    # canonical aliases: the final stage, dataset joint order
    out["joint_xyz_mm"] = out[f"joint_xyz_mm_{last}"][:, tm]
    out["mano_joint_xyz_mm"] = out[f"mano_joint_xyz_mm_{last}"][:, tm]
    return out


class PredictProgram(torch.nn.Module):
    """One replica's predict body as a module, for ``torch.export``: the
    net, the renderer's MANO constants as buffers (``ManoOCRStage.forward``
    takes the ``Renderer`` as an argument, so the renderer is rebuilt from
    them on each call) and the transfer map."""

    def __init__(self, cfg: Config, net, r: rnd.Renderer, tm):
        super().__init__()
        self.cfg, self.net, self._renderer = cfg, net, r
        self._mano_fields = [f.name for f in dataclasses.fields(r.mano)
                             if isinstance(getattr(r.mano, f.name),
                                           torch.Tensor)]
        for name in self._mano_fields:
            self.register_buffer(f"mano_{name}", getattr(r.mano, name))
        self.register_buffer("transfer_map", tm)

    def forward(self, img, center, M, cube) -> Dict[str, torch.Tensor]:
        mano = dataclasses.replace(self._renderer.mano, **{
            n: getattr(self, f"mano_{n}") for n in self._mano_fields})
        r = dataclasses.replace(self._renderer, mano=mano)
        return _predict_body(self.cfg, self.net, r, self.transfer_map, img,
                             center, M, cube)


class InferenceEngine:
    """Bucketed hand-pose inference.

    Args:
      cfg: a ``Config`` (dataset selects the camera and joint tables).
      variables: the JAX package's ``{"params", "batch_stats"}`` tree (numpy
        arrays), or the port's own state dict (reference key names).
      mano_npz: the converted MANO asset (default ``cfg.mano_model_path``).
      buckets: allowed batch sizes, ascending; larger requests are chunked.
      device: ``cuda`` when None; raises if CUDA is missing.  ``"cpu"``
        runs the plain versions of the kernels.
      devices: with ``cfg.num_devices`` n above 1, the replicas' devices
        (the first n; ``cuda:0`` ... ``cuda:n-1`` by default, or n times
        ``device`` when that is the CPU).  n above the devices given or
        visible raises (``config.check_devices``), and so does a bucket
        that n does not divide, before any device or file is touched.
    """

    def __init__(self, cfg: Config, variables: Mapping,
                 mano_npz: Optional[str] = None,
                 buckets: Sequence[int] = (1, 8, 32), device=None,
                 devices: Optional[Sequence] = None):
        depth = net_depth(cfg)
        dtype = compute_dtype(cfg)
        self.buckets = tuple(sorted(buckets))
        n = cfg.num_devices
        if devices is None and n > 1:
            cpu = device is not None and torch.device(device).type == "cpu"
            devices = ([device] * n if cpu else
                       [f"cuda:{i}" for i in range(torch.cuda.device_count())])
        if devices is not None:
            check_devices(cfg, len(devices))
            bad = [b for b in self.buckets if b % n]
            if bad:
                raise ValueError(f"buckets {bad} not divisible by "
                                 f"num_devices={n}")
        self.devices = [resolve_device(d) for d in (devices or [device])[:n]]
        self.device = self.devices[0]
        self.cfg = cfg
        self.paras, self.img_size = CAMERA[cfg.dataset]
        self.transfer_map = np.asarray(transfer_for_dataset(cfg.dataset))
        sd = (state_dict_from_jax(variables) if "params" in variables
              else variables)
        # one (net, renderer, transfer map) a device
        self.replicas = []
        for dev in self.devices:
            mano = mano_model.load_model(mano_npz or cfg.mano_model_path,
                                         device=dev)
            renderer = rnd.Renderer.create(
                mano, cfg.dataset, self.paras, self.img_size,
                (cfg.input_size, cfg.input_size))
            net = ManoOCRStage(joint_num=21, depth=depth,
                               refine=cfg.stage_num == 2, dtype=dtype)
            load_into(net, sd)
            self.replicas.append((net.to(dev).eval(), renderer, torch.as_tensor(
                self.transfer_map, device=dev)))
        self.net, self.renderer, _ = self.replicas[0]

    @classmethod
    def from_torch_checkpoint(cls, pth: str, dataset: str = "nyu",
                              stage_num: int = 2,
                              mano_npz: str = "./MANO/mano_right.npz",
                              buckets: Sequence[int] = (1, 8, 32),
                              device=None):
        """Serve a reference MANO_OCR_stage ``.pth`` directly, at the
        trunks' depth its keys hold (``weights.reference_depth``)."""
        sd = load_reference_state_dict(pth)
        cfg = Config(dataset=dataset, stage_num=stage_num, phase="test",
                     mano_model_path=mano_npz,
                     net=f"ResNet_stage_{reference_depth(sd)}")
        return cls(cfg, sd, buckets=buckets, device=device)

    @classmethod
    def from_run_dir(cls, run_dir: str, which: str = "best",
                     mano_npz: Optional[str] = None,
                     buckets: Sequence[int] = (1, 8, 32), device=None):
        """Serve a run of the port's loop: its config.json and its ``which``
        checkpoint (``best``, written with test_during_train, or
        ``latest``), falling back best -> latest; a checkpoint directory
        inside ``run_dir`` is not needed when ``run_dir`` is one."""
        from dsf_tpu_torch.training import checkpoints as ckpt
        cfg = _load_config(run_dir)
        path = run_dir
        for cand in (which, "latest"):
            if os.path.isdir(os.path.join(run_dir, cand)):
                path = os.path.join(run_dir, cand)
                break
        return cls(cfg, ckpt.restore_variables(path), mano_npz=mano_npz,
                   buckets=buckets, device=device)

    # ------------------------------------------------------------ predict

    def _bucket_forward(self, args) -> Dict[str, torch.Tensor]:
        """One bucket on the replicas: equal chunks, one a device, the
        results concatenated in order on the first device."""
        if len(self.replicas) == 1:
            return self._forward(*args)
        n = len(self.replicas)
        outs = [self._forward(*[a.to(dev) for a in chunk], replica=i)
                for i, (dev, chunk) in enumerate(zip(
                    self.devices, zip(*[a.chunk(n) for a in args])))]
        return {k: torch.cat([o[k].to(self.device) for o in outs])
                for k in outs[0]}

    def _forward(self, img, center, M, cube, replica=0
                 ) -> Dict[str, torch.Tensor]:
        """One bucket (or a replica's chunk of one): the predict body."""
        net, r, tm = self.replicas[replica]
        return _predict_body(self.cfg, net, r, tm, img, center, M, cube)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def predict(self, img, center, M, cube, as_numpy: bool = True):
        """``img`` (B, 1, S, S) normalized depth crops in [-1, 1], ``center``
        (B, 3) xyz mm, ``M`` (B, 3, 3) crop matrices, ``cube`` (B, 3) mm;
        numpy arrays or tensors, any B >= 1.

        ``as_numpy=False`` returns tensors on the engine's device without
        waiting for the device.  Numpy has no bfloat16: ``as_numpy``
        returns a bfloat16 output (``mano_para_*`` under the bfloat16
        compute dtype) as float32, which holds its values exactly."""
        args = [(x if isinstance(x, torch.Tensor)
                 else torch.from_numpy(np.array(x, np.float32)))
                .to(self.device, torch.float32)
                for x in (img, center, M, cube)]
        n = args[0].shape[0]
        chunks = []
        i = 0
        with torch.inference_mode(), exact_float32():
            while i < n:
                take = min(n - i, self.buckets[-1])
                pads = self._bucket(take) - take
                part = [a[i:i + take] for a in args]
                if pads:
                    part = [torch.cat([a, a[-1:].expand(pads, *a.shape[1:])])
                            for a in part]
                res = self._bucket_forward(part)
                chunks.append({k: v[:take] for k, v in res.items()})
                i += take
        out = (chunks[0] if len(chunks) == 1 else
               {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]})
        if as_numpy:
            return {k: widen(v).cpu().numpy() for k, v in out.items()}
        return out

    def predict_from_depth(self, depth, com_xyz=None, cube_mm=None):
        """Raw frames: ``depth`` (H, W) or (B, H, W) in mm; ``com_xyz``
        (B, 3) the hand centres in camera mm, or None for the foreground's
        centre of mass (``_com``; pass refined centres for protocol-grade
        crops); ``cube_mm`` (3,) or (B, 3), default the config's cube.
        Each frame is cropped and normalized on the host
        (``crop.crop_image_deep_pp``), then served by ``predict``."""
        from dsf_tpu_torch.data import crop as C
        depth = np.asarray(depth, np.float32)
        if depth.ndim == 2:
            depth = depth[None]
        B = depth.shape[0]
        cube = np.asarray(
            cube_mm if cube_mm is not None
            else np.tile(np.asarray(self.cfg.cube_size, np.float32), (B, 1)),
            np.float32)
        if cube.ndim == 1:
            cube = np.tile(cube, (B, 1))
        if com_xyz is None:
            com_xyz = np.stack([self._com(d) for d in depth])
        com_xyz = np.asarray(com_xyz, np.float32)
        S = self.cfg.input_size
        imgs = np.empty((B, 1, S, S), np.float32)
        Ms = np.empty((B, 3, 3), np.float32)
        for i in range(B):
            com_uvd = C.joint_3d_to_img(com_xyz[i], self.paras,
                                        self.renderer.flip)
            dcrop, trans = C.crop_image_deep_pp(
                depth[i], com_uvd, cube[i].astype(np.float64), (S, S),
                self.paras)
            imgs[i, 0] = C.normalize_img(dcrop.max(), dcrop, com_xyz[i],
                                         cube[i])
            Ms[i] = trans
        return self.predict(imgs, com_xyz, Ms, cube)

    def _com(self, depth) -> np.ndarray:
        """The foreground's centre of mass in camera xyz mm (serving
        without a detector); (0, 0, cube z) for an empty frame."""
        from dsf_tpu_torch.data import crop as C
        v, u = np.nonzero(depth > 0)
        if len(v) == 0:
            return np.array([0.0, 0.0, float(self.cfg.cube_size[2])],
                            np.float32)
        z = depth[v, u]
        com_uvd = np.array([u.mean(), v.mean(), z.mean()], np.float32)
        return C.joint_img_to_3d(com_uvd, self.paras,
                                 self.renderer.flip).astype(np.float32)

    def export(self, path: str, bucket: Optional[int] = None) -> str:
        """Write one bucket's predict body (``bucket``, default the largest)
        as a ``torch.export`` program with the weights baked in, one
        ``.pt2`` file, at that bucket's fixed shapes, the engine's compute
        dtype and on its first device; the raster route is the one
        ``rasterize.USE_PALLAS_SKIP`` picks now.  ``load_exported`` loads
        it with the port's op registry and no model code, checkpoint or
        ``Config`` (ref: dsf_tpu/serving.py:325-350).  Returns ``path``."""
        b = bucket or self.buckets[-1]
        S = self.cfg.input_size
        net, r, tm = self.replicas[0]
        prog = PredictProgram(self.cfg, net, r, tm).eval()
        f32 = dict(dtype=torch.float32, device=self.device)
        args = (torch.zeros((b, 1, S, S), **f32), torch.zeros((b, 3), **f32),
                torch.eye(3, **f32).expand(b, 3, 3).contiguous(),
                torch.ones((b, 3), **f32))
        with torch.no_grad():
            ep = torch.export.export(prog, args)
        exported.save(ep, path, bucket=b, input_size=S,
                      device=self.device.type, device_name=str(self.device),
                      compute_dtype=self.cfg.compute_dtype)
        return path

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run each bucket once before taking traffic (builds the kernels,
        lets cuDNN pick its algorithms for the engine's compute dtype)."""
        S = self.cfg.input_size
        for b in buckets or self.buckets:
            img = np.zeros((b, 1, S, S), np.float32)
            center = np.tile([[0.0, 0.0, 750.0]], (b, 1)).astype(np.float32)
            cube = np.full((b, 3), float(self.cfg.cube_size[0]), np.float32)
            com = geo.xyz_to_uvd(torch.as_tensor(center), self.paras)
            M = geo.crop_matrix(com, torch.as_tensor(cube), self.paras,
                                (S, S))
            self.predict(img, center, M, cube)
