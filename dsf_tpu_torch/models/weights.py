"""Weights carried between the JAX package, reference checkpoints and the
port (counterpart of dsf_tpu/models/torch_import.py).

``state_dict_from_jax`` is the exact inverse of the JAX package's
``convert_mano_ocr_stage``:
  conv    flax HWIO (kh, kw, in, out)            -> torch (out, in, kh, kw)
  deconv  flax transpose_kernel (kh, kw, out, in) -> torch (in, out, kh, kw)
  (both are .transpose(3, 2, 0, 1))
  dense   flax (in, out)                          -> torch (out, in)
  bn      scale / bias + batch_stats mean / var   -> weight / bias /
          running_mean / running_var

``generator_state_dict_from_jax`` is the inverse of
``convert_cyclegan_generator`` for the frozen CycleGAN generator, with the
same conv and deconv rules.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    # a copy: jax arrays convert to read-only numpy arrays
    return torch.from_numpy(np.array(x, np.float32))


def _kernel(x) -> torch.Tensor:
    return _t(np.asarray(x, np.float32).transpose(3, 2, 0, 1))


def state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ManoOCRStage ``{"params", "batch_stats"}`` tree
    (numpy or jax arrays) -> the port's ManoOCRStage state dict.  Two
    stages when the tree has ``fusion``."""
    P, S = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def bn(dst, p, s):
        sd[f"{dst}.weight"] = _t(p["bn"]["scale"])
        sd[f"{dst}.bias"] = _t(p["bn"]["bias"])
        sd[f"{dst}.running_mean"] = _t(s["bn"]["mean"])
        sd[f"{dst}.running_var"] = _t(s["bn"]["var"])
        sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def trunk(tp, ts, suffix, stem):
        if stem:
            sd["pre.0.weight"] = _kernel(tp["pre_conv"]["conv"]["kernel"])
            bn("pre.1", tp["pre_bn"], ts["pre_bn"])
        for li in range(1, 5):
            lp, ls = tp[f"layer{li}"], ts[f"layer{li}"]
            for bi in range(len(lp)):
                bp, bs = lp[f"block{bi}"], ls[f"block{bi}"]
                pre = f"layer{li}{suffix}.{bi}"
                for ci in (1, 2):
                    sd[f"{pre}.conv{ci}.weight"] = _kernel(
                        bp[f"conv{ci}"]["conv"]["kernel"])
                    bn(f"{pre}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
                if "down_conv" in bp:
                    sd[f"{pre}.downsample.0.weight"] = _kernel(
                        bp["down_conv"]["conv"]["kernel"])
                    bn(f"{pre}.downsample.1", bp["down_bn"], bs["down_bn"])

    def heads(hp, hs, suffix):
        sd[f"mano_regress{suffix}.2.weight"] = _t(
            np.asarray(hp["mano_regress"]["kernel"], np.float32).T)
        sd[f"mano_regress{suffix}.2.bias"] = _t(hp["mano_regress"]["bias"])
        for name, li in (("deconv4", 4), ("deconv3", 3), ("deconv2", 2)):
            pre = f"deconv_layer{li}{suffix}"
            sd[f"{pre}.0.weight"] = _kernel(
                hp[name]["deconv"]["deconv"]["kernel"])
            bn(f"{pre}.1", hp[name]["bn"], hs[name]["bn"])
        for i, name in enumerate(("final_offset", "final_heat")):
            sd[f"finals{suffix}.{i}.weight"] = _kernel(hp[name]["conv"]["kernel"])
            sd[f"finals{suffix}.{i}.bias"] = _t(hp[name]["conv"]["bias"])

    trunk(P["trunk"], S["trunk"], "", stem=True)
    heads(P["heads"], S["heads"], "")
    if "fusion" in P:
        sd["fusion.0.weight"] = _kernel(P["fusion"]["conv"]["conv"]["kernel"])
        bn("fusion.1", P["fusion"]["bn"], S["fusion"]["bn"])
        trunk(P["trunk_s2"], S["trunk_s2"], "_s2", stem=False)
        heads(P["heads_s2"], S["heads_s2"], "_s2")
    return sd


def load_reference_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference MANO_OCR_stage ``.pth`` (a state dict, or a dict holding
    it under ``"model"``, as the reference's trainer saves it) -> CPU
    tensors keyed by the reference names."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model" in sd:
        sd = sd["model"]
    return {k: torch.as_tensor(v) for k, v in sd.items()
            if isinstance(v, (torch.Tensor, np.ndarray))}


def load_into(net: torch.nn.Module, sd: Mapping) -> None:
    """``net.load_state_dict(sd)`` for tensors or numpy arrays, strict
    except that BatchNorm's ``num_batches_tracked`` counters may be absent
    (older checkpoints and hand-built dicts lack them; eval mode never
    reads them)."""
    res = net.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()},
                              strict=False)
    missing = [k for k in res.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or res.unexpected_keys:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, "
                       f"unexpected {res.unexpected_keys[:8]}")


def random_reference_state_dict(rng: np.random.RandomState,
                                refine: bool = True) -> Dict[str, np.ndarray]:
    """A reference-layout MANO_OCR_stage state dict (21 joints) drawn from
    numpy: He-scaled convs (activations stay O(1) through the trunk),
    1e-3-scaled heads as the reference initializes them, random BatchNorm
    affine parameters and running statistics, and a ``mano_regress`` bias
    that puts a visible hand in the crop (cam scale 1 at index 58, the rest
    0)."""
    sd = {}
    J = 21

    def conv(name, out_c, in_c, k, std=None):
        std = np.sqrt(2.0 / (k * k * in_c)) if std is None else std
        sd[f"{name}.weight"] = (rng.randn(out_c, in_c, k, k) * std).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        sd[f"{name}.bias"] = (rng.randn(c) * 0.05).astype(np.float32)
        sd[f"{name}.running_mean"] = (rng.randn(c) * 0.05).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.8, 1.5, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(100, np.int64)

    def basic_block(prefix, in_c, out_c, stride):
        conv(f"{prefix}.conv1", out_c, in_c, 3)
        bn(f"{prefix}.bn1", out_c)
        conv(f"{prefix}.conv2", out_c, out_c, 3, std=np.sqrt(1.0 / (9 * out_c)))
        bn(f"{prefix}.bn2", out_c)
        if stride != 1 or in_c != out_c:
            conv(f"{prefix}.downsample.0", out_c, in_c, 1)
            bn(f"{prefix}.downsample.1", out_c)

    def res_layers(suffix, in0):
        in_c = in0
        for li, (c, s) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)], 1):
            basic_block(f"layer{li}{suffix}.0", in_c, c, s)
            basic_block(f"layer{li}{suffix}.1", c, c, 1)
            in_c = c

    def heads(suffix):
        sd[f"mano_regress{suffix}.2.weight"] = (rng.randn(62, 512) * 1e-3).astype(np.float32)
        bias = np.zeros(62, np.float32)
        bias[58] = 1.0
        sd[f"mano_regress{suffix}.2.bias"] = bias
        ins = 512
        for li in (4, 3, 2):
            sd[f"deconv_layer{li}{suffix}.0.weight"] = (
                rng.randn(ins, 256, 4, 4) * np.sqrt(2.0 / (4 * ins))).astype(np.float32)
            bn(f"deconv_layer{li}{suffix}.1", 256)
            ins = 256
        conv(f"finals{suffix}.0", 3 * J, 256, 1, std=1e-3)
        sd[f"finals{suffix}.0.bias"] = (rng.randn(3 * J) * 1e-3).astype(np.float32)
        conv(f"finals{suffix}.1", J, 256, 1, std=1e-3)
        sd[f"finals{suffix}.1.bias"] = (rng.randn(J) * 1e-3).astype(np.float32)

    conv("pre.0", 64, 1, 5)
    bn("pre.1", 64)
    res_layers("", 64)
    heads("")
    if refine:
        conv("fusion.0", 256, 64 + 256 + 4 * J + 4 * J, 3)
        bn("fusion.1", 256)
        res_layers("_s2", 256)
        heads("_s2")
    return sd


# ---------------------------------------------------------------------------
# The CycleGAN generator (the frozen transfer net of the training steps)
# ---------------------------------------------------------------------------

def _generator_blocks(params: Mapping) -> int:
    return sum(1 for k in params if k.startswith("res"))


def generator_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ResnetGenerator`` tree ``{"params": {stem,
    down0, down1, res{i}/{c1, c2}, up0, up1, head}}`` (numpy or jax
    arrays) -> the port's ``ResnetGenerator`` state dict, the reference's
    pix2pix names (the inverse of the JAX package's
    ``torch_import.convert_cyclegan_generator``)."""
    P = variables["params"]
    n = _generator_blocks(P)
    sd: Dict[str, torch.Tensor] = {}

    def put(dst, p):
        sd[f"{dst}.weight"] = _kernel(p["kernel"])
        sd[f"{dst}.bias"] = _t(p["bias"])

    put("model.1", P["stem"]["conv"])
    put("model.4", P["down0"]["conv"])
    put("model.7", P["down1"]["conv"])
    for i in range(n):
        for j, c in ((1, "c1"), (5, "c2")):
            put(f"model.{10 + i}.conv_block.{j}", P[f"res{i}"][c]["conv"])
    put(f"model.{10 + n}", P["up0"]["deconv"])
    put(f"model.{13 + n}", P["up1"]["deconv"])
    put(f"model.{17 + n}", P["head"]["conv"])
    return sd


def load_reference_generator(path_or_dir: str) -> Dict[str, torch.Tensor]:
    """A reference CycleGAN generator checkpoint (``latest_net_G_A.pth``,
    or a directory holding it) -> CPU tensors under the reference names.
    Instance-norm statistics of old pix2pix checkpoints are dropped, as
    pix2pix's own loader drops them: the norm keeps none."""
    path = path_or_dir
    if os.path.isdir(path):
        path = os.path.join(path, "latest_net_G_A.pth")
    sd = load_reference_state_dict(path)
    return {k: v for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


def load_generator_npz(path: str) -> Dict[str, torch.Tensor]:
    """A generator exported by the JAX package's CycleGAN pipeline
    (``transfer_G_A.npz``: each leaf of the variables tree under its
    "/"-joined path, as ``pipelines.save_variables_npz`` writes it) -> the
    port's state dict."""
    tree: Dict = {}
    with np.load(path) as raw:
        for key in raw.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = raw[key]
    return generator_state_dict_from_jax(tree)


def _truncated_normal(rng: np.random.RandomState, shape, std):
    """N(0, std^2 / 0.8796^2) truncated to two of its standard deviations:
    flax's ``variance_scaling(..., "truncated_normal")``, whose scale puts
    the truncated variance at std^2."""
    n = int(np.prod(shape))
    out = np.empty(0)
    while out.size < n:
        z = rng.randn(2 * n)
        out = np.concatenate([out, z[np.abs(z) <= 2.0]])
    return (out[:n].reshape(shape) * std / 0.87962566103423978).astype(np.float32)


def random_generator_state_dict(rng: np.random.RandomState, ngf: int = 64,
                                n_blocks: int = 9) -> Dict[str, np.ndarray]:
    """A seeded stand-in for the frozen generator (1 -> 1 channels), in the
    reference's names, drawn with numpy from the JAX generator's init
    distributions: lecun-normal (truncated) for the convs (flax ``nn.Conv``),
    N(0, 0.001^2) for the two deconvs (``layers.ConvTranspose``'s
    ``normal001_init``), zero biases."""
    sd: Dict[str, np.ndarray] = {}

    def conv(name, out_c, in_c, k):
        sd[f"{name}.weight"] = _truncated_normal(
            rng, (out_c, in_c, k, k), np.sqrt(1.0 / (in_c * k * k)))
        sd[f"{name}.bias"] = np.zeros(out_c, np.float32)

    def deconv(name, in_c, out_c):
        sd[f"{name}.weight"] = (rng.randn(in_c, out_c, 3, 3) * 1e-3).astype(np.float32)
        sd[f"{name}.bias"] = np.zeros(out_c, np.float32)

    conv("model.1", ngf, 1, 7)
    conv("model.4", 2 * ngf, ngf, 3)
    conv("model.7", 4 * ngf, 2 * ngf, 3)
    for i in range(n_blocks):
        for j in (1, 5):
            conv(f"model.{10 + i}.conv_block.{j}", 4 * ngf, 4 * ngf, 3)
    deconv(f"model.{10 + n_blocks}", 4 * ngf, 2 * ngf)
    deconv(f"model.{13 + n_blocks}", 2 * ngf, ngf)
    conv(f"model.{17 + n_blocks}", 1, ngf, 7)
    return sd
