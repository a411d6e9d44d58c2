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
``convert_cyclegan_generator`` for the CycleGAN generator, with the same
conv and deconv rules, and ``discriminator_state_dict_from_jax`` carries
the PatchGAN discriminator; ``*_to_jax`` are their exact inverses (the
CycleGAN trainer's export), and ``convs_from_jax`` / ``convs_to_jax``
with the ``*_convs`` tables carry every CycleGAN net.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Tuple

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
                # conv1-2 in a BasicBlock, conv1-3 in a Bottleneck
                ci = 1
                while f"conv{ci}" in bp:
                    sd[f"{pre}.conv{ci}.weight"] = _kernel(
                        bp[f"conv{ci}"]["conv"]["kernel"])
                    bn(f"{pre}.bn{ci}", bp[f"bn{ci}"], bs[f"bn{ci}"])
                    ci += 1
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


def reference_depth(sd: Mapping) -> int:
    """The ResNet depth of a reference-layout state dict: its blocks'
    type (``conv3`` in a Bottleneck) and block counts per layer, as
    ``models.resnet.RESNET_SPECS`` lists them; raises KeyError for
    another layout."""
    from dsf_tpu_torch.models.resnet import RESNET_SPECS, Bottleneck
    counts = [len({k.split(".")[1] for k in sd
                   if k.startswith(f"layer{i}.") and k.endswith("conv1.weight")})
              for i in range(1, 5)]
    bottleneck = "layer1.0.conv3.weight" in sd
    for depth, (block, blocks) in RESNET_SPECS.items():
        if list(blocks) == counts and (block is Bottleneck) == bottleneck:
            return depth
    raise KeyError(f"no ResNet depth has blocks {counts} "
                   f"({'Bottleneck' if bottleneck else 'BasicBlock'})")


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
                                refine: bool = True,
                                depth: int = 18) -> Dict[str, np.ndarray]:
    """A reference-layout MANO_OCR_stage state dict (21 joints, ResNet
    trunks of ``depth``: 18, 50, 101 or 152) drawn from numpy: He-scaled
    convs (activations stay O(1) through the trunk), 1e-3-scaled heads as
    the reference initializes them, random BatchNorm affine parameters and
    running statistics, and a ``mano_regress`` bias that puts a visible
    hand in the crop (cam scale 1 at index 58, the rest 0).

    A Bottleneck's residual branch is damped: its ``bn3`` scale is divided
    by the square root of the trunk's block count, so the residual stream
    grows by a bounded factor over the 16 to 50 blocks in eval and train
    mode alike (undamped, the eval-mode stream of a 152-layer trunk grows
    without bound and the stage-2 render sees no hand).  Depth 18 draws
    what it always has, in the same order."""
    from dsf_tpu_torch.models.resnet import RESNET_SPECS, BasicBlock
    block, blocks = RESNET_SPECS[depth]
    exp = block.expansion
    damp = 1.0 / np.sqrt(sum(blocks))
    sd = {}
    J = 21

    def conv(name, out_c, in_c, k, std=None):
        std = np.sqrt(2.0 / (k * k * in_c)) if std is None else std
        sd[f"{name}.weight"] = (rng.randn(out_c, in_c, k, k) * std).astype(np.float32)

    def bn(name, c, scale=None):
        w = rng.uniform(0.8, 1.2, c).astype(np.float32)
        sd[f"{name}.weight"] = w if scale is None else (w * scale).astype(np.float32)
        sd[f"{name}.bias"] = (rng.randn(c) * 0.05).astype(np.float32)
        sd[f"{name}.running_mean"] = (rng.randn(c) * 0.05).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.8, 1.5, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(100, np.int64)

    def basic_block(prefix, in_c, planes, stride):
        out_c = planes
        conv(f"{prefix}.conv1", out_c, in_c, 3)
        bn(f"{prefix}.bn1", out_c)
        conv(f"{prefix}.conv2", out_c, out_c, 3, std=np.sqrt(1.0 / (9 * out_c)))
        bn(f"{prefix}.bn2", out_c)
        if stride != 1 or in_c != out_c:
            conv(f"{prefix}.downsample.0", out_c, in_c, 1)
            bn(f"{prefix}.downsample.1", out_c)

    def bottleneck(prefix, in_c, planes, stride):
        out_c = planes * exp
        conv(f"{prefix}.conv1", planes, in_c, 1)
        bn(f"{prefix}.bn1", planes)
        conv(f"{prefix}.conv2", planes, planes, 3)
        bn(f"{prefix}.bn2", planes)
        conv(f"{prefix}.conv3", out_c, planes, 1, std=np.sqrt(1.0 / planes))
        bn(f"{prefix}.bn3", out_c, scale=damp)
        if stride != 1 or in_c != out_c:
            conv(f"{prefix}.downsample.0", out_c, in_c, 1)
            bn(f"{prefix}.downsample.1", out_c)

    draw_block = basic_block if block is BasicBlock else bottleneck

    def res_layers(suffix, in0):
        in_c = in0
        for li, (c, s) in enumerate([(64, 1), (128, 2), (256, 2), (512, 2)], 1):
            for bi in range(blocks[li - 1]):
                draw_block(f"layer{li}{suffix}.{bi}", in_c, c, s if bi == 0 else 1)
                in_c = c * exp

    def heads(suffix):
        feat = 512 * exp
        sd[f"mano_regress{suffix}.2.weight"] = (rng.randn(62, feat) * 1e-3).astype(np.float32)
        bias = np.zeros(62, np.float32)
        bias[58] = 1.0
        sd[f"mano_regress{suffix}.2.bias"] = bias
        ins = feat
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


# Each CycleGAN net's convolutions as (path in the JAX package's params
# tree, the port's module name): the tree holds ``kernel`` (HWIO, or a
# transposed conv's (kh, kw, out, in)) and ``bias`` at the path, the port
# ``.weight`` and ``.bias`` under the name.

def encoder_convs(n_blocks: int) -> List[Tuple[str, str]]:
    """``ResnetEncoder``'s (and the generator's first half's) convs."""
    convs = [("stem/conv", "model.1"), ("down0/conv", "model.4"),
             ("down1/conv", "model.7")]
    for i in range(n_blocks):
        convs += [(f"res{i}/c1/conv", f"model.{10 + i}.conv_block.1"),
                  (f"res{i}/c2/conv", f"model.{10 + i}.conv_block.5")]
    return convs


def decoder_convs(first: int = 0) -> List[Tuple[str, str]]:
    """``ResnetDecoder``'s convs, its Sequential starting at ``first``
    (10 + n_blocks inside the generator)."""
    return [("up0/deconv", f"model.{first}"),
            ("up1/deconv", f"model.{first + 3}"),
            ("head/conv", f"model.{first + 7}")]


def generator_convs(n_blocks: int) -> List[Tuple[str, str]]:
    """``ResnetGenerator``'s convs (the reference's pix2pix names)."""
    return encoder_convs(n_blocks) + decoder_convs(10 + n_blocks)


def discriminator_convs(n_layers: int = 3) -> List[Tuple[str, str]]:
    """``NLayerDiscriminator``'s convs (pix2pix's indices)."""
    return ([("c0/conv", "model.0")]
            + [(f"c{i}/conv", f"model.{3 * i - 1}")
               for i in range(1, n_layers + 1)]
            + [("head/conv", f"model.{3 * n_layers + 2}")])


def pixel_discriminator_convs() -> List[Tuple[str, str]]:
    """``PixelDiscriminator``'s convs."""
    return [("c0/conv", "net.0"), ("c1/conv", "net.2"), ("head/conv", "net.5")]


def unet_convs(num_downs: int) -> List[Tuple[str, str]]:
    """``UnetGenerator``'s convs."""
    return ([(f"down{i}", f"downs.{i}") for i in range(num_downs)]
            + [(f"up{i}/deconv", f"ups.{i}") for i in range(num_downs - 1)]
            + [("head/deconv", "head")])


def convs_from_jax(variables: Mapping, convs) -> Dict[str, torch.Tensor]:
    """A JAX ``{"params": ...}`` tree (numpy or jax arrays) -> the port's
    state dict over ``convs``; kernels .transpose(3, 2, 0, 1)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, name in convs:
        p = variables["params"]
        for part in path.split("/"):
            p = p[part]
        sd[f"{name}.weight"] = _kernel(p["kernel"])
        sd[f"{name}.bias"] = _t(p["bias"])
    return sd


def convs_to_jax(sd: Mapping, convs) -> Dict:
    """The exact inverse of ``convs_from_jax``: the port's state dict (or
    a module's) -> ``{"params": ...}`` of float32 numpy arrays, kernels
    .transpose(2, 3, 1, 0)."""
    params: Dict = {}
    for path, name in convs:
        node = params
        for part in path.split("/"):
            node = node.setdefault(part, {})
        w = torch.as_tensor(sd[f"{name}.weight"]).detach().cpu()
        node["kernel"] = w.numpy().astype(np.float32).transpose(2, 3, 1, 0)
        node["bias"] = np.array(torch.as_tensor(sd[f"{name}.bias"]).detach()
                                .cpu().numpy(), np.float32)
    return {"params": params}


def generator_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's ``ResnetGenerator`` tree ``{"params": {stem,
    down0, down1, res{i}/{c1, c2}, up0, up1, head}}`` (numpy or jax
    arrays) -> the port's ``ResnetGenerator`` state dict, the reference's
    pix2pix names (the inverse of the JAX package's
    ``torch_import.convert_cyclegan_generator``)."""
    return convs_from_jax(
        variables, generator_convs(_generator_blocks(variables["params"])))


def generator_state_dict_to_jax(sd: Mapping) -> Dict:
    """The exact inverse of ``generator_state_dict_from_jax``: the port's
    generator state dict -> the JAX tree ``{"params": ...}`` (numpy)."""
    n = sum(1 for k in sd if k.endswith("conv_block.1.weight"))
    return convs_to_jax(sd, generator_convs(n))


def discriminator_state_dict_from_jax(variables: Mapping
                                      ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``NLayerDiscriminator`` tree ``{"params": {c0 ..
    c{n_layers}, head}}`` -> the port's state dict (pix2pix's names)."""
    n_layers = sum(1 for k in variables["params"] if k.startswith("c")) - 1
    return convs_from_jax(variables, discriminator_convs(n_layers))


def discriminator_state_dict_to_jax(sd: Mapping) -> Dict:
    """The exact inverse of ``discriminator_state_dict_from_jax``."""
    n_layers = sum(1 for k in sd if k.endswith(".weight")) - 2
    return convs_to_jax(sd, discriminator_convs(n_layers))


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


def load_variables_npz(path: str) -> Dict:
    """A variables tree saved as an npz of its leaves under their
    "/"-joined paths (``pipelines.save_variables_npz``, and the JAX
    package's) -> the nested dict of numpy arrays."""
    tree: Dict = {}
    with np.load(path) as raw:
        for key in raw.files:
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = raw[key]
    return tree


def load_generator_npz(path: str) -> Dict[str, torch.Tensor]:
    """A generator exported by a CycleGAN pipeline, the port's or the JAX
    package's (``transfer_G_A.npz``, ``load_variables_npz``'s layout) ->
    the port's state dict."""
    return generator_state_dict_from_jax(load_variables_npz(path))


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


def random_discriminator_state_dict(rng: np.random.RandomState, ndf: int = 64,
                                    n_layers: int = 3, input_nc: int = 1
                                    ) -> Dict[str, np.ndarray]:
    """A ``NLayerDiscriminator`` state dict drawn with numpy from the JAX
    discriminator's init, Flax ``nn.Conv``'s default: lecun-normal
    (truncated) 4x4 kernels, zero biases; in the order c0, c1 ..,
    head."""
    sd: Dict[str, np.ndarray] = {}
    chans = [input_nc, ndf] + [ndf * min(2 ** i, 8)
                               for i in range(1, n_layers + 1)] + [1]
    for (_, name), c_in, c_out in zip(discriminator_convs(n_layers),
                                      chans[:-1], chans[1:]):
        sd[f"{name}.weight"] = _truncated_normal(
            rng, (c_out, c_in, 4, 4), np.sqrt(1.0 / (c_in * 16)))
        sd[f"{name}.bias"] = np.zeros(c_out, np.float32)
    return sd


# ---------------------------------------------------------------------------
# The hourglass PoseNet (models/hourglass.py; ref model/hourglass.py)
# ---------------------------------------------------------------------------

def pose_net_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX package's hourglass ``PoseNet`` ``{"params",
    "batch_stats"}`` tree (numpy or jax arrays) -> the port's ``PoseNet``
    state dict: the inverse of its ``convert_pose_net``."""
    P, S = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}

    def bn(dst, p, s):
        sd[f"{dst}.weight"] = _t(p["bn"]["scale"])
        sd[f"{dst}.bias"] = _t(p["bn"]["bias"])
        sd[f"{dst}.running_mean"] = _t(s["bn"]["mean"])
        sd[f"{dst}.running_var"] = _t(s["bn"]["var"])
        sd[f"{dst}.num_batches_tracked"] = torch.tensor(0)

    def conv(dst, p):
        sd[f"{dst}.weight"] = _kernel(p["conv"]["kernel"])
        sd[f"{dst}.bias"] = _t(p["conv"]["bias"])

    def hg_conv(dst, p, s=None):
        conv(f"{dst}.conv", p)
        if "bn" in p:
            bn(f"{dst}.bn", p["bn"], s["bn"])

    def residual(dst, p, s):
        for i in (1, 2, 3):
            bn(f"{dst}.bn{i}", p[f"bn{i}"], s[f"bn{i}"])
            hg_conv(f"{dst}.conv{i}", p[f"c{i}"])
        if "skip" in p:
            hg_conv(f"{dst}.skip_layer", p["skip"])

    def hourglass(dst, p, s):
        for name in ("up1", "low1", "low3"):
            residual(f"{dst}.{name}", p[name], s[name])
        if "up1" in p["low2"]:
            hourglass(f"{dst}.low2", p["low2"], s["low2"])
        else:
            residual(f"{dst}.low2", p["low2"], s["low2"])

    hg_conv("pre.0", P["pre_conv"], S["pre_conv"])
    for ours, theirs in (("pre.1", "pre_r1"), ("pre.3", "pre_r2"),
                         ("pre.4", "pre_r3")):
        residual(ours, P[theirs], S[theirs])
    nstack = sum(1 for k in P if k.startswith("hg"))
    for i in range(nstack):
        hourglass(f"hgs.{i}", P[f"hg{i}"], S[f"hg{i}"])
        residual(f"features.{i}.0", P[f"feat_r{i}"], S[f"feat_r{i}"])
        hg_conv(f"features.{i}.1", P[f"feat_c{i}"], S[f"feat_c{i}"])
        for j in (1, 2, 3):
            conv(f"outs_{j}.{i}", P[f"out{j}_{i}"])
        if i < nstack - 1:
            hg_conv(f"merge_preds.{i}.conv", P[f"merge_pred{i}"])
            hg_conv(f"merge_features.{i}.conv", P[f"merge_feat{i}"])
    return sd


def pose_net_dims(sd: Mapping) -> Dict[str, int]:
    """``PoseNet``'s constructor arguments (nstack, joint_num, inp_dim,
    in_ch) read from a reference-layout or port state dict."""
    return {"nstack": sum(1 for k in sd if k.startswith("outs_1.")
                          and k.endswith(".weight")),
            "joint_num": int(sd["outs_2.0.weight"].shape[0]),
            "inp_dim": int(sd["outs_1.0.weight"].shape[1]),
            "in_ch": int(sd["pre.0.conv.weight"].shape[1])}


def pose_net_from_reference(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference ``PoseNet`` state dict -> the port's: the names are
    the reference's, but the reference builds every Residual's
    ``skip_layer`` and runs it only where the channels change; the port
    keeps it only there (the rule of the JAX package's
    ``convert_pose_net``: in = ``bn1``'s channels, out = ``conv3``'s)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if ".skip_layer." in k:
            res = k[:k.index(".skip_layer.")]
            if (sd[f"{res}.bn1.weight"].shape[0]
                    == sd[f"{res}.conv3.conv.weight"].shape[0]):
                continue
        out[k] = torch.as_tensor(np.asarray(v)).clone()
    return out


def random_pose_net_state_dict(rng: np.random.RandomState, nstack: int = 1,
                               joint_num: int = 21, inp_dim: int = 256,
                               in_ch: int = 1) -> Dict[str, np.ndarray]:
    """A seeded reference-layout ``PoseNet`` state dict (the JAX
    package's channel plan: pre.3 to 256, pre.4 to ``inp_dim``) drawn
    from numpy: He-scaled convs with small biases, 1e-3-scaled output
    heads, random BatchNorm affine parameters and running statistics, and
    a ``skip_layer`` in every Residual, as the reference builds them."""
    sd: Dict[str, np.ndarray] = {}

    def conv(name, out_c, in_c, k, std=None):
        std = np.sqrt(2.0 / (k * k * in_c)) if std is None else std
        sd[f"{name}.weight"] = (rng.randn(out_c, in_c, k, k) * std
                                ).astype(np.float32)
        sd[f"{name}.bias"] = (rng.randn(out_c) * 0.01).astype(np.float32)

    def bn(name, c):
        sd[f"{name}.weight"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        sd[f"{name}.bias"] = (rng.randn(c) * 0.05).astype(np.float32)
        sd[f"{name}.running_mean"] = (rng.randn(c) * 0.05).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.8, 1.5, c).astype(np.float32)
        sd[f"{name}.num_batches_tracked"] = np.asarray(100, np.int64)

    def residual(name, i, o):
        h = o // 2
        bn(f"{name}.bn1", i)
        conv(f"{name}.conv1.conv", h, i, 1)
        bn(f"{name}.bn2", h)
        conv(f"{name}.conv2.conv", h, h, 3)
        bn(f"{name}.bn3", h)
        # the last conv of a residual branch at half scale
        conv(f"{name}.conv3.conv", o, h, 1, std=np.sqrt(0.5 / h))
        conv(f"{name}.skip_layer.conv", o, i, 1)

    def hourglass(name, n, f):
        for part in ("up1", "low1", "low3"):
            residual(f"{name}.{part}", f, f)
        if n > 1:
            hourglass(f"{name}.low2", n - 1, f)
        else:
            residual(f"{name}.low2", f, f)

    conv("pre.0.conv", 64, in_ch, 7)
    bn("pre.0.bn", 64)
    residual("pre.1", 64, 128)
    residual("pre.3", 128, 256)
    residual("pre.4", 256, inp_dim)
    for i in range(nstack):
        hourglass(f"hgs.{i}", 4, inp_dim)
        residual(f"features.{i}.0", inp_dim, inp_dim)
        conv(f"features.{i}.1.conv", inp_dim, inp_dim, 1)
        bn(f"features.{i}.1.bn", inp_dim)
        for j, c in ((1, 3 * joint_num), (2, joint_num), (3, joint_num)):
            conv(f"outs_{j}.{i}", c, inp_dim, 1, std=1e-3)
        if i < nstack - 1:
            conv(f"merge_preds.{i}.conv.conv", inp_dim, 5 * joint_num, 1)
            conv(f"merge_features.{i}.conv.conv", inp_dim, inp_dim, 1,
                 std=np.sqrt(0.5 / inp_dim))
    return sd
