"""Rules of the PyTorch port that no parity test covers: dsf_tpu_torch
imports nothing of JAX, Flax or dsf_tpu; its entry points run on CUDA
unless told otherwise and raise, never fall back, when CUDA is missing;
and its kernel wrappers refuse what the kernels do not take."""

import ast
import os

import numpy as np
import pytest
import torch

import dsf_tpu_torch
from dsf_tpu_torch import kernels
from dsf_tpu_torch.config import Config
from dsf_tpu_torch.device import resolve_device
from dsf_tpu_torch.mano.model import load_model
from dsf_tpu_torch.ops import (codec_kernel, moments_kernel, point_mesh,
                               point_mesh_kernel, raster_kernel,
                               tapsum_kernel)
from dsf_tpu_torch.serving import InferenceEngine
from dsf_tpu_torch.tools.prerender import prerender_dataset
from dsf_tpu_torch.training.trainer import Trainer

torch.set_num_threads(2)

PKG = os.path.dirname(dsf_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dsf_tpu", "cv2",
             "PIL", "tensorboardX", "matplotlib")


def _py_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_flax_or_dsf_tpu_imports():
    files = list(_py_files())
    assert len(files) > 10
    assert any(os.path.relpath(p, PKG).startswith("tools") for p in files)
    bad = [(os.path.relpath(p, PKG), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_modules_and_readers_run_without_pil_cv2_or_jax(tmp_path):
    """In a process where importing PIL, cv2, jax, flax or dsf_tpu fails
    (the card's machine has none of them), every dsf_tpu_torch module
    imports and the depth readers read a 16-bit PNG and an MSRA frame."""
    import subprocess
    import sys
    code = f"""
import importlib, pkgutil, sys
import numpy as np
BLOCK = {FORBIDDEN!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import dsf_tpu_torch
for m in pkgutil.walk_packages(dsf_tpu_torch.__path__, "dsf_tpu_torch."):
    if not m.name.endswith("__main__"):
        importlib.import_module(m.name)
from dsf_tpu_torch.data import readers
from dsf_tpu_torch.tools.prerender import write_png16
img = np.arange(12, dtype=np.uint16).reshape(3, 4) * 999
write_png16({str(tmp_path / "d.png")!r}, img)
assert (readers.icvl_reader({str(tmp_path / "d.png")!r}) == img).all()
readers.write_msra_bin({str(tmp_path / "f.bin")!r}, img.astype(np.float32))
assert (readers.msra_reader({str(tmp_path / "f.bin")!r},
                            (241.42, 241.42, 160.0, 120.0))[0] == img).all()
assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(PKG), timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tests/torch_fake_sets.py",
                                    "scripts/datasets_cli_gpu.py",
                                    "scripts/selfsup_gpu.py",
                                    "scripts/raster_shapes_gpu.py",
                                    "scripts/argmin_shapes_gpu.py",
                                    "scripts/tail_shapes_gpu.py",
                                    "scripts/codec_shapes_gpu.py",
                                    "scripts/moments_shapes_gpu.py"])
def test_chip_smoke_imports_no_jax(script):
    path = os.path.join(os.path.dirname(PKG), script)
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def _reexports(path):
    """The names a package __init__ imports from its modules (its AST)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return {a.asname or a.name for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) for a in node.names}


# re-exports of the JAX package that place arrays on a jax.sharding mesh;
# the port's ranks take their rows with parallel.mesh.Mesh.stripe
NO_COUNTERPART = {"parallel": {"shard_batch", "replicate"}}


def test_packages_reexport_the_jax_packages_names():
    """Every name a dsf_tpu package __init__ re-exports is re-exported by
    the port's package of the same name, read from both files' text, so
    that neither package is imported here."""
    jax_pkg = os.path.join(os.path.dirname(PKG), "dsf_tpu")
    checked = 0
    for name in sorted(os.listdir(jax_pkg)):
        init = os.path.join(jax_pkg, name, "__init__.py")
        if not os.path.isfile(init):
            continue
        want = _reexports(init) - NO_COUNTERPART.get(name, set())
        have = _reexports(os.path.join(PKG, name, "__init__.py"))
        assert want <= have, (name, sorted(want - have))
        checked += len(want)
    assert checked >= 25


def test_default_device_is_cuda_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    # the engine checks the device before it touches weights or assets
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceEngine(Config(mano_model_path=str(tmp_path / "none.npz")), {})
    # so do the MANO loader and the trainer, the other public constructors
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(str(tmp_path / "none.npz"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(Config(), str(tmp_path / "none.npz"))
    # and the pre-render tool, before it writes anything
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prerender_dataset(str(tmp_path / "none.npz"),
                          np.zeros((1, 62), np.float32), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_custom_ops_have_a_cpu_and_a_cuda_implementation_only():
    """Every op of the namespace ``dsf`` (``kernels/custom_ops``) has
    exactly two implementations, CPU (the plain version) and CUDA (the
    kernel), and no default one that would take a CUDA tensor to the plain
    version; its fake implementation serves export and compile."""
    from dsf_tpu_torch.kernels import custom_ops
    names = sorted(n for n in torch._C._dispatch_get_all_op_names()
                   if n.startswith("dsf::"))
    assert names == sorted(f"dsf::{op}" for op in custom_ops.OPS)
    for name in names:
        has = {k: torch._C._dispatch_has_kernel_for_dispatch_key(name, k)
               for k in ("CPU", "CUDA", "Meta", "CompositeExplicitAutograd",
                         "CompositeImplicitAutograd",
                         "CompositeExplicitAutogradNonFunctional")}
        assert has == {"CPU": True, "CUDA": True, "Meta": True,
                       "CompositeExplicitAutograd": False,
                       "CompositeImplicitAutograd": False,
                       "CompositeExplicitAutogradNonFunctional": False}, \
            (name, has)
        # the dispatcher's own table: CPU, CUDA, the fake (Meta) and the
        # generated autograd entry, nothing else
        kernels = {line.split(":")[0] for line in
                   torch._C._dispatch_dump(name).splitlines()
                   if "registered at" in line} - {"debug"}
        assert kernels == {"CPU", "CUDA", "Meta", "Autograd[alias]"}, kernels


def test_tool_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """The MANO fits and ``load_exported`` run on the card by default and
    raise without one, before they read anything."""
    from dsf_tpu_torch.exported import load_exported
    from dsf_tpu_torch.tools.fit_mano import fit_params, fit_params_world
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros((1, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_params(None, np.zeros((1, 1, 8, 8), np.float32), z, z)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fit_params_world(None, z[None], z[None], z, np.zeros((1, 45)), z)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported(str(tmp_path / "none.pt2"))


def test_loop_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """The trainer's loop (on every dataset), its command line and the
    fake NYU set run on the card by default and raise without one before
    they write anything, the ccssl subcommand (``pipelines.run_ccssl``)
    too; an unknown dataset raises ValueError, and so does run_ccssl in
    a world of more than one process, before it touches anything."""
    from dsf_tpu_torch.data.fake import make_fake_nyu
    from dsf_tpu_torch.training import __main__ as cli
    from dsf_tpu_torch.training import pipelines
    from dsf_tpu_torch.training.loop import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(save_dir=str(tmp_path / "ckpt"), root_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--save_dir", str(tmp_path / "ckpt"), "--root_dir",
                  str(tmp_path), "--batch_size", "4"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_fake_nyu(str(tmp_path / "fake"), str(tmp_path / "none.npz"))
    for dataset in ("icvl", "msra", "shrec"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(cfg.replace(dataset=dataset))
    assert sorted(os.listdir(tmp_path)) == []
    with pytest.raises(ValueError, match="dataset 'hands'"):
        run(cfg.replace(dataset="hands"), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["ccssl", "--save_dir", str(tmp_path / "ckpt"),
                  "--root_dir", str(tmp_path), "--batch_size", "4"])
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="one process"):
        pipelines.run_ccssl(cfg, device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    assert sorted(os.listdir(tmp_path)) == []
    parsed = cli.parse_config(["--batch_size", "4", "--augment_para",
                               "5,0.1,90", "--test_during_train", "false",
                               "--opt", "sgd"])
    assert parsed == Config(batch_size=4, augment_para=(5.0, 0.1, 90.0),
                            test_during_train=False, opt="sgd")


def test_cyclegan_entry_points_raise_without_cuda(tmp_path, monkeypatch):
    """The CycleGAN trainer, ``run_cyclegan``, the ``cyclegan`` subcommand
    and the efficacy script run on the card by default and raise without
    one before they write anything."""
    import importlib.util
    from dsf_tpu_torch.training import __main__ as cli
    from dsf_tpu_torch.training.cyclegan_trainer import CycleGANTrainer
    from dsf_tpu_torch.training.pipelines import run_cyclegan
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(save_dir=str(tmp_path / "ckpt"), root_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CycleGANTrainer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_cyclegan(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["cyclegan", "--save_dir", str(tmp_path / "ckpt"),
                  "--root_dir", str(tmp_path)])
    spec = importlib.util.spec_from_file_location(
        "selfsup_gpu", os.path.join(os.path.dirname(PKG), "scripts",
                                    "selfsup_gpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.run(out_path=str(tmp_path / "out.json"),
                data_root=str(tmp_path / "data"))
    assert sorted(os.listdir(tmp_path)) == []


@pytest.mark.parametrize("case", ["n_fsdp", "num_devices", "batch"])
def test_parallel_layout_checks_raise_before_touching_anything(
        tmp_path, monkeypatch, case):
    """The multi-GPU layout is checked before any device or file is
    touched, with CUDA missing (so any touch would raise otherwise):
    ``n_fsdp`` must divide the world (``loop.run`` and ``Trainer``; a
    world of 1 here), the engine's ``num_devices`` must not exceed the
    devices given or visible, and the global batch must divide over the
    world (``loop.run`` under ``torchrun``'s ``WORLD_SIZE=2``, and a
    trainer on a two-rank mesh).  Each raises ValueError; 1 passes."""
    from dsf_tpu_torch.config import check_devices, check_world
    from dsf_tpu_torch.parallel.mesh import Mesh
    from dsf_tpu_torch.training.loop import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(save_dir=str(tmp_path / "ckpt"), root_dir=str(tmp_path),
                 mano_model_path=str(tmp_path / "none.npz"))
    if case == "n_fsdp":
        bad = cfg.replace(n_fsdp=2)
        makes = (lambda: run(bad), lambda: Trainer(bad, bad.mano_model_path),
                 lambda: Trainer(bad.replace(n_fsdp=3), bad.mano_model_path,
                                 mesh=Mesh(world=2)))
        match = "n_fsdp=[23] does not divide"
        check_world(cfg.replace(n_fsdp=2), 2)
    elif case == "num_devices":
        bad = cfg.replace(num_devices=3)
        makes = (lambda: InferenceEngine(bad, {}, buckets=(3,)),
                 lambda: InferenceEngine(bad, {}, buckets=(3,),
                                         devices=("cuda:0", "cuda:1")))
        match = "num_devices=3"
        check_devices(bad, 3)
    else:
        bad = cfg.replace(batch_size=3)
        monkeypatch.setenv("WORLD_SIZE", "2")
        makes = (lambda: run(bad),
                 lambda: Trainer(bad, bad.mano_model_path, mesh=Mesh(world=2)))
        match = "batch of 3 does not divide over 2"
        check_world(cfg.replace(batch_size=4), 2)
    for make in makes:
        with pytest.raises(ValueError, match=match):
            make()
    assert sorted(os.listdir(tmp_path)) == []


def test_host_library_build_flags():
    """The loader's host library: the host compiler, no -march=native, no
    fused multiply-add contraction (it reproduces numpy's and OpenCV's
    roundings), and not among the CUDA sources."""
    from dsf_tpu_torch.kernels import build
    assert "-ffp-contract=off" in build.HOST_FLAGS
    assert not any("march" in f or "fast-math" in f for f in build.HOST_FLAGS)
    assert build.HOST_SOURCE not in build.SOURCES
    assert os.path.exists(os.path.join(build.CSRC, build.HOST_SOURCE + ".cpp"))


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper launches on a CUDA tensor or raises; it never computes."""
    with pytest.raises(ValueError, match="CUDA"):
        raster_kernel.raster_skip_cuda(torch.zeros(1, 8, 3),
                                       torch.zeros(4, 3, dtype=torch.int32),
                                       torch.zeros(1, 256, 2), (16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        raster_kernel.face_setup_cuda(torch.zeros(1, 8, 3),
                                      torch.zeros(4, 3, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        raster_kernel.raster_skip_launch(torch.zeros(1, 4, 16),
                                         torch.zeros(1, 4, 4),
                                         torch.zeros(1, 1, 4),
                                         torch.zeros(1, 256, 2), (16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        codec_kernel.encode_cuda(torch.zeros(1, 21, 3),
                                 torch.zeros(1, 1, 8, 8), 0.8)
    with pytest.raises(ValueError, match="CUDA"):
        codec_kernel.decode_cuda(torch.zeros(1, 84, 8, 8),
                                 torch.zeros(1, 1, 8, 8), 0.8, 30.0)
    with pytest.raises(ValueError, match="CUDA"):
        codec_kernel.encode_bwd_cuda(torch.zeros(1, 21, 3),
                                     torch.zeros(1, 1, 8, 8),
                                     torch.zeros(1, 84, 8, 8), 0.8)
    with pytest.raises(ValueError, match="CUDA"):
        codec_kernel.decode_bwd_cuda(torch.zeros(1, 84, 8, 8),
                                     torch.zeros(1, 1, 8, 8),
                                     torch.zeros(1, 21, 3),
                                     torch.zeros(1, 21, 3),
                                     torch.zeros(1, 21, 2), 0.8, 30.0)
    with pytest.raises(ValueError, match="CUDA"):
        moments_kernel.face_moments_cuda(torch.zeros(1, 16, dtype=torch.int32),
                                         torch.zeros(1, 16, 3), 8)
    with pytest.raises(ValueError, match="CUDA"):
        point_mesh_kernel.argmin_faces_cuda(torch.zeros(1, 16, 3),
                                            torch.zeros(1, 4, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        point_mesh_kernel.argmin_faces_launch(
            torch.zeros(1, 16, 3),
            point_mesh.argmin_tables_plain(torch.zeros(1, 16, 3),
                                           torch.rand(1, 4, 3, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        point_mesh_kernel.argmin_setup_cuda(torch.zeros(1, 16, 3),
                                            torch.zeros(1, 4, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        point_mesh_kernel.argmin_faces_culled_launch(
            torch.zeros(1, 16, 3),
            point_mesh.argmin_tables_plain(torch.zeros(1, 16, 3),
                                           torch.rand(1, 4, 3, 3),
                                           culled=True))
    with pytest.raises(ValueError, match="CUDA"):
        tapsum_kernel.tail_conv_cuda(torch.zeros(1, 8, 14, 14),
                                     torch.zeros(1, 8, 7, 7), torch.zeros(1))
    with pytest.raises(ValueError, match="CUDA"):
        tapsum_kernel.tail_conv_cuda(
            *(torch.zeros(s, dtype=torch.bfloat16)
              for s in ((1, 8, 14, 14), (1, 8, 7, 7), (1,))))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tapsum_kernel.tail_conv_cuda(
            *(torch.zeros(s, dtype=torch.float16)
              for s in ((1, 8, 14, 14), (1, 8, 7, 7), (1,))))
    with pytest.raises(ValueError, match="CUDA"):
        point_mesh_kernel.argmin_faces_v2_cuda(torch.zeros(1, 16, 3),
                                               torch.zeros(1, 4, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        point_mesh_kernel.v2_setup_cuda(torch.zeros(1, 16, 3),
                                        torch.zeros(1, 4, 3, 3))
    with pytest.raises(ValueError, match="CUDA"):
        point_mesh_kernel.argmin_faces_v2_launch(
            torch.zeros(1, 16, 3),
            point_mesh.v2_tables_plain(torch.zeros(1, 16, 3),
                                       torch.rand(1, 4, 3, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        point_mesh_kernel.argmin_faces_culled_cuda(
            torch.zeros(1, 16, 3), torch.zeros(1, 4, 3, 3),
            torch.ones(4, 2, dtype=torch.bool),
            torch.zeros(1, 16, dtype=torch.int64))
    with pytest.raises(ValueError, match="CUDA"):
        raster_kernel.raster_dense_cuda(torch.zeros(1, 8, 3),
                                        torch.zeros(4, 3, dtype=torch.int32),
                                        torch.zeros(1, 256, 2))
    with pytest.raises(ValueError, match="CUDA"):
        raster_kernel.raster_dense_launch(torch.zeros(1, 4, 16),
                                          torch.zeros(1, 4, 4),
                                          torch.zeros(1, 1, 4),
                                          torch.zeros(1, 256, 2))
    with pytest.raises(ValueError, match="CUDA"):
        raster_kernel.raster_binned_cuda(torch.zeros(1, 8, 3),
                                         torch.zeros(4, 3, dtype=torch.int64),
                                         torch.zeros(1, 256, 2), (16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        raster_kernel.binned_setup_cuda(torch.zeros(1, 8, 3),
                                        torch.zeros(4, 3, dtype=torch.int32),
                                        torch.zeros(1, 256, 2), (16, 16))
    with pytest.raises(ValueError, match="CUDA"):
        raster_kernel.raster_binned_launch(
            torch.zeros(1, 4, 16), torch.zeros(1, 4, 4), torch.zeros(1, 1, 4),
            torch.zeros(1, 4, 4), torch.zeros(1, 1, 4), torch.zeros(1, 256, 2),
            torch.zeros(1, dtype=torch.int32), (16, 16))
    assert kernels.LAUNCHES == {name: 0 for name in (
        "raster_skip", "raster_moments", "codec_encode", "codec_encode_bwd",
        "codec_decode", "codec_decode_bwd", "point_mesh_argmin", "tail_conv",
        "tail_conv_bf16", "icp_argmin_v2", "icp_argmin_culled",
        "raster_dense", "raster_binned")}


def test_kernel_sources_and_build_flags():
    """One nvcc per source for sm_90a, no fast-math, and each source names
    the TPU kernel it replaces."""
    from dsf_tpu_torch.kernels import build
    assert "-gencode=arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert not any("fast_math" in f for f in build.NVCC_FLAGS)
    for name, tpus in (("raster_skip", ("raster_pallas_skip",)),
                       ("moments", ("face_moments_pallas",)),
                       ("codec", ("_encode_fwd_call", "_decode_fwd_call",
                                  "_encode_bwd", "_decode_bwd")),
                       ("point_mesh", ("argmin_faces_pallas",)),
                       ("tail_conv", ("pallas_tapsum.py:tail_conv_tanh",
                                      "_fast_tail")),
                       ("point_mesh_v2", ("argmin_faces_pallas_v2",
                                          "_kernel_v2")),
                       ("point_mesh_culled", ("argmin_faces_pallas_culled",
                                              "_kernel_culled")),
                       ("raster_dense", ("pallas_raster.py:raster_pallas",
                                         "_kernel_impl")),
                       ("raster_binned", ("raster_pallas_tiles",
                                          "_raster_binned"))):
        with open(os.path.join(build.CSRC, name + ".cu")) as f:
            src = f.read()
        assert all(t in src for t in tpus) and "Replaces:" in src
    assert np.array_equal(sorted(build.SOURCES),
                          ["codec", "moments", "point_mesh",
                           "point_mesh_culled", "point_mesh_v2",
                           "raster_binned", "raster_dense", "raster_skip",
                           "tail_conv"])
    # the shared headers, which every library's hashed name covers
    assert sorted(f for f in os.listdir(build.CSRC) if f.endswith(".cuh")) \
        == ["argmin_body.cuh", "argmin_setup.cuh", "point_tri27.cuh",
            "raster_rows.cuh", "raster_setup.cuh"]


@pytest.mark.parametrize("header, sources, copied", [
    # the raster kernels' per-face test and row staging
    ("raster_rows.cuh", ("raster_skip", "raster_dense", "raster_binned"),
     ("__fmul_rn(", "__fadd_rn(", "r[12] ==")),
    # the face set-up of K1, K6 and K10 (rasterize.face_rows and
    # cover_boxes on the card) and their per-face cull
    ("raster_setup.cuh", ("raster_skip", "raster_dense", "raster_binned"),
     ("__frcp_rn(", "__fsub_rn(", "fabsf(A) > 1e-9f", "__ddiv_rn(")),
    ("raster_rows.cuh", ("raster_skip", "raster_dense", "raster_binned"),
     ("__ballot_sync(", "listed(", "s.list[")),
    # the ICP kernels' divide-free distance (K3 through its body)
    ("point_tri27.cuh", ("argmin_body.cuh", "point_mesh_v2"),
     ("c[26]", "dpn * dpn", "c[23]")),
    # the set-up of K3, K8 and K7 (their rows, lists, sorts, cull and skip
    # words) and their argmin bodies
    ("argmin_setup.cuh", ("point_mesh", "point_mesh_culled",
                          "point_mesh_v2"),
     ("__frcp_rn(", "__match_any_sync(", "kCullMargin", "__reduce_or_sync(")),
    ("argmin_body.cuh", ("point_mesh", "point_mesh_culled", "point_mesh_v2"),
     ("cp.async", "__frcp_rn(", "s_list[", "__reduce_or_sync(")),
])
def test_kernels_share_their_arithmetic(header, sources, copied):
    """Kernels that compute one function include its arithmetic from one
    header and keep no copy of it, so their bitwise (rasters) and
    winning-distance (ICP) agreement cannot drift apart."""
    from dsf_tpu_torch.kernels import build
    with open(os.path.join(build.CSRC, header)) as f:
        shared = f.read()
    assert all(c in shared for c in copied)
    for name in sources:
        fn = name if name.endswith(".cuh") else name + ".cu"
        with open(os.path.join(build.CSRC, fn)) as f:
            src = f.read()
        assert f'#include "{header}"' in src
        assert not any(c in src for c in copied), name


def test_library_name_follows_the_shared_headers(tmp_path, monkeypatch):
    """A library's hashed name changes with its source and with any shared
    header, so a kernel built before a header changed is never loaded."""
    import shutil
    from dsf_tpu_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    before = build._lib_path("raster_dense")
    assert build._lib_path("raster_dense") == before
    with open(csrc / "raster_rows.cuh", "a") as f:
        f.write("\n")
    after = build._lib_path("raster_dense")
    assert after != before
    with open(csrc / "raster_dense.cu", "a") as f:
        f.write("\n")
    assert build._lib_path("raster_dense") not in (before, after)
