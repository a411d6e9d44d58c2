"""The dataset loaders: NYU, ICVL, MSRA, SHREC and DHG (counterpart of
dsf_tpu/data/datasets.py's ``BaseDataset``, ``NYUDataset``,
``ICVLDataset``, ``MSRADataset``, ``SHRECDataset``,
``read_dhg_sequences`` and ``DHGDataset``; ref: render_loader.py
:1803-3185), and NYU's variants ``NYUCCSSLDataset`` (pseudo labels),
``NYUSTDataset`` with ``ModelParaOnlyDataset``, ``ConcatDataset`` and
``NYUTestAugDataset``, whose batches are NYU's batched path.

Batches are (img, xyz_gt, uvd_gt, center, M, cube) dicts of numpy arrays
(DHG's also carry ``gesture`` and ``label28``), made by batched paths:
the depth decode fans out over a worker pool (``readers``), the crop,
warps and normalization run in the threaded host library (``native``,
``aug_batch``), the label math is vectorized numpy.  An item is a batch
of one: there is no second, per-item path.  Augmented batches draw their
(mode, off, rot, sc) from the dataset's one ``RandomState``.

NYU, ICVL and MSRA batches are the JAX package's batched fast paths
(``_eval_fast_batch``, ``_aug_fast_batch``), bitwise.  SHREC and DHG,
which the JAX package serves item by item, go through
``aug_batch.unaugmented_batch`` (and DHG's ``augment=True`` through
``aug_batch.augment_fast_batch``), whose items are the JAX package's
``__getitem__`` items bitwise (DHG's augmented ones given the same draws).
MSRA's cubes differ by subject, so its batches carry one cube a frame.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from dsf_tpu_torch.data import aug_batch
from dsf_tpu_torch.data import crop as C
from dsf_tpu_torch.data import native, readers
from dsf_tpu_torch.mano.constants import (NYU2MANO, NYU_CALCULATE,
                                          NYU_JOINT_SELECT)

ICVL_JOINTS, MSRA_JOINTS = 16, 21


class BaseDataset:
    """Batching, prefetching and the depth cache over a subclass's
    ``_read_depth(index)`` and ``_fetch_batch(idx, stripe)``."""
    paras: tuple
    ori_img_size: tuple
    flip: float = 1.0
    # decode and crop workers (threads: zlib and the host library release
    # the interpreter lock), capped at the host's cores
    NUM_WORKERS = max(1, min(8, os.cpu_count() or 1))

    def __len__(self):
        raise NotImplementedError

    def _fetch_batch(self, idx, stripe=(0, 1)) -> dict:
        """The frames ``idx`` as a batch; ``stripe`` (rank, world) says
        which rows of the global batch's augmentation draws they take."""
        raise NotImplementedError

    def __getitem__(self, i) -> dict:
        """One sample: the batch of one, without its batch axis."""
        return {k: v[0] for k, v in self._fetch_batch(np.asarray([i])).items()}

    def _worker_pool(self) -> ThreadPoolExecutor:
        pool = getattr(self, "_pool", None)
        if pool is None:
            pool = self._pool = ThreadPoolExecutor(max_workers=self.NUM_WORKERS)
        return pool

    def close(self) -> None:
        """Stop the worker pool (a later fetch starts a new one)."""
        pool = getattr(self, "_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
            self._pool = None

    # ------------------------------------------------------------ caching

    def enable_depth_cache(self, max_bytes=None) -> None:
        """Keep decoded full-frame depths in RAM (uint16 where that is
        lossless, else float32), up to ``max_bytes``; later entries fall
        through to the decode."""
        self._depth_cache = {}
        self._depth_cache_bytes = 0
        self._depth_cache_max = max_bytes
        self._depth_cache_lock = threading.Lock()

    def _read_depth_cached(self, index) -> np.ndarray:
        cache = getattr(self, "_depth_cache", None)
        if cache is None:
            return self._read_depth(index)
        hit = cache.get(index)
        if hit is not None:
            return hit.astype(np.float32)
        d = self._read_depth(index)
        u16 = d.astype(np.uint16)
        store = u16 if np.array_equal(u16, d) else d
        with self._depth_cache_lock:
            if (self._depth_cache_max is None
                    or self._depth_cache_bytes < self._depth_cache_max):
                cache[index] = store
                self._depth_cache_bytes += store.nbytes
        return d

    # ------------------------------------------------------------ batching

    def _aug_draws(self, n, stripe):
        """The augmentation draws of ``n`` rows from the dataset's
        RandomState: rank r of ``stripe`` (r, world) draws the global
        batch's ``n * world`` and keeps its rows."""
        rank, world = stripe
        draws = aug_batch.draw_params(self.rng, n * world, self.aug_para)
        return draws[rank * n:(rank + 1) * n]

    def _aug_fast_batch(self, idx, depths, joints_xyz, centers, cubes,
                        stripe=(0, 1)):
        """The augmented batch (``aug_batch.augment_fast_batch``) with
        ``_aug_draws``."""
        return aug_batch.augment_fast_batch(
            depths, joints_xyz[idx], centers, cubes.astype(np.float64),
            self.paras, self.flip, self.img_size,
            self._aug_draws(len(idx), stripe), nthreads=self.NUM_WORKERS)

    def _eval_fast_batch(self, idx, depths, joints_xyz, centers, cubes):
        """The unaugmented batch: crop and normalize in the host library,
        the com / M / cube label chain vectorized."""
        coms = C.joint_3d_to_img(centers, self.paras, self.flip)
        imgs, Ms = native.batch_crop_normalize(
            depths, coms.astype(np.float32), cubes.astype(np.float32),
            np.asarray(self.paras, np.float32), self.img_size,
            nthreads=self.NUM_WORKERS)
        gt3Dcrop = joints_xyz[idx] - centers[:, None]
        curLabel = gt3Dcrop / (cubes[:, None, 2:3] / 2.0)
        com3D = C.joint_img_to_3d(coms, self.paras, self.flip)
        world = curLabel * (cubes[:, None, 0:1] / 2.0) + com3D[:, None]
        uvd = C.joint_3d_to_img(world, self.paras, self.flip)
        ones = np.ones(uvd.shape[:-1] + (1,), uvd.dtype)
        h = np.concatenate([uvd[..., :2], ones], axis=-1) @ \
            Ms.transpose(0, 2, 1)
        joint_img = uvd.copy()
        joint_img[..., :2] = (h[..., :2] / h[..., 2:3]) \
            / (self.img_size / 2) - 1
        joint_img[..., 2] = (uvd[..., 2] - com3D[:, None, 2]) \
            / (cubes[:, None, 0] / 2.0)
        return {
            "img": imgs[:, None].astype(np.float32),
            "xyz_gt": curLabel.astype(np.float32),
            "uvd_gt": joint_img.astype(np.float32),
            "center": com3D.astype(np.float32),
            "M": Ms.astype(np.float32),
            "cube": cubes.astype(np.float32),
        }

    def _depths(self, idx) -> np.ndarray:
        """The frames ``idx``' full-frame depths, decoded on the pool."""
        return np.stack(list(self._worker_pool().map(self._read_depth_cached,
                                                     idx)))

    def _fast_batch(self, idx, joints_xyz, centers, cubes,
                    stripe=(0, 1)) -> dict:
        """The frames ``idx`` as the augmented batch when ``self.augment``,
        else the eval batch."""
        if self.augment:
            return self._aug_fast_batch(idx, self._depths(idx), joints_xyz,
                                        centers, cubes, stripe)
        return self._eval_fast_batch(idx, self._depths(idx), joints_xyz,
                                     centers, cubes)

    def batches(self, batch_size: int, shuffle=False, seed=0,
                drop_last=True, loop=False, rank=0, world=1
                ) -> Iterator[dict]:
        """Batches in order (or a permutation from ``seed`` per pass);
        ``drop_last=False`` keeps a short tail; ``loop`` repeats.

        With ``world`` > 1 each global batch of ``batch_size`` yields only
        rank ``rank``'s stripe (rows [r*b, (r+1)*b), b = batch_size /
        world), and only those frames are read: every rank permutes alike
        and the stripes' union is the global batch, augmentation draws
        included.  A short tail is padded to ``batch_size`` by repeating
        its last frame first (the loop's eval masks the padding)."""
        if batch_size % world:
            raise ValueError(f"the global batch of {batch_size} does not "
                             f"divide over {world} ranks")
        b = batch_size // world
        rng = np.random.RandomState(seed)
        n = len(self)
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            end = n - batch_size + 1 if drop_last else n
            for s in range(0, end, batch_size):
                idx = order[s:s + batch_size]
                if world > 1:
                    idx = np.concatenate([idx, np.repeat(
                        idx[-1:], batch_size - len(idx))])[rank * b:
                                                           (rank + 1) * b]
                yield self._fetch_batch(idx, (rank, world))
            if not loop:
                return

    def prefetch_batches(self, batch_size: int, prefetch=4, transform=None,
                         **kw) -> Iterator:
        """``batches`` on a background thread, ``prefetch`` ahead.
        ``transform`` (e.g. a copy to the device) runs on that thread.  A
        worker's exception is raised to the consumer; closing the
        generator stops the worker."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        done, stop = object(), threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for b in self.batches(batch_size, **kw):
                    if not put(transform(b) if transform is not None else b):
                        return
                put(done)
            except BaseException as e:  # noqa: BLE001 - raised to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is done:
                    return
                if isinstance(b, BaseException):
                    raise b
                yield b
        finally:
            stop.set()


class NYUDataset(BaseDataset):
    """NYU hand dataset.

    Needs {root}/[train|test]/depth_{view+1}_XXXXXXX.png, joint_data.mat and
    (with ``center_type="refine"``) center_{phase}_{view}_refined.txt.
    """

    def __init__(self, root_dir, phase, view=0, img_size=128,
                 cube_size=(250, 250, 250), center_type="refine",
                 aug_para=(10, 0.2, 180), joint_num=14, seed=0):
        import scipy.io as sio
        self.paras = (588.03, 587.07, 320.0, 240.0)
        self.ori_img_size = (640, 480)
        self.flip = 1.0
        self.phase = phase
        self.view = view
        self.img_size = img_size
        self.cube_size = np.asarray(cube_size, np.float32)
        self.aug_para = aug_para
        self.joint_num = joint_num
        self.rng = np.random.RandomState(seed)
        self.augment = phase == "train"

        data_path = os.path.join(root_dir, phase)
        self.data_path = data_path
        labels = sio.loadmat(os.path.join(data_path, "joint_data.mat"))
        uvd = labels["joint_uvd"][view][:, NYU_JOINT_SELECT][:, NYU_CALCULATE]
        xyz = labels["joint_xyz"][view][:, NYU_JOINT_SELECT][:, NYU_CALCULATE]
        # y-negation roundtrip the reference applies (render_loader.py:1830)
        self.all_joints_uvd = uvd.astype(np.float32)
        self.all_joints_xyz = C.joint_img_to_3d(
            C.joint_3d_to_img(xyz, self.paras, flip=-1), self.paras,
            flip=1).astype(np.float32)
        xyz_mano = labels["joint_xyz"][view][:, NYU_JOINT_SELECT][:, NYU2MANO]
        self.all_joints_xyz_mano = C.joint_img_to_3d(
            C.joint_3d_to_img(xyz_mano, self.paras, flip=-1), self.paras,
            flip=1).astype(np.float32)

        center_path = os.path.join(
            data_path, f"center_{phase}_{view}_refined.txt")
        if center_type == "refine" and os.path.exists(center_path):
            self.center_xyz = np.loadtxt(center_path).astype(np.float32)
        else:
            self.center_xyz = self.all_joints_xyz.mean(1)

        n = len(self.all_joints_uvd)
        self.test_cubesize = np.ones((n, 3), np.float32) * self.cube_size
        if phase == "test":
            # test cubes shrink x5/6 after frame 2440 (ref :1852-1853)
            self.test_cubesize[2440:] *= 5.0 / 6.0

    def __len__(self):
        return len(self.all_joints_uvd)

    def _read_depth(self, index) -> np.ndarray:
        return readers.nyu_reader(os.path.join(
            self.data_path, f"depth_{self.view + 1}_{index + 1:07d}.png"))

    def _fetch_batch(self, idx, stripe=(0, 1)) -> dict:
        idx = np.asarray(idx)
        cubes = (self.test_cubesize[idx] if self.phase == "test"
                 else np.tile(self.cube_size, (len(idx), 1))).astype(
                     np.float32)
        return self._fast_batch(idx, self.all_joints_xyz,
                                self.center_xyz[idx], cubes, stripe)


class NYUCCSSLDataset(NYUDataset):
    """NYU with CCSSL pseudo labels and per-joint confidence weights
    (ref: nyu_CCSSL_loader, render_loader.py:1700-1800):
    ``{pseudo_dir}/joint_uvd.txt`` holds one frame a row, its joints'
    image-frame uvd (pixels of the 640x480 frame and mm, as NYUDataset's
    ``joint_uvd``; ``ccssl_trainer.generate_pseudo_labels`` writes it so),
    which take the place of the ground truth; ``weight.txt`` a row of
    weights a frame (all 1 when absent), each batch's ``weight``.  Any
    joint count passes (the net's 21).  Batches are NYUDataset's: the
    labels go through the same crop and augmentation."""

    def __init__(self, root_dir, phase, pseudo_dir, **kw):
        super().__init__(root_dir, phase, **kw)
        uvd = np.loadtxt(os.path.join(pseudo_dir, "joint_uvd.txt"), ndmin=2)
        self.pseudo_uvd = uvd.reshape(len(uvd), -1, 3).astype(np.float32)
        wpath = os.path.join(pseudo_dir, "weight.txt")
        if os.path.exists(wpath):
            self.weights = np.loadtxt(wpath, ndmin=2).astype(np.float32)
        else:
            self.weights = np.ones(self.pseudo_uvd.shape[:2], np.float32)
        self.all_joints_uvd = self.pseudo_uvd
        self.all_joints_xyz = C.joint_img_to_3d(self.pseudo_uvd, self.paras,
                                                self.flip)

    def _fetch_batch(self, idx, stripe=(0, 1)) -> dict:
        out = super()._fetch_batch(idx, stripe)
        out["weight"] = self.weights[np.asarray(idx)]
        return out


class NYUSTDataset(NYUDataset):
    """NYU's self-training variant (ref: nyu_ST_loader,
    render_loader.py:1949-2052): view 0, each batch also carrying the
    frames' MANO parameters (``model_para`` (B, 62), from
    ``{root}/posePara_lm_collosion``), and a per-frame pseudo-label mask
    (``mask``, zeros) for the self-training loop to update."""

    def __init__(self, root_dir, phase, **kw):
        super().__init__(root_dir, phase, view=0, **kw)
        self.all_model_para = ModelParaOnlyDataset(root_dir, "nyu", phase,
                                                   view=0).params
        self.mask = np.zeros(len(self), np.float32)

    def _fetch_batch(self, idx, stripe=(0, 1)) -> dict:
        out = super()._fetch_batch(idx, stripe)
        out["model_para"] = self.all_model_para[np.asarray(idx)]
        return out


class ModelParaOnlyDataset:
    """Per-frame MANO parameters of a dataset (ref: nyu_modelPara_loader,
    msra_modelPara_loader, render_loader.py:2054-2117, 2622-2703): 62-D
    float32 rows (glb 3, pose 45, shape 10, scale 1, trans 3) from
    ``{root}/posePara_lm_collosion/{dataset}-{phase}-{view}-*.txt``; an
    item is (row, cube)."""

    def __init__(self, root_dir, dataset_name, phase, view=0,
                 cube_size=(250, 250, 250)):
        d = os.path.join(root_dir, "posePara_lm_collosion")
        load = lambda sfx, c: np.loadtxt(os.path.join(
            d, f"{dataset_name}-{phase}-{view}-{sfx}.txt")).reshape(-1, c)
        self.params = np.concatenate(
            [load("glb", 3), load("pose", 45), load("shape", 10),
             load("scale", 1), load("trans", 3)], axis=-1).astype(np.float32)
        self.cube_size = np.asarray(cube_size, np.float32)

    def __len__(self):
        return len(self.params)

    def __getitem__(self, i):
        return self.params[i], self.cube_size


class ConcatDataset(BaseDataset):
    """Datasets of one batch layout end to end (ref: nyu_loader_train_test,
    the 72757 train + 8252 test frames, render_loader.py:1584-1698).  A
    batch's frames are fetched from each member as one batch of its own
    (augmentation draws from that member's RandomState, in order of the
    members), then put back in the batch's order."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.paras = self.datasets[0].paras
        self.ori_img_size = self.datasets[0].ori_img_size
        self.flip = self.datasets[0].flip
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def _fetch_batch(self, idx, stripe=(0, 1)) -> dict:
        idx = np.asarray(idx)
        member = np.searchsorted(self._offsets, idx, side="right") - 1
        out = {}
        for k in np.unique(member):
            rows = np.flatnonzero(member == k)
            part = self.datasets[k]._fetch_batch(idx[rows] - self._offsets[k],
                                                 stripe)
            for key, v in part.items():
                if key not in out:
                    out[key] = np.empty((len(idx),) + v.shape[1:], v.dtype)
                out[key][rows] = v
        return out

    def close(self) -> None:
        for d in self.datasets:
            d.close()


class NYUTestAugDataset(NYUDataset):
    """NYU's test split with the training augmentation (ref:
    nyu_loader_test, render_loader.py:1483-1583), for self-training on
    the test distribution: the test paths and labels, the train-sized
    cube for every frame (no 5/6 shrink), augmented batches."""

    def __init__(self, root_dir, **kw):
        super().__init__(root_dir, "test", **kw)
        self.test_cubesize[:] = self.cube_size
        self.augment = True


class ICVLDataset(BaseDataset):
    """ICVL with the left-right flip (ref: flip_icvl_loader,
    render_loader.py:2305-2455).

    The reference's layout: {root}/train.txt or {root}/test_seq_1.txt and
    test_seq_2.txt, {root}/center_{phase}_refined.txt, images under
    {root}/Depth/; else {root}/[Training|Testing]/labels.txt.  The test
    list is filtered to the protocol's subsequences as the reference
    filters it (render_loader.py:2421-2433; ``sub_seq`` ("0",) unless
    ``full_img``): a frame whose first path component is longer than 6
    characters passes, a short-named subsequence only when listed in
    ``sub_seq``; frames with an ``invalid`` refined centre or without an
    image file are skipped.  The centre file is indexed by the line's
    position in the list before filtering.  Images are flipped left to
    right at read, u becomes 320 - u in the labels and the refined
    centre's x is negated.
    """

    def __init__(self, root_dir, phase, img_size=128,
                 cube_size=(200, 200, 200), center_type="refine",
                 aug_para=(10, 0.2, 180), seed=0, full_img=False,
                 sub_seq=("0",)):
        self.paras = (240.99, 240.96, 160.0, 120.0)
        self.ori_img_size = (320, 240)
        self.flip = 1.0
        self.phase = phase
        self.img_size = img_size
        self.cube_size = np.asarray(cube_size, np.float32)
        self.aug_para = aug_para
        self.rng = np.random.RandomState(seed)
        self.root_dir = root_dir
        self.augment = phase == "train"

        if os.path.exists(os.path.join(root_dir, "train.txt")) or \
                os.path.exists(os.path.join(root_dir, "test_seq_1.txt")):
            names, uvds, centers = self._read_reference_layout(
                root_dir, phase, full_img, sub_seq)
        else:
            names, uvds, centers = self._read_flat_layout(root_dir, phase)
        self.img_names = names
        self.all_joints_uvd = (np.stack(uvds).astype(np.float32) if uvds
                               else np.zeros((0, ICVL_JOINTS, 3), np.float32))
        # the image is flipped at read: u -> W - u
        self.all_joints_uvd[:, :, 0] = \
            self.ori_img_size[0] - self.all_joints_uvd[:, :, 0]
        self.all_joints_xyz = C.joint_img_to_3d(
            self.all_joints_uvd, self.paras, self.flip)
        if center_type == "refine" and centers is not None:
            self.center_xyz = np.asarray(centers, np.float32).reshape(-1, 3)
            # the reference re-projects the centre and flips u about
            # cx = 160 (render_loader.py:2338-2341): x negated
            self.center_xyz[:, 0] = -self.center_xyz[:, 0]
        else:
            self.center_xyz = self.all_joints_xyz.mean(1)

    @staticmethod
    def _read_reference_layout(root_dir, phase, full_img, sub_seq):
        """ref: flip_icvl_loader.read_joints (render_loader.py:2399-2453)."""
        if phase == "train":
            with open(os.path.join(root_dir, "train.txt")) as f:
                lines = f.read().splitlines()
            center_path = os.path.join(root_dir, "center_train_refined.txt")
        else:
            lines = []
            for seq in ("test_seq_1.txt", "test_seq_2.txt"):
                with open(os.path.join(root_dir, seq)) as f:
                    lines += f.read().splitlines()
            lines = [ln for ln in lines if ln]
            center_path = os.path.join(root_dir, "center_test_refined.txt")
        center_lines = None
        if os.path.exists(center_path):
            with open(center_path) as f:
                center_lines = f.readlines()

        names, uvds, centers = [], [], []
        sub_seq = list(sub_seq)
        for index, line in enumerate(lines):
            strs = line.split()
            p = strs[0].split("/")
            if not full_img and not (("0" in sub_seq and len(p[0]) > 6)
                                     or (p[0] in sub_seq and len(p[0]) <= 6)):
                continue
            img_path = os.path.join(root_dir, "Depth", strs[0])
            if not os.path.isfile(img_path):
                continue
            if center_lines is not None:
                cstr = center_lines[index].split()
                if cstr[0] == "invalid":
                    continue
                centers.append([float(v) for v in cstr])
            names.append(img_path)
            uvds.append(np.asarray(strs[1:1 + 3 * ICVL_JOINTS],
                                   np.float32).reshape(ICVL_JOINTS, 3))
        return names, uvds, (centers if center_lines is not None else None)

    @staticmethod
    def _read_flat_layout(root_dir, phase):
        phase_dir = "Training" if phase == "train" else "Testing"
        label_path = os.path.join(root_dir, phase_dir, "labels.txt")
        center_path = os.path.join(root_dir, phase_dir,
                                   f"center_{phase}_refined.txt")
        names, uvds = [], []
        with open(label_path) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) < 1 + 3 * ICVL_JOINTS:
                    continue
                names.append(os.path.join(root_dir, phase_dir, "Depth",
                                          parts[0]))
                uvds.append(np.asarray(parts[1:1 + 3 * ICVL_JOINTS],
                                       np.float32).reshape(ICVL_JOINTS, 3))
        centers = None
        if os.path.exists(center_path):
            centers = np.loadtxt(center_path).astype(np.float32)
        return names, uvds, centers

    def __len__(self):
        return len(self.img_names)

    def _read_depth(self, index) -> np.ndarray:
        depth = readers.icvl_reader(self.img_names[index])
        return depth[:, ::-1].copy()                # left-right flip

    def _fetch_batch(self, idx, stripe=(0, 1)) -> dict:
        idx = np.asarray(idx)
        cubes = np.tile(self.cube_size.astype(np.float32), (len(idx), 1))
        return self._fast_batch(idx, self.all_joints_xyz,
                                self.center_xyz[idx], cubes, stripe)


class MSRADataset(BaseDataset):
    """MSRA's 9-subject leave-one-out (ref: msra_loader,
    render_loader.py:2458-2620): the test split is subject
    ``test_persons``, the train split the other eight.  Each subject has
    its own cube (``PERSON_CUBES``), so each frame carries its own.

    Needs {root}/P{p}/{gesture}/joint.txt (the frame count, then 21 x 3
    world joints a frame, y and z negated) and {i:06d}_depth.bin frames;
    with ``center_type="refine"``, {root}/center_{phase}_{test_persons}
    _refined.txt, one row a frame, y negated, else the joints' mean.
    """

    PERSON_CUBES = [200, 200, 200, 180, 180, 180, 170, 160, 150]
    GESTURES = ["1", "2", "3", "4", "5", "6", "7", "8", "9", "I", "IP", "L",
                "MP", "RP", "T", "TIP", "Y"]

    def __init__(self, root_dir, phase, test_persons=0, img_size=128,
                 center_type="refine", aug_para=(10, 0.2, 180), seed=0,
                 write_record=False):
        self.paras = (241.42, 241.42, 160.0, 120.0)
        self.ori_img_size = (320, 240)
        self.flip = 1.0
        self.phase = phase
        self.img_size = img_size
        self.aug_para = aug_para
        self.rng = np.random.RandomState(seed)
        self.root_dir = root_dir
        self.augment = phase == "train"

        persons = ([test_persons] if phase == "test"
                   else [p for p in range(9) if p != test_persons])
        self.files, self.rel_files, cubes, joints = [], [], [], []
        for p in persons:
            pdir = os.path.join(root_dir, f"P{p}")
            if not os.path.isdir(pdir):
                continue
            for g in self.GESTURES:
                gdir = os.path.join(pdir, g)
                jfile = os.path.join(gdir, "joint.txt")
                if not os.path.exists(jfile):
                    continue
                with open(jfile) as f:
                    n = int(f.readline())
                    data = np.loadtxt(f).reshape(n, MSRA_JOINTS, 3)
                # y and z negated in the raw file (the reference negates z,
                # then its flip=-1 / flip=1 uvd round trip negates y,
                # render_loader.py:2507-2512)
                data[:, :, 1] = -data[:, :, 1]
                data[:, :, 2] = -data[:, :, 2]
                for i in range(n):
                    self.files.append(os.path.join(gdir, f"{i:06d}_depth.bin"))
                    self.rel_files.append(f"P{p}/{g}/{i:06d}_depth.bin")
                    cubes.append(float(self.PERSON_CUBES[p]))
                    joints.append(data[i])
        self.joints_xyz = (np.stack(joints).astype(np.float32) if joints
                           else np.zeros((0, MSRA_JOINTS, 3), np.float32))
        self.cubes = np.asarray(cubes, np.float32)
        if write_record:
            # the reference writes msra_record_list.txt and msra_label.txt
            # at init (render_loader.py:2467, 2492-2495); here into root_dir
            with open(os.path.join(root_dir, "msra_record_list.txt"),
                      "w") as f:
                f.write("".join(r + "\r\n" for r in self.rel_files))
            uvd = C.joint_3d_to_img(self.joints_xyz, self.paras, self.flip)
            np.savetxt(os.path.join(root_dir, "msra_label.txt"),
                       uvd.reshape(len(uvd), -1), fmt="%.3f")

        self.center_xyz = (self.joints_xyz.mean(1) if len(self.joints_xyz)
                           else np.zeros((0, 3)))
        center_path = os.path.join(
            root_dir, f"center_{phase}_{int(test_persons)}_refined.txt")
        if center_type == "refine" and os.path.exists(center_path):
            # the y-negation round trip of the reference (render_loader.py
            # :2495-2500)
            raw = np.loadtxt(center_path).astype(np.float32).reshape(-1, 3)
            uvd = C.joint_3d_to_img(raw, self.paras, -1.0)
            self.center_xyz = C.joint_img_to_3d(
                uvd, self.paras, self.flip).astype(np.float32)
            if len(self.center_xyz) != len(self.files):
                raise ValueError(
                    f"center file rows {len(self.center_xyz)} != frames "
                    f"{len(self.files)} ({center_path})")

    def __len__(self):
        return len(self.files)

    def _read_depth(self, index) -> np.ndarray:
        return readers.msra_reader(self.files[index], self.paras)[0]

    def _fetch_batch(self, idx, stripe=(0, 1)) -> dict:
        idx = np.asarray(idx)
        cubes = np.repeat(self.cubes[idx][:, None], 3, axis=1)
        return self._fast_batch(idx, self.joints_xyz, self.center_xyz[idx],
                                cubes, stripe)


def _item_center_uvd(joints_xyz, paras, flip) -> np.ndarray:
    """The JAX SHREC item's crop centre from its joints: the mean of
    their (u, v, d), float32 (ref: shrec_loader)."""
    uvd = C.joint_3d_to_img(joints_xyz, paras, flip)
    return np.asarray([uvd[:, 0].mean(), uvd[:, 1].mean(), uvd[:, 2].mean()],
                      np.float32)


def _blob_center_uvd(depth) -> np.ndarray:
    """The crop centre of a frame without joints: the mean (u, v, d) of
    the pixels with 100 < d < 1000 mm."""
    fg = (depth > 100) & (depth < 1000)
    vs, us = np.nonzero(fg)
    return np.asarray([us.mean(), vs.mean(), depth[fg].mean()], np.float32)


class SHRECDataset(BaseDataset):
    """SHREC'17 gesture sequences for the skeleton export (ref:
    shrec_loader, render_loader.py:3078-3185): every directory under
    ``root_dir`` holding ``*_depth.png`` frames (640x480) is a sequence,
    its frames in sorted name order.  Joints come from the sequence's
    ``pred_file`` where it exists, and the crop centre is their (u, v, d)
    mean; else the centre is the depth blob's (100 < d < 1000 mm) and
    every joint sits at it.  ``samples`` holds (depth path, joints or
    None, sequence directory, frame) per frame.
    """

    def __init__(self, root_dir, img_size=128, cube_size=(200, 200, 200),
                 aug_para=(0, 0, 0), seed=0,
                 pred_file="skeletons_world_pred.txt"):
        self.paras = (463.889, 463.889, 320.0, 240.0)
        self.ori_img_size = (640, 480)
        self.flip = 1.0
        self.phase = "train"
        self.img_size = img_size
        self.cube_size = np.asarray(cube_size, np.float32)
        self.aug_para = aug_para
        self.rng = np.random.RandomState(seed)
        self.root_dir = root_dir
        self.samples = []
        self._centers = []      # the item's crop centre (u, v, d), or None
        for dirpath, _, files in os.walk(root_dir):
            depths = sorted(f for f in files if f.endswith("_depth.png"))
            if not depths:
                continue
            pred = os.path.join(dirpath, pred_file)
            joints = None
            if os.path.exists(pred):
                joints = np.loadtxt(pred).reshape(-1, 21, 3)
            for i, fname in enumerate(depths):
                j = (joints[i].astype(np.float32)
                     if joints is not None and i < len(joints) else None)
                self.samples.append((os.path.join(dirpath, fname), j,
                                     dirpath, i))
                self._centers.append(
                    None if j is None
                    else _item_center_uvd(j, self.paras, self.flip))

    def __len__(self):
        return len(self.samples)

    def _read_depth(self, index) -> np.ndarray:
        return readers.shrec_reader(self.samples[index][0])

    def _fetch_batch(self, idx, stripe=(0, 1)) -> dict:
        idx = np.asarray(idx)
        depths = self._depths(idx)
        coms = np.stack([
            _blob_center_uvd(d) if self._centers[i] is None
            else self._centers[i] for i, d in zip(idx, depths)])
        centers = C.joint_img_to_3d(coms, self.paras, self.flip)
        joints = np.stack([
            np.tile(c, (21, 1)) if self.samples[i][1] is None
            else self.samples[i][1] for i, c in zip(idx, centers)])
        cubes = np.tile(self.cube_size.astype(np.float64), (len(idx), 1))
        return aug_batch.unaugmented_batch(
            depths, joints, coms, cubes, self.paras, self.flip,
            self.img_size, nthreads=self.NUM_WORKERS)


def read_dhg_sequences(root_dir):
    """The DHG 14/28 index (ref: DHG_loader.read_joints,
    render_loader.py:3026-3051): the rows ``gesture finger subject essai
    start end`` of ``informations_troncage_sequences.txt``, each naming
    gesture_{g}/finger_{f}/subject_{s}/essai_{e}/.  Returns a list of
    dicts {dir, gesture, finger, subject, essai, start, end}."""
    import re
    info = os.path.join(root_dir, "informations_troncage_sequences.txt")
    seqs = []
    splitter = re.compile(r"[ \t\n\r]+")
    with open(info) as f:
        for line in f:
            parts = [p for p in splitter.split(line) if p]
            if len(parts) < 6:
                continue
            g, fi, s, e, start, end = parts[:6]
            seqs.append({
                "dir": os.path.join(
                    root_dir, f"gesture_{g}", f"finger_{fi}",
                    f"subject_{s}", f"essai_{e}"),
                "gesture": int(g), "finger": int(fi), "subject": int(s),
                "essai": int(e), "start": int(start), "end": int(end),
            })
    return seqs


class DHGDataset(BaseDataset):
    """DHG 14/28 gesture sequences (ref: DHG_loader,
    render_loader.py:2964-3075), indexed by ``read_dhg_sequences``: the
    frames ``depth_{frame + 1}.png`` of each truncated range, joints from
    the sequence's ``pred_file`` (one row a truncated frame), the crop
    centre the uv mean of ``skeleton_image.txt``'s row and the joints'
    mean depth x 1000.  The image and the centre's u are flipped left to
    right (640 - u).  Batches also carry ``gesture`` (1-14) and
    ``label28``, (gesture - 1) * 2 + finger - 1.
    """

    def __init__(self, root_dir, img_size=128, cube_size=(250, 250, 250),
                 aug_para=(10, 0.1, 180), seed=0,
                 pred_file="skeletons_world_pred_normal_DSSF.txt",
                 augment=False):
        self.paras = (463.889, 463.889, 320.0, 240.0)
        self.ori_img_size = (640, 480)
        self.flip = 1.0
        self.phase = "train"
        self.img_size = img_size
        self.cube_size = np.asarray(cube_size, np.float32)
        self.aug_para = aug_para
        self.augment = augment
        self.rng = np.random.RandomState(seed)
        self.root_dir = root_dir
        self.sequences = read_dhg_sequences(root_dir)

        self.samples = []          # (depth path, xyz (21, 3), centre uvd, seq)
        for seq in self.sequences:
            d = seq["dir"]
            xyz = np.loadtxt(os.path.join(d, pred_file), ndmin=2)
            uvd = np.loadtxt(os.path.join(d, "skeleton_image.txt"), ndmin=2)
            for k, frame in enumerate(range(seq["start"], seq["end"] + 1)):
                jx = xyz[k].reshape(-1, 3)
                center_uvd = np.concatenate([
                    uvd[frame].reshape(-1, 2).mean(0),
                    jx.mean(0)[2:3] * 1000.0])
                center_uvd[0] = 640 - center_uvd[0]     # u flip (ref :2979)
                self.samples.append(
                    (os.path.join(d, f"depth_{frame + 1}.png"),
                     jx.astype(np.float32), center_uvd.astype(np.float32),
                     seq))

    def __len__(self):
        return len(self.samples)

    def _read_depth(self, index) -> np.ndarray:
        depth = readers.shrec_reader(self.samples[index][0])
        return depth[:, ::-1].copy()                  # flip (ref :2988)

    def _fetch_batch(self, idx, stripe=(0, 1)) -> dict:
        idx = np.asarray(idx)
        depths = self._depths(idx)
        joints = np.stack([self.samples[i][1] for i in idx])
        coms = np.stack([self.samples[i][2] for i in idx])
        cubes = np.tile(self.cube_size.astype(np.float64), (len(idx), 1))
        if self.augment:
            out = aug_batch.augment_fast_batch(
                depths, joints, C.joint_img_to_3d(coms, self.paras, self.flip),
                cubes, self.paras, self.flip, self.img_size,
                self._aug_draws(len(idx), stripe),
                nthreads=self.NUM_WORKERS, coms=coms)
        else:
            out = aug_batch.unaugmented_batch(
                depths, joints, coms, cubes, self.paras, self.flip,
                self.img_size, nthreads=self.NUM_WORKERS)
        seqs = [self.samples[i][3] for i in idx]
        out["gesture"] = np.asarray([s["gesture"] for s in seqs], np.int32)
        out["label28"] = np.asarray([(s["gesture"] - 1) * 2 + s["finger"] - 1
                                     for s in seqs], np.int32)
        return out

    def write_joints(self, predict_xyz, out_name="skeletons_world_pred.txt"):
        """Write the predicted skeletons (N, 21, 3) world mm, one row a
        truncated frame in the dataset's order, as ``out_name`` in each
        sequence's directory (ref: DHG_loader.write_joints,
        render_loader.py:3058-3075).  Returns the frames written."""
        i = 0
        for seq in self.sequences:
            n = seq["end"] - seq["start"] + 1
            np.savetxt(os.path.join(seq["dir"], out_name),
                       np.asarray(predict_xyz[i:i + n]).reshape(n, -1),
                       fmt="%.8f")
            i += n
        return i
