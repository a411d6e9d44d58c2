"""The NYU loader (counterpart of dsf_tpu/data/datasets.py's
``BaseDataset`` and ``NYUDataset``; ref: nyu_loader,
render_loader.py:1803-1947).

Batches are (img, xyz_gt, uvd_gt, center, M, cube) dicts of numpy arrays,
made by the batched fast paths of the JAX package: the PNG decode fans
out over a worker pool (``readers.nyu_reader``), the crop, warps and
normalization run in the threaded host library (``native``,
``aug_batch``), the label math is vectorized numpy.  An item is a batch of
one: there is no second, per-item path.  Augmented (train) batches draw
their (mode, off, rot, sc) from the dataset's one ``RandomState``.

ICVL, MSRA and SHREC loaders are not ported yet (ROADMAP Queue 1).
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


class BaseDataset:
    """Batching, prefetching and the depth cache over a subclass's
    ``_read_depth(index)`` and ``_fetch_batch(idx)``."""
    paras: tuple
    ori_img_size: tuple
    flip: float = 1.0
    # decode and crop workers (threads: zlib and the host library release
    # the interpreter lock), capped at the host's cores
    NUM_WORKERS = max(1, min(8, os.cpu_count() or 1))

    def __len__(self):
        raise NotImplementedError

    def _fetch_batch(self, idx) -> dict:
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

    def _aug_fast_batch(self, idx, depths, joints_xyz, centers, cubes):
        """The augmented batch (``aug_batch.augment_fast_batch``), its
        draws from the dataset's RandomState."""
        draws = aug_batch.draw_params(self.rng, len(idx), self.aug_para)
        return aug_batch.augment_fast_batch(
            depths, joints_xyz[idx], centers, cubes.astype(np.float64),
            self.paras, self.flip, self.img_size, draws,
            nthreads=self.NUM_WORKERS)

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

    def batches(self, batch_size: int, shuffle=False, seed=0,
                drop_last=True, loop=False) -> Iterator[dict]:
        """Batches in order (or a permutation from ``seed`` per pass);
        ``drop_last=False`` keeps a short tail; ``loop`` repeats."""
        rng = np.random.RandomState(seed)
        n = len(self)
        while True:
            order = rng.permutation(n) if shuffle else np.arange(n)
            end = n - batch_size + 1 if drop_last else n
            for s in range(0, end, batch_size):
                yield self._fetch_batch(order[s:s + batch_size])
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

    def _fetch_batch(self, idx) -> dict:
        idx = np.asarray(idx)
        depths = np.stack(list(self._worker_pool().map(
            self._read_depth_cached, idx)))
        cubes = (self.test_cubesize[idx] if self.phase == "test"
                 else np.tile(self.cube_size, (len(idx), 1))).astype(
                     np.float32)
        if self.augment:
            return self._aug_fast_batch(idx, depths, self.all_joints_xyz,
                                        self.center_xyz[idx], cubes)
        return self._eval_fast_batch(idx, depths, self.all_joints_xyz,
                                     self.center_xyz[idx], cubes)
