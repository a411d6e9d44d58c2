"""Skeleton export for action-recognition pipelines (counterpart of
dsf_tpu/tools/skeleton_export.py; ref: the write_joints flow,
render_loader.py:3053-3071 and 3166-3181).

``export_skeletons`` runs the trainer's eval step over a SHREC-layout
dataset (``datasets.SHRECDataset``) and writes each sequence's predicted
MANO joints as ``skeletons_world_pred.txt`` beside its frames: 21 joints
x 3 in world mm a row, one row a frame, the input of DG-STA.  DHG's
sequences export through ``datasets.DHGDataset.write_joints``.
"""

from __future__ import annotations

import os

import numpy as np

from dsf_tpu_torch.device import widen
from dsf_tpu_torch.training.loop import BATCH_KEYS


def export_skeletons(trainer, state, dataset, batch_size=32,
                     out_name="skeletons_world_pred.txt", stage=-1):
    """Predict every frame of ``dataset`` with ``trainer.eval_step_fn()``
    at ``state`` (batches of ``batch_size``, the tail padded by repeating
    its last frame) and write each sequence's joints of stage ``stage``
    (``%.4f``) as ``out_name`` in its directory.  The dataset's
    ``samples[i][2]`` must be frame i's sequence directory, as
    SHRECDataset's are.  Returns the sequence directories written, in
    order of their first frame."""
    seq_of = [s[2] for s in getattr(dataset, "samples", ())]
    if len(seq_of) != len(dataset) or not all(isinstance(q, str)
                                              for q in seq_of):
        raise ValueError(
            f"{type(dataset).__name__}: export_skeletons groups frames by "
            "the sequence directory in samples[i][2] (SHRECDataset); a "
            "DHGDataset exports with its write_joints")
    step = trainer.eval_step_fn()
    world = []
    for b in dataset.prefetch_batches(batch_size, shuffle=False,
                                      drop_last=False):
        valid = len(b["img"])
        if valid < batch_size:
            pad = batch_size - valid
            b = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                 for k, v in b.items()}
        _, results = step(state, {k: b[k] for k in BATCH_KEYS})
        key = [k for k in results if k.startswith("mano_joint_xyz")][stage]
        jxyz = widen(results[key]).cpu().numpy()
        w = jxyz * b["cube"][:, None] / 2.0 + b["center"][:, None]
        world.append(w[:valid])

    grouped = {}
    for seq, w in zip(seq_of, (np.concatenate(world) if world else ())):
        grouped.setdefault(seq, []).append(w)
    for seq_dir, frames in grouped.items():
        arr = np.stack(frames).reshape(len(frames), -1)
        np.savetxt(os.path.join(seq_dir, out_name), arr, fmt="%.4f")
    return list(grouped)
