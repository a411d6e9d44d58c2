"""Worlds of gloo ranks on the CPU for the port's multi-GPU tests
(tests/test_torch_parallel.py, tests/test_torch_parallel_steps.py).

``run_world(name, world, args, out_dir, timeout)`` starts ``world``
processes (``python -m torch_parallel_workers``), each with the
environment ``torchrun`` would set, a free port and two threads; each
joins the group through ``parallel.distributed.initialize("cpu")`` and
runs the worker ``name`` of this module on ``args``.  Every rank's return
value comes back in rank order.  The world has a time limit of its own
(there is no pytest-timeout): past it every rank is killed and the call
raises.  A worker called in the test's own process (no environment) is
world 1 and joins nothing.

This module imports torch, numpy and the port only: the ranks start
without JAX.
"""

from __future__ import annotations

import builtins
import os
import pickle
import shutil
import socket
import subprocess
import sys
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(name, world, args, out_dir, timeout=240):
    """Rank r's return value of worker ``name`` for r < ``world``."""
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "args.pkl"), "wb") as f:
        pickle.dump(args, f)
    port = free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                   WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTHONPATH=os.pathsep.join([REPO, HERE]))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "torch_parallel_workers", name, out_dir],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    try:
        logs = [p.communicate(timeout=timeout)[0].decode(errors="replace")
                for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise TimeoutError(f"world of {world} running {name} passed its "
                           f"{timeout} s limit")
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(f"{name}: ranks {bad} failed:\n"
                           + "\n".join(log[-3000:] for log in logs))
    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _main(name, out_dir):
    from dsf_tpu_torch.parallel import distributed
    torch.set_num_threads(2)
    with open(os.path.join(out_dir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    distributed.initialize("cpu")
    try:
        res = globals()[name](args)
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    with open(os.path.join(out_dir, f"rank{distributed.rank()}.pkl"),
              "wb") as f:
        pickle.dump(res, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _np(t):
    return t.detach().float().cpu().numpy().copy()


def stripe_groups(mesh, x, groups):
    """This rank's rows of each of ``groups`` stacked global batches
    (group-major), stacked as a rank's [synth | real] forward is."""
    return torch.cat([mesh.stripe(h) for h in
                      torch.from_numpy(x).chunk(groups)])


# ------------------------------------------------------------ the units

def bn_stack(case):
    """Two ConvBNRelu layers in train mode on this rank's rows (``x``
    (b, 1, H, W) per group, stacked group-major) with the weights of
    ``case``; the statistics are global over a world of ranks.  Returns
    the output, each BatchNorm's running statistics and the gradients of
    sum(y * r) (this rank's share of the global sum)."""
    from dsf_tpu_torch.models import layers as TL
    from dsf_tpu_torch.parallel import mesh as M
    net = torch.nn.Sequential(TL.ConvBNRelu(1, 8), TL.ConvBNRelu(8, 16))
    with torch.no_grad():
        for i, layer in enumerate(net):
            layer[0].weight.copy_(torch.from_numpy(case["w"][i]))
            layer[1].weight.copy_(torch.from_numpy(case["scale"][i]))
            layer[1].bias.copy_(torch.from_numpy(case["bias"][i]))
    dtype = getattr(torch, case["dtype"])
    TL.set_compute_dtype(net, dtype)
    mesh = M.make_mesh()
    for m in net.modules():
        if isinstance(m, TL.BatchNorm2d):
            m.groups = case["groups"]
            m.sync = mesh if mesh.world > 1 else None
    x = stripe_groups(mesh, case["x"], case["groups"])
    x = x.to(dtype).requires_grad_(True)
    r = stripe_groups(mesh, case["r"], case["groups"])
    y = net(x)
    (y.float() * r).sum().backward()
    return dict(
        y=_np(y), x_grad=_np(x.grad),
        stats=[(_np(l[1].running_mean), _np(l[1].running_var),
                int(l[1].num_batches_tracked)) for l in net],
        grads={n: _np(p.grad) for n, p in net.named_parameters()})


def masked_sl1(case):
    """``phases._masked_select_sl1`` on this rank's rows: value and the
    gradient of its input (global count over the ranks)."""
    from dsf_tpu_torch.parallel import mesh as M
    from dsf_tpu_torch.training.phases import _masked_select_sl1
    mesh = M.make_mesh()
    a = mesh.stripe(torch.from_numpy(case["a"])).requires_grad_(True)
    b = mesh.stripe(torch.from_numpy(case["b"]))
    mask = mesh.stripe(torch.from_numpy(case["mask"]))
    v = _masked_select_sl1(a, b, mask, mesh if mesh.world > 1 else None)
    v.backward()
    return dict(value=float(v.detach()), grad=_np(a.grad))


def guard(case):
    """The guarded AdamW over a world (``n_fsdp`` from ``case``): steps
    with this rank's gradients (``case["grads"][step][rank]``), one of
    them NaN on rank 0 only.  Returns per step the decision and the
    parameters, then the whole state dict and a reload of it."""
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.parallel import distributed
    from dsf_tpu_torch.parallel import mesh as M
    from dsf_tpu_torch.training.trainer import make_optimizer
    mesh = M.make_mesh(case["n_fsdp"])
    params = [torch.nn.Parameter(torch.from_numpy(w.copy()))
              for w in case["w"]]
    opt = make_optimizer(Config(), params, 10, mesh)
    rank = distributed.rank()
    out = []
    for per_rank in case["grads"]:
        for p, g in zip(params, per_rank[rank]):
            p.grad = torch.from_numpy(g.copy())
        accept = opt.step()
        out.append((bool(accept), [_np(p) for p in params],
                    int(opt.count), int(opt.notfinite_count)))
    sd = opt.state_dict()
    opt2 = make_optimizer(Config(), params, 10, mesh)
    opt2.load_state_dict(sd)
    return dict(steps=out, state={k: (_np(v) if torch.is_tensor(v) else v)
                                  for k, v in sd.items()},
                reloaded={k: _np(v) for k, v in opt2.buffers.items()})


def evaluate_sum(case):
    """``Trainer.evaluate``'s reduction: this rank's error rows summed and
    counted over the ranks."""
    from dsf_tpu_torch.parallel import distributed
    from dsf_tpu_torch.parallel import mesh as M
    from dsf_tpu_torch.training.trainer import Trainer
    tr = Trainer.__new__(Trainer)
    tr.mesh = M.make_mesh()
    rows = case["errors"][distributed.rank()]
    tr._eval_step = lambda state, b: (torch.from_numpy(b), None)
    return tr.evaluate(None, iter(rows))


def units(cases):
    """Every unit case of tests/test_torch_parallel.py in one world."""
    return {name: globals()[kind](case) for name, (kind, case)
            in cases.items()}


# ------------------------------------------------------------ the steps

def _trainer(kw, mano, n_fsdp=1):
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.training.trainer import Trainer
    cfg = Config(**dict(kw, n_fsdp=n_fsdp))
    return Trainer(cfg, mano, steps_per_epoch=10, device="cpu")


def steps(case):
    """One step of each run (``case["runs"]``: label, phase, Config
    keywords, and whether BatchNorm keeps per-rank statistics, a mutation
    the tests must catch) on this rank's stripe of the global batch, from
    the trainers' seeded weights and draws: the step's metrics averaged
    over the ranks, this rank's flat gradient (the ranks' mean is the
    global one), the running statistics and the parameters after the
    update.  The labels in ``case["remat"]`` run again with DSF_REMAT=1
    (``{label}_remat``).  Then two Pretrain steps of ``n_fsdp`` 1 and 2
    (``case["fsdp"]``): their parameters."""
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.data.synth_params import random_param_source
    out = {}
    runs = list(case["runs"])
    runs += [(f"{label}_remat", phase, kw, local_bn)
             for label, phase, kw, local_bn in case["runs"]
             if label in case.get("remat", ())]
    for label, phase, kw, local_bn in runs:
        os.environ["DSF_REMAT"] = "1" if label.endswith("_remat") else "0"
        tr = _trainer(kw, case["mano"])
        B = kw["batch_size"]
        state = tr.init_state()
        if local_bn:
            state.net.sync = None
        para, cube = next(random_param_source(B, seed=1))
        batch = {"model_para": para, "cube_synth": cube}
        if phase != "Pretrain":
            batch.update(demo.real_batch(tr.renderer, B,
                                         np.random.RandomState(2)))
        batch = {k: tr.mesh.stripe(v) for k, v in batch.items()}
        state, metrics = tr.train_step_fn(phase)(state, tr.draw(B, phase),
                                                 batch)
        net = state.net
        out[label] = dict(
            metrics={k: float(v) for k, v in
                     tr.global_metrics(metrics).items()},
            grad=np.concatenate([_np(p.grad).ravel()
                                 for p in net.parameters()]),
            stats={n: _np(b) for n, b in net.named_buffers()
                   if "running" in n},
            params=np.concatenate([_np(p).ravel() for p in net.parameters()]))
    os.environ.pop("DSF_REMAT", None)
    if case.get("fsdp"):
        kw = case["fsdp"]
        for n_fsdp in (1, 2):
            tr = _trainer(kw, case["mano"], n_fsdp)
            B = kw["batch_size"]
            state = tr.init_state()
            src = random_param_source(B, seed=3)
            for _ in range(2):
                para, cube = next(src)
                tr.train_step_fn("Pretrain")(
                    state, tr.draw(B), {"model_para": tr.mesh.stripe(para),
                                        "cube_synth": tr.mesh.stripe(cube)})
            out[f"fsdp{n_fsdp}"] = dict(
                params=np.concatenate([_np(p).ravel()
                                       for p in state.net.parameters()]),
                moments={k: _np(v) for k, v in
                         state.optimizer.state_dict().items()
                         if torch.is_tensor(v) and v.dim() == 1})
    return out


def loop_run(case):
    """``training.loop.run`` on the CPU with ``case["cfg"]`` for
    ``case["epochs"]`` epochs; on a rank other than 0, any write under the
    save directory raises.  With ``case["keep_epoch0"]``, rank 0 copies
    the epoch-0 ``latest`` there as it is saved, and a second run with
    ``case["resume"]`` follows in the same processes.  Returns the run
    directory, or both."""
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.parallel import distributed
    from dsf_tpu_torch.training import checkpoints as ckpt
    from dsf_tpu_torch.training import loop as TL
    n = case["epochs"]
    Config.max_epoch = property(lambda self: n)
    save_dir = os.path.realpath(case["cfg"]["save_dir"])
    if distributed.rank() != 0:
        _forbid_writes(save_dir)
    elif case.get("keep_epoch0"):
        save = ckpt.save

        def keep_epoch0(path, tr, state, epoch):
            save(path, tr, state, epoch)
            if epoch == 0 and os.path.basename(path) == "latest":
                ckpt.wait_until_finished()
                shutil.copytree(path, os.path.join(case["keep_epoch0"],
                                                   "latest"))
        ckpt.save = keep_epoch0
    run = TL.run(Config(**case["cfg"]), device="cpu")
    if not case.get("resume"):
        return run
    return run, TL.run(Config(**case["resume"]), device="cpu")


def _forbid_writes(root):
    """Make every file write, directory creation and copy under ``root``
    raise in this process."""
    def inside(path):
        return os.path.realpath(str(path)).startswith(root)

    def guard(fn, target, is_write=lambda a, kw: True):
        def wrapped(*a, **kw):
            if is_write(a, kw) and inside(target(a)):
                raise PermissionError(f"a rank other than 0 wrote "
                                      f"{target(a)}")
            return fn(*a, **kw)
        return wrapped

    mode = lambda a, kw: any(c in (a[1] if len(a) > 1 else
                                   kw.get("mode", "r")) for c in "wax+")
    builtins.open = guard(builtins.open, lambda a: a[0], mode)
    os.makedirs = guard(os.makedirs, lambda a: a[0])
    shutil.copyfile = guard(shutil.copyfile, lambda a: a[1])
    torch.save = lambda obj, f, *a, **kw: (_ for _ in ()).throw(
        PermissionError(f"a rank other than 0 saved {f}"))


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
