"""Worlds of gloo ranks on the CPU for the port's multi-GPU tests
(tests/test_torch_parallel.py, tests/test_torch_parallel_steps.py).

``run_world(name, world, args, out_dir, timeout)`` starts ``world``
processes (``python -m torch_parallel_workers``), each with the
environment ``torchrun`` would set, a free port and two threads that
sleep when idle (``OMP_WAIT_POLICY=PASSIVE``: spinning ranks starve the
other test workers); each joins the group through
``parallel.distributed.initialize("cpu")`` and runs the worker ``name``
of this module on ``args``.  Every rank's return value comes back in
rank order.  The world has a time limit of its own (there is no
pytest-timeout): past it every rank is killed and the call raises; a
rank that fails kills the others at once.  ``World(...)`` starts the
same world and returns (``.wait()`` for the values).  A worker called in
the test's own process (no environment) is world 1 and joins nothing.

This module imports torch, numpy and the port only: the ranks start
without JAX.
"""

from __future__ import annotations

import builtins
import hashlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import time
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
    return World(name, world, args, out_dir, timeout).wait()


class World:
    """``run_world`` started: the ranks run while the caller works;
    ``wait()`` returns their values.  Each rank's output goes to
    ``out_dir/rank{r}.log`` (a pipe left unread would stall a rank that
    writes more than its buffer).  The world has one deadline,
    ``timeout`` seconds from its start, and a rank that fails ends the
    world at once (the others would wait in a collective)."""

    def __init__(self, name, world, args, out_dir, timeout=240):
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        self.name, self.world, self.out_dir = name, world, out_dir
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        port = free_port()
        self.procs, self.logs = [], []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                       OMP_WAIT_POLICY="PASSIVE",
                       PYTHONPATH=os.pathsep.join([REPO, HERE]))
            log = os.path.join(out_dir, f"rank{r}.log")
            self.logs.append(log)
            with open(log, "wb") as out:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "torch_parallel_workers", name,
                     out_dir], cwd=HERE, env=env, stdout=out,
                    stderr=subprocess.STDOUT))

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def wait(self):
        while True:
            codes = [p.poll() for p in self.procs]
            if all(c is not None for c in codes) or any(codes):
                break
            if time.monotonic() > self.deadline:
                self._kill()
                raise TimeoutError(f"world of {self.world} running "
                                   f"{self.name} passed its {self.timeout} "
                                   "s limit")
            time.sleep(0.2)
        self._kill()
        bad = [(r, p.returncode) for r, p in enumerate(self.procs)
               if p.returncode]
        if bad:
            logs = [open(log, errors="replace").read()[-3000:]
                    for log in self.logs]
            raise RuntimeError(f"{self.name}: ranks {bad} failed:\n"
                               + "\n".join(logs))
        out = []
        for r in range(self.world):
            path = os.path.join(self.out_dir, f"rank{r}.pkl")
            with open(path, "rb") as f:
                out.append(pickle.load(f))
            os.remove(path)             # a step world's records take GBs
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
    """The guarded AdamW over a world (``n_fsdp`` from ``case``; above 1
    the parameters sharded as one unit): steps with this rank's gradients
    (``case["grads"][step][rank]``), one of them NaN on rank 0 only.
    Returns per step the decision and the whole parameters, then the
    whole state dict and a reload of it."""
    from dsf_tpu_torch.config import Config
    from dsf_tpu_torch.parallel import distributed, fsdp
    from dsf_tpu_torch.parallel import mesh as M
    from dsf_tpu_torch.training.trainer import make_optimizer
    mesh = M.make_mesh(case["n_fsdp"])
    module = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in case["w"]])
    params = list(module)
    # n_fsdp > 1: the parameters sharded too, the list one unit
    held = (fsdp.shard(module, mesh, "cpu") if mesh.n_fsdp > 1
            else params)
    opt = make_optimizer(Config(), held, 10, mesh)
    rank = distributed.rank()
    out = []
    for per_rank in case["grads"]:
        for p, g in zip(params, per_rank[rank]):
            p.grad = torch.from_numpy(g.copy())
        accept = opt.step()
        sd = fsdp.state_dict(module)
        out.append((bool(accept), [sd[str(i)].numpy() for i in
                                   range(len(params))],
                    int(opt.count), int(opt.notfinite_count)))
    sd = opt.state_dict()
    opt2 = make_optimizer(Config(), held, 10, mesh)
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
    """Each run of ``case["runs"]`` on this rank's stripe of the global
    batch, from the trainers' seeded weights and draws (``step_run``):
    label, phase, Config keywords, whether BatchNorm keeps per-rank
    statistics (a mutation the tests must catch), and optionally
    ``step_run``'s keywords (``n_fsdp``, ``remat``, ``steps``, ...).  The
    labels in ``case["remat"]`` run again with DSF_REMAT=1
    (``{label}_remat``)."""
    runs = list(case["runs"])
    runs += [(f"{label}_remat", phase, kw, local_bn, dict(*opt, remat=True))
             for label, phase, kw, local_bn, *opt in case["runs"]
             if label in case.get("remat", ())]
    out = {}
    for label, phase, kw, local_bn, *opt in runs:
        out[label] = step_run(case["mano"], phase, kw, local_bn, **dict(*opt))
    return out


def digest(a) -> str:
    """A float32 array's shape and bytes, hashed: bitwise equality of
    large arrays without carrying them between processes."""
    a = np.ascontiguousarray(a, np.float32)
    return f"{a.shape}:{hashlib.sha1(a.tobytes()).hexdigest()}"


def _ranks_mean(g):
    """The ranks' mean of a flat float32 array, summed in rank order on
    the host (the world's own mean at world 1)."""
    from dsf_tpu_torch.parallel import distributed
    world = distributed.world()
    if world == 1:
        return g
    parts = [torch.empty_like(g) for _ in range(world)]
    torch.distributed.all_gather(parts, g)
    total = parts[0].numpy().copy()
    for p in parts[1:]:
        total += p.numpy()
    return total / np.float32(world)


def step_run(mano, phase, kw, local_bn=False, n_fsdp=1, remat=False,
             steps=1, seed=1, skip=0, load=None, save=None, evaluate=False,
             digests=False):
    """``steps`` steps of ``phase`` (after drawing and dropping the inputs
    of ``skip`` steps, so a resumed run sees the uninterrupted run's
    next inputs), with ``n_fsdp`` ranks sharing the parameters (ZeRO-3)
    and DSF_REMAT from ``remat``; the synth parameters from ``seed``, the
    real batch from ``seed + 1``.  ``load``: a checkpoint restored before
    the steps; ``save``: the checkpoint directory written after the
    first step; ``evaluate``: the eval step on this rank's rows of a
    seeded real batch at the end.  Returns the last step's metrics
    averaged over the ranks, this rank's flat gradient (``grad``; under
    ZeRO-3 ``mean_grad``, the ranks' mean the optimizer read), the
    running statistics, the whole parameters, moments and guard counters
    after it, every step's loss, each rank's parameter storage bytes
    before the steps and after each, the most units held whole at once,
    and under ZeRO-3 what ``net.state_dict()`` raised.  ``digests``: the
    parameters, moments, statistics and the mean gradient (a data-parallel
    run's: the ranks' own gathered and averaged on the host) as
    ``digest``s, and no per-rank gradient."""
    from dsf_tpu_torch import demo
    from dsf_tpu_torch.data.synth_params import random_param_source
    from dsf_tpu_torch.parallel import fsdp
    from dsf_tpu_torch.training import checkpoints as ckpt
    os.environ["DSF_REMAT"] = "1" if remat else "0"
    try:
        tr = _trainer(kw, mano, n_fsdp)
        B = kw["batch_size"]
        state = tr.init_state()
        if local_bn:
            state.net.sync = None
        if load:
            state, _ = ckpt.restore(load, tr, state)
        net, opt = state.net, state.optimizer
        src = random_param_source(B, seed=seed)
        rng = np.random.RandomState(seed + 1)
        rec = dict(loss=[], bytes=[fsdp.param_bytes(net)])
        metrics = {}
        for k in range(skip + steps):
            batch = dict(zip(("model_para", "cube_synth"), next(src)))
            if phase != "Pretrain":
                batch.update(demo.real_batch(tr.renderer, B, rng))
            batch = {key: tr.mesh.stripe(v) for key, v in batch.items()}
            draws = tr.draw(B, phase)
            if k < skip:
                continue
            state, metrics = tr.train_step_fn(phase)(state, draws, batch)
            metrics = {key: float(v) for key, v in
                       tr.global_metrics(metrics).items()}
            rec["loss"].append(metrics["loss"])
            rec["bytes"].append(fsdp.param_bytes(net))
            if save and k == skip:
                ckpt.save(save, tr, state, 0)
                ckpt.wait_until_finished()
        sd = fsdp.state_dict(net)
        sharded = fsdp.sharded(net)
        big = digest if digests else (lambda a: a)
        rec.update(
            metrics=metrics,
            stats={n: big(_np(b)) for n, b in net.named_buffers()
                   if "running" in n},
            params=big(np.concatenate([sd[n].numpy().ravel()
                                       for n, _ in net.named_parameters()])),
            moments={key: big(_np(v)) for key, v in opt.state_dict().items()
                     if torch.is_tensor(v) and v.dim() == 1},
            counters={key: int(getattr(opt, key)) for key in opt.COUNTERS})
        if sharded is not None:
            if steps:
                rec["mean_grad"] = big(_np(sharded.whole_flat(sharded.grad)))
            rec["peak_held"] = sharded.peak_held
            rec["raised"] = []
            for call in (net.state_dict, lambda: net.load_state_dict(sd)):
                try:
                    call()
                except RuntimeError as e:
                    rec["raised"].append(str(e))
        elif steps:
            grad = torch.cat([p.grad.reshape(-1) for p in net.parameters()])
            if digests:
                rec["mean_grad"] = digest(_ranks_mean(grad.float()))
            else:
                rec["grad"] = _np(grad)
        if evaluate:
            real = demo.real_batch(tr.renderer, B, np.random.RandomState(9))
            errors, results = tr.eval_step_fn()(
                state, {key: tr.mesh.stripe(v) for key, v in real.items()})
            rec["eval"] = dict(errors=_np(errors),
                               **{key: _np(v) for key, v in results.items()})
        return rec
    finally:
        os.environ.pop("DSF_REMAT", None)


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
