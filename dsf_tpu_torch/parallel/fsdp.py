"""ZeRO-3: the parameters sharded over a mesh's fsdp ranks, as well as the
optimizer state (counterpart of the JAX package's ``param_spec`` /
``state_shardings`` / ``place_state``, dsf_tpu/parallel/mesh.py, and of
its step's gradient shardings, dsf_tpu/training/trainer.py).

``shard(net, mesh, device)`` cuts the net into units (``net.fsdp_units()``,
e.g. ``ManoOCRStage``'s stem, each ResNet block, each head and the
fusion; the whole net when it has none).  Each unit keeps one flat
float32 piece of its parameters on this rank: 1/``mesh.n_fsdp`` of the
unit's flat vector (the parameters in order, zero-padded to a multiple of
``n_fsdp``).  The pieces of all units lie in one flat tensor
(``Sharded.piece``), which the guarded optimizer updates in place; its
moments have the same layout.  Between steps a rank holds the pieces
alone: every parameter is a view of its unit's whole buffer, whose
storage is resized to 0 at rest.

* Before a unit's forward its pieces are all-gathered within
  ``mesh.fsdp_group`` into that buffer (in place, so the tensors autograd
  saved for the backward pass see it), and after the forward the storage
  is freed.
* A hook on the unit's output gathers it again just before its backward
  (a pre-hook of the output's grad_fn).  When autograd has accumulated
  the gradient of every parameter of the unit, the unit's flat gradient
  is reduce-scattered within ``fsdp_group``, all-reduced across
  ``data_group`` and divided by the world (the ranks' mean, in
  ``Sharded.grad``), and the whole gradient and parameters are freed.
* A checkpointed recompute (``DSF_REMAT``) runs the forward hooks again:
  a unit held for its backward stays whole, the others gather and free.

So whole parameters exist only while their unit runs (in the backward
pass the engine may hold a second unit whose output gradient is ready).
The BatchNorm running statistics stay whole on every rank (every rank
updates them identically from the global statistics).

``state_dict(net)`` and ``load_state_dict(net, sd)`` read and write whole
state dicts (world 1's) for a sharded net or a plain one;
``net.state_dict()`` and ``net.load_state_dict()`` of a sharded net raise
(its parameters' storage is freed between the units' gathers).
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from dsf_tpu_torch.parallel.mesh import Mesh


class _Unit:
    """One unit: its module and parameters, its piece's place in
    ``Sharded.piece`` (``offset``, ``n``) and its whole buffer."""

    def __init__(self, module, params, offset, n, whole):
        self.module = module
        self.params = params
        self.numel = sum(p.numel() for p in params)
        self.offset, self.n = offset, n
        self.whole = whole
        self.held = None            # None, "forward" or "backward"
        self.pending = len(params)  # gradients still to accumulate

    @property
    def piece(self):
        return slice(self.offset, self.offset + self.n)


class Sharded:
    """A net's parameters sharded over ``mesh``'s fsdp ranks (``shard``).

    ``piece`` holds this rank's pieces of every unit's flat parameters and
    ``grad`` the ranks' mean gradient of them after a backward pass (each
    unit's piece written when its gradients are complete; ``finish``
    reduces the units autograd did not reach, with zero gradients; None
    from ``zero_grad`` to the first unit's reduction).  A
    step takes one backward pass: ``zero_grad`` before it, ``finish``
    after.  ``peak_held`` is the most units held whole at once."""

    def __init__(self, net: nn.Module, mesh: Mesh, device, units):
        if mesh.n_fsdp < 2:
            raise ValueError(f"n_fsdp={mesh.n_fsdp}: nothing to shard")
        params = list(net.parameters())
        owned = [p for u in units for p in u.parameters()]
        if [id(p) for p in owned] != [id(p) for p in params]:
            raise ValueError("the units do not hold the net's parameters "
                             "once each, in the net's order")
        if any(p.dtype != torch.float32 for p in params):
            raise ValueError("ZeRO-3 shards float32 parameters")
        self.net, self.mesh = net, mesh
        self.params = params
        self.numel = sum(p.numel() for p in params)
        device = torch.device(device)
        for m in net.modules():
            for k, b in m._buffers.items():
                if b is not None:
                    m._buffers[k] = b.to(device)
        nf, r = mesh.n_fsdp, mesh.fsdp_rank
        pieces, self.units, offset = [], [], 0
        for module in units:
            ps = list(module.parameters())
            flat = torch.cat([p.detach().reshape(-1) for p in ps])
            n = -(-flat.numel() // nf)
            pieces.append(F.pad(flat, (0, n * nf - flat.numel()))
                          [r * n:(r + 1) * n])
            whole = torch.empty(n * nf, dtype=torch.float32, device=device)
            o = 0
            for p in ps:
                p.data = whole[o:o + p.numel()].view(p.shape)
                o += p.numel()
            whole.untyped_storage().resize_(0)
            self.units.append(_Unit(module, ps, offset, n, whole))
            offset += n
        self.piece = torch.cat(pieces).to(device)
        self.grad = None
        self.reduced = set()
        self.peak_held = 0
        self._open = False
        for i, u in enumerate(self.units):
            u.module.register_forward_pre_hook(
                functools.partial(self._pre_forward, u))
            u.module.register_forward_hook(
                functools.partial(self._post_forward, u))
            u.module.register_state_dict_pre_hook(self._closed)
            u.module.register_load_state_dict_pre_hook(self._closed)
            for p in u.params:
                p.register_post_accumulate_grad_hook(
                    functools.partial(self._grad_ready, i))

    # ------------------------------------------------------- gather / free

    @torch.no_grad()
    def _gather(self, u: _Unit, why: str) -> None:
        st = u.whole.untyped_storage()
        st.resize_(u.whole.numel() * u.whole.element_size())
        dist.all_gather_into_tensor(u.whole, self.piece[u.piece],
                                    group=self.mesh.fsdp_group)
        u.held = why
        self.peak_held = max(self.peak_held,
                             sum(v.held is not None for v in self.units))

    @staticmethod
    def _free(u: _Unit) -> None:
        u.whole.untyped_storage().resize_(0)
        u.held = None

    def _pre_forward(self, u, module, args):
        if u.held is None:
            self._gather(u, "forward")

    def _post_forward(self, u, module, args, out):
        if isinstance(out, torch.Tensor) and out.requires_grad:
            out.register_hook(functools.partial(self._pre_backward, u))
        if u.held == "forward":
            self._free(u)

    def _pre_backward(self, u, grad):
        if u.held is None:
            self._gather(u, "backward")

    # ---------------------------------------------------------- gradients

    def _grad_ready(self, i, p) -> None:
        u = self.units[i]
        u.pending -= 1
        if u.pending == 0:
            self._reduce(i)

    @torch.no_grad()
    def _reduce(self, i) -> None:
        """Unit i's flat gradient reduce-scattered into its piece of
        ``grad`` (the ranks' mean); then its whole gradient and
        parameters are freed."""
        u, mesh = self.units[i], self.mesh
        if i in self.reduced:
            raise RuntimeError("a second backward pass in one step: ZeRO-3 "
                               "reduces each unit's gradient once a step")
        flat = torch.cat([(p.grad if p.grad is not None
                           else torch.zeros(p.shape, device=u.whole.device))
                          .reshape(-1) for p in u.params])
        flat = F.pad(flat, (0, u.n * mesh.n_fsdp - flat.numel()))
        if self.grad is None:
            self.grad = torch.empty_like(self.piece)
        out = self.grad[u.piece]
        dist.reduce_scatter_tensor(out, flat, group=mesh.fsdp_group)
        if mesh.data_group is not None:
            dist.all_reduce(out, group=mesh.data_group)
        out.div_(mesh.world)
        for p in u.params:
            p.grad = None
        u.pending = len(u.params)
        self.reduced.add(i)
        if u.held is not None:
            self._free(u)

    def zero_grad(self) -> None:
        """Before a step's backward pass: no gradient held, none reduced;
        ``grad`` is let go until the first unit reduces."""
        for u in self.units:
            for p in u.params:
                p.grad = None
            u.pending = len(u.params)
        self.reduced = set()
        self.grad = None

    def finish(self):
        """After a step's backward pass: reduce the units it did not
        complete (their missing gradients zero, as the one-rank optimizer
        takes them) -> (``grad``, ``piece``)."""
        for i in range(len(self.units)):
            if i not in self.reduced:
                self._reduce(i)
        self.reduced = set()
        return self.grad, self.piece

    # ------------------------------------------------- whole flat buffers

    def whole_flat(self, piece: torch.Tensor) -> torch.Tensor:
        """The whole flat buffer over the parameters in order (``numel``
        elements) from every fsdp rank's ``piece`` of this layout (the
        moments, the parameters, the gradient); a collective."""
        nf = self.mesh.n_fsdp
        out = piece.new_empty(nf * piece.numel())
        dist.all_gather_into_tensor(out, piece.contiguous(),
                                    group=self.mesh.fsdp_group)
        out = out.view(nf, -1)
        return torch.cat([out[:, u.piece].reshape(-1)[:u.numel]
                          for u in self.units])

    def shard_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a whole flat buffer (``numel``), on its
        device."""
        if flat.numel() != self.numel:
            raise ValueError(f"{flat.numel()} elements for {self.numel}")
        nf, r = self.mesh.n_fsdp, self.mesh.fsdp_rank
        parts, o = [], 0
        for u in self.units:
            x = F.pad(flat[o:o + u.numel], (0, u.n * nf - u.numel))
            parts.append(x[r * u.n:(r + 1) * u.n])
            o += u.numel
        return torch.cat(parts).to(self.piece.device, torch.float32)

    # -------------------------------------------------------- state dicts

    def _closed(self, *args, **kw):
        if not self._open:
            raise RuntimeError(
                f"the net's parameters are sharded over n_fsdp="
                f"{self.mesh.n_fsdp} ranks: take its state dict with "
                "fsdp.state_dict(net) and load one with "
                "fsdp.load_state_dict(net, sd)")

    def _names(self):
        """The net's state-dict keys -> their tensors (no data read)."""
        self._open = True
        try:
            return self.net.state_dict(keep_vars=True)
        finally:
            self._open = False

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole state dict on the host, gathered unit by unit (a
        collective)."""
        name = {id(p): k for k, p in self.net.named_parameters()}
        host = {}
        for u in self.units:
            self._gather(u, "forward")
            for p in u.params:
                host[name[id(p)]] = p.detach().to("cpu", copy=True)
            self._free(u)
        return {k: host[k] if k in host else v.detach().to("cpu", copy=True)
                for k, v in self._names().items()}

    @torch.no_grad()
    def load_state_dict(self, sd: Mapping[str, torch.Tensor]) -> None:
        """Load a whole state dict (strict): each unit's piece is cut from
        it and the buffers copied; nothing is gathered."""
        own = self._names()
        missing, unexpected = set(own) - set(sd), set(sd) - set(own)
        shapes = [k for k, v in own.items()
                  if k in sd and tuple(sd[k].shape) != tuple(v.shape)]
        if missing or unexpected or shapes:
            raise RuntimeError(
                f"state dict mismatch: missing {sorted(missing)[:6]}, "
                f"unexpected {sorted(unexpected)[:6]}, of another shape "
                f"{shapes[:6]}")
        name = {id(p): k for k, p in self.net.named_parameters()}
        flat = torch.cat([torch.as_tensor(sd[name[id(p)]]).reshape(-1)
                          .to(torch.float32) for p in self.params])
        self.piece.copy_(self.shard_flat(flat))
        params = set(name.values())
        for k, v in own.items():
            if k not in params:
                v.copy_(torch.as_tensor(sd[k]))

    def resident_bytes(self) -> int:
        """The bytes of the parameters' storages on this rank: the pieces,
        plus any unit held whole."""
        return (self.piece.untyped_storage().nbytes()
                + sum(u.whole.untyped_storage().nbytes()
                      for u in self.units))


def shard(net: nn.Module, mesh: Mesh, device) -> Sharded:
    """Shard ``net``'s parameters (built on the host) over ``mesh``'s fsdp
    ranks onto ``device``, its buffers moved whole; the units are
    ``net.fsdp_units()``, or the whole net.  Returns the ``Sharded``,
    which ``sharded(net)`` finds again.  The host's whole parameters are
    let go: only the pieces reach the device."""
    units = net.fsdp_units() if hasattr(net, "fsdp_units") else [net]
    s = Sharded(net, mesh, device, list(units))
    net._sharded = s
    return s


def sharded(net: nn.Module) -> Optional[Sharded]:
    """The ``Sharded`` of a net ``shard`` cut, else None."""
    return getattr(net, "_sharded", None)


def state_dict(net: nn.Module) -> Dict[str, torch.Tensor]:
    """The net's whole state dict on the host, sharded or not (a
    collective for a sharded net: every fsdp rank must call it)."""
    s = sharded(net)
    if s is not None:
        return s.state_dict()
    return {k: v.detach().to("cpu", copy=True)
            for k, v in net.state_dict().items()}


def load_state_dict(net: nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """``net.load_state_dict(sd)`` (strict), or its pieces cut from ``sd``
    for a sharded net."""
    s = sharded(net)
    if s is not None:
        s.load_state_dict(sd)
    else:
        net.load_state_dict(sd)


def shapes(net: nn.Module) -> Dict[str, torch.Size]:
    """The net's state-dict keys and shapes, sharded or not."""
    s = sharded(net)
    sd = s._names() if s is not None else net.state_dict(keep_vars=True)
    return {k: v.shape for k, v in sd.items()}


def param_bytes(net: nn.Module) -> int:
    """The bytes of the parameters' storages on this rank: whole
    parameters for a plain net, the pieces (and any unit held whole) for
    a sharded one."""
    s = sharded(net)
    if s is not None:
        return s.resident_bytes()
    seen = {}
    for p in net.parameters():
        st = p.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())
