"""The encode VJP's non-finite pattern, K5 bwd's function on the CPU: the
port's plain path (autograd of ``offset_codec.joint2offset_plain``, which
``EncodeFn``'s kernel follows on the card) against JAX's jnp path
(``joint2offset`` under ``jax.vjp``, the path dsf_tpu takes on the CPU),
and against ``encode_pallas`` (its Pallas VJP in interpret mode), whose
0/1 row-map matmuls spread a non-finite cotangent to every joint of its
image: a recorded difference of the JAX package, which the port does not
copy.  Small shapes: B=2, J=21, S=16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from dsf_tpu.ops import offset_codec as JO
from dsf_tpu_torch.ops import offset_codec as TO

torch.set_num_threads(2)

B, J, S, K = 2, 21, 16, 0.8
NAN_ROW, INF_ROW = (0, 5), (1, 9)       # (image, joint)


@pytest.fixture()
def interpret_codec(monkeypatch):
    import dsf_tpu.ops.pallas_codec as PC
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(PC.pl, "pallas_call", patched)


def _case(bad=True):
    """Seeded joints, depth (some background) and cotangent; with ``bad``,
    a NaN in image 0's joint-5 x unit row at a pixel outside joint 5's
    cone and a +inf in image 1's joint-9 heat row at a foreground pixel
    inside joint 9's cone.  Returns the arrays and the two pixels."""
    rng = np.random.RandomState(4)
    joint = rng.uniform(-0.6, 0.6, (B, J, 3)).astype(np.float32)
    depth = rng.uniform(-1, 1.05, (B, 1, S, S)).astype(np.float32)
    g = rng.randn(B, 4 * J, S, S).astype(np.float32)
    r = (np.arange(S) + 0.5) / S * 2 - 1

    def dist(b, j):
        return np.sqrt((joint[b, j, 0] - r[None, :]) ** 2
                       + (joint[b, j, 1] - r[:, None]) ** 2
                       + (joint[b, j, 2] - depth[b, 0]) ** 2)
    out = tuple(np.argwhere(dist(*NAN_ROW) > K)[0])
    inside = tuple(np.argwhere((dist(*INF_ROW) < K)
                               & (depth[INF_ROW[0], 0] < 0.99))[0])
    if bad:
        g[NAN_ROW[0], 3 * NAN_ROW[1], out[0], out[1]] = np.nan
        g[INF_ROW[0], 3 * J + INF_ROW[1], inside[0], inside[1]] = np.inf
    return joint, depth, g, out, inside


def _port(joint, depth, g):
    j, d = (torch.from_numpy(a).requires_grad_(True) for a in (joint, depth))
    dj, dd = torch.autograd.grad(TO.joint2offset_plain(j, d, K), (j, d),
                                 torch.from_numpy(g))
    return dj.numpy(), dd.numpy()


def _jax(fn, joint, depth, g):
    _, pull = jax.vjp(fn, jnp.asarray(joint), jnp.asarray(depth))
    return tuple(np.asarray(a) for a in pull(jnp.asarray(g)))


def _jnp(joint, depth, g):
    return _jax(lambda j, d: JO.joint2offset(j, d, K, S), joint, depth, g)


def _pallas(joint, depth, g):
    from dsf_tpu.ops.pallas_codec import encode_pallas
    return _jax(lambda j, d: encode_pallas(j, d, K), joint, depth, g)


def test_encode_vjp_nonfinite_pattern_matches_jnp():
    """The same (image, joint) rows of d joint and the same pixels of
    d depth are non-finite in the port's plain VJP and JAX's jnp VJP:
    exactly the NaN's joint and pixel and the inf's, element by element;
    the finite entries agree within 1e-5 of the largest."""
    joint, depth, g, out, inside = _case()
    pj, pd = _port(joint, depth, g)
    jj, jd = _jnp(joint, depth, g)
    for a, b in ((pj, jj), (pd, jd)):
        assert np.array_equal(np.isfinite(a), np.isfinite(b))
        m = np.isfinite(b)
        assert np.abs(a[m] - b[m]).max() <= 1e-5 * np.abs(b[m]).max()
    rows = {tuple(x) for x in np.argwhere(~np.isfinite(pj).all(-1))}
    assert rows == {NAN_ROW, INF_ROW}
    pix = {tuple(x) for x in np.argwhere(~np.isfinite(pd[:, 0]))}
    assert pix == {(NAN_ROW[0],) + out, (INF_ROW[0],) + inside}


def test_encode_pallas_spreads_nonfinite_to_every_joint(interpret_codec):
    """Documented difference: ``encode_pallas``'s VJP (interpret mode)
    multiplies the non-finite cotangent by the 0 entries of its row maps,
    so every joint of both images gets a non-finite d joint, where the jnp
    path and the port have only the two rows; its d depth is non-finite at
    the same two pixels, and on a finite cotangent it agrees with jnp."""
    joint, depth, g, out, inside = _case()
    kj, kd = _pallas(joint, depth, g)
    assert (~np.isfinite(kj).all(-1)).all()
    jj, jd = _jnp(joint, depth, g)
    assert (~np.isfinite(jj).all(-1)).sum() == 2
    assert np.array_equal(np.isfinite(kd), np.isfinite(jd))
    joint, depth, g, _, _ = _case(bad=False)
    kj, kd = _pallas(joint, depth, g)
    jj, jd = _jnp(joint, depth, g)
    for a, b in ((kj, jj), (kd, jd)):
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
