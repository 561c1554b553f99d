"""Kernels A and B (ops/spmv): the port's plain path against the JAX
package in float64 (the CUDA kernels are held against the plain path in
tests/test_torch_cuda.py).  Blocks and vectors are random (numpy seed) on
the neighbour table of box_3d_axons(0, length_factor=1)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_parity import emix_mesh_torch, rel, t64

from knpemidg_tpu.ops import spmv as jspmv
from knpemidg_tpu_torch import _cuda
from knpemidg_tpu_torch.fem.tabulation import build_geometry
from knpemidg_tpu_torch.ops import spmv

TOL = 1e-12      # f64 round-off of a 20-term sum in another order


@pytest.fixture(scope="module")
def nbr():
    geom = build_geometry(emix_mesh_torch(), 2, 2)
    return geom.to_device(device="cpu")["nbr"]                   # (K, nc) int32


@pytest.mark.parametrize("m", [None, 2])
def test_bell_matvec_matches_jax(nbr, m):
    rng = np.random.default_rng(1)
    K, nc = nbr.shape
    shape = (K, 4, 4, nc) if m is None else (m, K, 4, 4, nc)
    B = rng.standard_normal(shape)
    x = rng.standard_normal(shape[:-4] + (4, nc))
    if m is None:
        ref = jspmv.bell_matvec(jnp.asarray(B), jnp.asarray(nbr.numpy()), jnp.asarray(x))
        got = spmv.bell_matvec(t64(B), nbr, t64(x))
    else:
        ref = jspmv.bell_matvec_multi(jnp.asarray(B), jnp.asarray(nbr.numpy()),
                                      jnp.asarray(x))
        got = spmv.bell_matvec_multi(t64(B), nbr, t64(x))
    assert rel(got, ref) < TOL


def test_bell_matvec_fan_matches_jax(nbr):
    rng = np.random.default_rng(2)
    K, nc = nbr.shape
    B = rng.standard_normal((K, 4, 4, nc))
    X = rng.standard_normal((5, 4, nc))
    ref = jspmv.bell_matvec_fan(jnp.asarray(B), jnp.asarray(nbr.numpy()), jnp.asarray(X))
    assert rel(spmv.bell_matvec_fan(t64(B), nbr, t64(X)), ref) < TOL


@pytest.mark.parametrize("m", [None, 2])
def test_block_jacobi_matches_jax(m):
    rng = np.random.default_rng(3)
    nc = 500
    lead = () if m is None else (m,)
    P = rng.standard_normal(lead + (4, 4, 1, nc)).squeeze(-2) * 0.3
    P = P + 4.0 * np.eye(4)[..., None]
    r = rng.standard_normal(lead + (4, nc))
    inv_j = (jspmv.block_jacobi_inverse(jnp.asarray(P)) if m is None else
             jnp.stack([jspmv.block_jacobi_inverse(jnp.asarray(P[s])) for s in range(m)]))
    inv_t = spmv.block_jacobi_inverse(t64(P))
    assert rel(inv_t, inv_j) < TOL
    app_j = (jspmv.block_jacobi_apply(inv_j, jnp.asarray(r)) if m is None else
             jnp.einsum("mijc,mjc->mic", inv_j, jnp.asarray(r)))
    assert rel(spmv.block_jacobi_apply(inv_t, t64(r)), app_j) < TOL


def test_cpu_wrappers_run_plain_without_launching(nbr):
    """On CPU tensors every wrapper is its plain version and no kernel
    launch is counted."""
    rng = np.random.default_rng(4)
    K, nc = nbr.shape
    B = t64(rng.standard_normal((2, K, 4, 4, nc)))
    x = t64(rng.standard_normal((2, 4, nc)))
    before = dict(_cuda.LAUNCHES)
    assert torch.equal(spmv.bell_matvec_multi(B, nbr, x),
                       spmv.bell_matvec_multi_plain(B, nbr, x))
    assert torch.equal(spmv.bell_matvec(B[0], nbr, x[0]),
                       spmv.bell_matvec_plain(B[0], nbr, x[0]))
    P = B[:, 0]
    assert torch.equal(spmv.block_jacobi_inverse(P), spmv.block_jacobi_inverse_plain(P))
    assert torch.equal(spmv.block_jacobi_apply(P, x), spmv.block_jacobi_apply_plain(P, x))
    assert _cuda.LAUNCHES == before


@pytest.fixture(scope="module")
def nbr_2d():
    from test_torch_parity import _neuron_2d

    return _neuron_2d("torch").g["nbr"]                          # (4, nc): K = 4


@pytest.mark.parametrize("m", [None, 2])
def test_bell_matvec_2d_matches_jax(nbr_2d, m):
    """The 2D operator (K = 4 slots of nd = 3 blocks, for which the CUDA
    kernel has its own instantiation beside the 3D K = 5, nd = 4 one) runs
    its plain version on the CPU and matches the JAX package."""
    rng = np.random.default_rng(11)
    K, nc = nbr_2d.shape
    lead = () if m is None else (m,)
    B = rng.standard_normal(lead + (K, 3, 3, nc))
    x = rng.standard_normal(lead + (3, nc))
    nb = jnp.asarray(nbr_2d.numpy())
    if m is None:
        ref = jspmv.bell_matvec(jnp.asarray(B), nb, jnp.asarray(x))
        got = spmv.bell_matvec(t64(B), nbr_2d, t64(x))
    else:
        ref = jspmv.bell_matvec_multi(jnp.asarray(B), nb, jnp.asarray(x))
        got = spmv.bell_matvec_multi(t64(B), nbr_2d, t64(x))
    assert K == 4 and K == spmv.MATVEC_BUILT[3] != spmv.MATVEC_BUILT[4]
    assert rel(got, ref) < TOL


def _halves_case(rng, m, nc=613):
    """A halves-masked 8 x 8 inverse (the pair layout's pair_bj = 'halves')
    and r, (m,) leading: random blocks, zero off the two 4 x 4 diagonal
    sub-blocks."""
    lead = () if m is None else (m,)
    mask = np.kron(np.eye(2), np.ones((4, 4)))[:, :, None]
    return (rng.standard_normal(lead + (8, 8, nc)) * mask,
            rng.standard_normal(lead + (8, nc)))


@pytest.mark.parametrize("m", [None, 2])
def test_block_jacobi_halves_matches_jax(m):
    """The halves form (the two diagonal sub-blocks only) against the JAX
    package's full apply on a halves-masked inverse, to round-off, and equal
    to the port's own full form on it; through the operands, with and
    without the output buffer."""
    rng = np.random.default_rng(13)
    P, r = _halves_case(rng, m)
    ref = (jspmv.block_jacobi_apply(jnp.asarray(P), jnp.asarray(r)) if m is None else
           jnp.stack([jspmv.block_jacobi_apply(jnp.asarray(P[s]), jnp.asarray(r[s]))
                      for s in range(m)]))
    Pt, rt = t64(P), t64(r)
    got = spmv.block_jacobi_apply_plain(Pt, rt, halves=True)
    assert got.shape == rt.shape and got.is_contiguous()
    assert rel(got, ref) < 1e-14
    assert torch.equal(got, spmv.block_jacobi_apply_plain(Pt, rt))
    for buffer in (False, True):
        op = spmv.block_jacobi_operands(Pt, halves=True, buffer=buffer)
        z = spmv.block_jacobi_apply(op, rt)
        assert torch.equal(z, got)
        assert (z is op.buf) == buffer


def test_block_jacobi_halves_takes_pair_blocks_only():
    """The halves form is the pair layout's: 8 x 8 blocks (3D) and 6 x 6
    (2D) on the CPU; cell blocks (nd = 4) and odd sizes raise."""
    rng = np.random.default_rng(14)
    P6 = t64(rng.standard_normal((6, 6, 50)) * np.kron(np.eye(2), np.ones((3, 3)))[:, :, None])
    r6 = t64(rng.standard_normal((6, 50)))
    assert torch.equal(spmv.block_jacobi_apply(spmv.block_jacobi_operands(P6, halves=True), r6),
                       spmv.block_jacobi_apply_plain(P6, r6))
    for nd in (4, 5):
        with pytest.raises(ValueError):
            spmv.block_jacobi_operands(t64(rng.standard_normal((nd, nd, 50))), halves=True)
    with pytest.raises(ValueError):
        spmv.block_jacobi_operands(t64(rng.standard_normal((8, 4, 50))))


@pytest.mark.parametrize("m", [None, 2])
def test_block_jacobi_halves_inverse_matches_jax(m):
    """The halves inverse (the pair layout's pair_bj = 'halves') of the
    unmasked 8 x 8 pair diagonal against the JAX package's inverse of the
    masked diagonal: each half equal (==, so the sign of an exact zero
    aside), the off-diagonal blocks exactly +0; the same into a zeroed
    buffer, and from the masked diagonal."""
    rng = np.random.default_rng(15)
    nc = 613
    lead = () if m is None else (m,)
    P = rng.standard_normal(lead + (8, 8, nc)) * 0.3 + 4.0 * np.eye(8)[..., None]
    mask = np.kron(np.eye(2), np.ones((4, 4)))[..., None]
    ref = (jspmv.block_jacobi_inverse(jnp.asarray(P * mask)) if m is None else
           jnp.stack([jspmv.block_jacobi_inverse(jnp.asarray(P[s] * mask)) for s in range(m)]))
    ref = np.asarray(ref)
    got = spmv.block_jacobi_inverse(t64(P), halves=True)
    assert got.shape == P.shape
    for h in (slice(0, 4), slice(4, 8)):
        assert (got[..., h, h, :].numpy() == ref[..., h, h, :]).all()
    for a, b in ((slice(0, 4), slice(4, 8)), (slice(4, 8), slice(0, 4))):
        cross = got[..., a, b, :]
        assert (cross == 0).all() and not torch.signbit(cross).any()
    out = torch.zeros_like(got)
    assert spmv.block_jacobi_inverse(t64(P), halves=True, out=out) is out
    assert torch.equal(out, got)
    assert torch.equal(spmv.block_jacobi_inverse(t64(P * mask), halves=True), got)
    assert torch.equal(spmv.block_jacobi_inverse_plain(t64(P), halves=True), got)


@pytest.mark.parametrize("m", [1, 2])
def test_block_jacobi_inverse_reads_the_slot0_view(m):
    """The inverse of slot 0 of an (m, 5, 4, 4, nc) operator, read as a
    view (for m > 1 not contiguous: its systems lie 5 blocks apart), against the JAX
    package on blocks[:, 0]; into a buffer too."""
    rng = np.random.default_rng(16)
    nc = 500
    B = rng.standard_normal((m, 5, 4, 4, nc)) * 0.3
    B[:, 0] += 4.0 * np.eye(4)[..., None]
    ref = jnp.stack([jspmv.block_jacobi_inverse(jnp.asarray(B[s, 0])) for s in range(m)])
    view = t64(B)[:, 0]
    assert view.stride()[-3:] == (4 * nc, nc, 1) and view.is_contiguous() == (m == 1)
    got = spmv.block_jacobi_inverse(view)
    assert got.is_contiguous() and rel(got, ref) < TOL
    out = torch.empty_like(got)
    assert spmv.block_jacobi_inverse(view, out=out) is out and torch.equal(out, got)


def test_block_jacobi_inverse_halves_takes_pair_blocks_only():
    """The halves inverse takes pair blocks (8 x 8, and 6 x 6 on the CPU);
    cell blocks raise."""
    rng = np.random.default_rng(17)
    P6 = rng.standard_normal((6, 6, 40)) * 0.3 + 4.0 * np.eye(6)[..., None]
    mask6 = np.kron(np.eye(2), np.ones((3, 3)))[..., None]
    assert torch.equal(spmv.block_jacobi_inverse(t64(P6), halves=True),
                       spmv.block_jacobi_inverse(t64(P6 * mask6)) * t64(mask6))
    with pytest.raises(ValueError):
        spmv.block_jacobi_inverse(t64(rng.standard_normal((4, 4, 40))), halves=True)
