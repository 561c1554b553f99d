"""The gather probes P1/P2 (knpemidg_tpu_torch/probes.py): their plain
versions against the references of tools/profile_shapes.py (:83 and :112,
written inside its main(), so restated here in numpy), at the probe's
shapes and from its seeded generator, in both dtypes."""
import numpy as np
import pytest
import torch

from knpemidg_tpu_torch import _cuda, probes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_probes_match_the_probe_references(dtype):
    idx1, xsrc, idx2, xs2 = probes.make_inputs(0, dtype, "cpu")
    assert tuple(idx1.shape) == (4, 238, 512) and tuple(xsrc.shape) == (probes.NCP,)
    assert tuple(idx2.shape) == tuple(xs2.shape) == (8, probes.NCP)
    assert idx1.dtype == idx2.dtype == torch.int32
    n0 = dict(_cuda.LAUNCHES)
    got1 = probes.pgather(idx1, xsrc)
    got2 = probes.pgather2(idx2, xs2)
    assert _cuda.LAUNCHES == n0                      # plain on the CPU: no launch
    # profile_shapes.py:83 and :112
    ref1 = xsrc.numpy()[idx1.numpy().ravel()].reshape(idx1.shape)
    ref2 = np.take_along_axis(xs2.numpy(), idx2.numpy(), axis=1)
    assert got1.dtype == got2.dtype == dtype
    assert np.array_equal(got1.numpy(), ref1) and np.array_equal(got2.numpy(), ref2)


def test_probe_inputs_repeat_from_the_seed():
    a = probes.make_inputs(3, torch.float64, "cpu")
    b = probes.make_inputs(3, torch.float64, "cpu")
    c = probes.make_inputs(4, torch.float64, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])
