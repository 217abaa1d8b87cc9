"""The port's entry points (`tantivy_tpu_torch/entry.py`) against the
reference's (`__graft_entry__.py`): `entry(device="cpu")`'s forward on its
example arguments equals, bit for bit, the reference's forward under
`jax.jit` on the CPU, as `tests/test_graft_entry.py` runs it;
`dryrun_multichip(4, device="cpu")` passes its own checks against the host
engine; without CUDA, the default device raises instead of moving to the
CPU. The `cuda` case runs the forward and the dry run on the card."""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from tantivy_tpu_torch import entry as port_entry

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402

import zstd_stub  # noqa: E402


def _np(x):
    a = np.asarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.uint32) if a.dtype in (np.int32, np.uint32) else a


def test_forward_matches_the_reference_entry():
    fn, args = graft.entry()
    want = jax.jit(fn)(*args)
    pfn, pargs = port_entry.entry(device="cpu")
    assert len(pargs) == len(args)
    for a, b in zip(args, pargs):
        assert np.array_equal(_np(a), _np(b))
    got = pfn(*pargs)
    assert got[0].shape == (8, 10) and got[0].dtype == torch.float32
    assert np.array_equal(_np(got[0]).view(np.int32),
                          np.asarray(want[0]).view(np.int32))
    assert np.array_equal(_np(got[1]), _np(want[1]))
    assert np.isfinite(_np(got[0]).view(np.float32)[:, 0]).all()


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip_on_cpu(n, capsys):
    out = port_entry.dryrun_multichip(n, device="cpu")
    assert out["devices"] == ["cpu"] * n
    assert (out["term"], out["boolean"], out["phrase"]) == (8, 3, 3)
    assert f"{n} shards" in capsys.readouterr().out


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        port_entry.dryrun_multichip(2)


@pytest.mark.cuda
def test_entry_and_dryrun_on_cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tantivy_tpu_torch.ops import dense_flat

    zstd_stub.use(monkeypatch)
    fn, args = port_entry.entry()
    assert all(a.is_cuda for a in args)
    n0 = dense_flat.launches
    got = fn(*args)
    # K7's group and select kernels, once each
    assert dense_flat.launches == n0 + dense_flat.KERNELS_PER_CALL
    cfn, cargs = port_entry.entry(device="cpu")
    want = cfn(*cargs)
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1].cpu(), want[1])
    out = port_entry.dryrun_multichip(4)
    assert all(d.startswith("cuda") for d in out["devices"])
