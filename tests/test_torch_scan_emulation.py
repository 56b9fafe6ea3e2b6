"""The Mamba1 selective scan emulated on the CPU as
``test_torch_kernel_emulation`` runs it (its fixtures: g++ against the
stand-in CUDA headers, a block's threads as ``std::thread``s), held
against the plain version: 1, 2 and 4 lanes a channel over ragged tiles,
and the plain-load path for misaligned rows.  The cases and helpers are
``test_torch_stream_scan_emulation.py``'s.

This section was ``test_torch_stream_scan_emulation.py``'s; it lives in
a file of its own so that ``--dist loadfile`` gives it a worker of its
own.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssm_scan import scan
from repro_torch.models.ssm import mamba1_scan

from test_torch_kernel_emulation import (  # noqa: F401  (fixtures)
    _one_thread, cuda_path_on_cpu, emulated)
from test_torch_stream_scan_emulation import (
    SCAN_CASES, SCAN_LANE_CASES, SCAN_TOL, _check_scan, _scan_inputs)


@pytest.mark.parametrize("case", SCAN_LANE_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_selective_scan_lanes_and_tiles(case, cuda_path_on_cpu,
                                                monkeypatch):
    """Each channel's state split over 1, 2 and 4 lanes, y's sum over them
    by __shfl_xor_sync; S not a multiple of the tile and d_in not a
    multiple of the block; x and dt tiles by 16-byte cp.async or plain
    loads; strided and contiguous B/C; the same tolerances."""
    B, S, d_in, N, dtype, lanes, vec = case
    monkeypatch.setattr(scan, "LANES", lanes)
    x, dt, A, Bc, Cc = _scan_inputs(np.random.default_rng(S + d_in), B, S,
                                    d_in, N, dtype)
    assert scan.copies_16_bytes(x, dt) == vec
    assert _check_scan(x, dt, A, Bc, Cc) == 2


def test_emulated_selective_scan_misaligned_rows_take_plain_loads(
        cuda_path_on_cpu, monkeypatch):
    """x 4 bytes past a 16-byte boundary: its tiles cannot be copied 16
    bytes at a time, so the kernel reads them with plain loads and gives
    the same result; a lane count the kernel is not built for is refused
    by the C entry, and nothing launches."""
    x, dt, A, Bc, Cc = _scan_inputs(np.random.default_rng(6), 2, 40, 64, 16,
                                    torch.float32)
    shifted = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    shifted.copy_(x)
    assert scan.copies_16_bytes(x, dt) and \
        not scan.copies_16_bytes(shifted, dt)
    assert _check_scan(shifted, dt, A, Bc, Cc) == 2
    monkeypatch.setattr(scan, "LANES", 3)
    n0 = scan.KERNEL.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        scan.selective_scan(x, dt, A, Bc, Cc)
    assert scan.KERNEL.launches == n0


@pytest.mark.parametrize("case", SCAN_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_emulated_selective_scan_matches_plain(case, cuda_path_on_cpu):
    """B and C as strided column slices of one (B, S, 4 + 2N) tensor, as
    the model passes them, and once made contiguous."""
    B, S, d_in, N, dtype = case
    rng = np.random.default_rng(S + d_in + N)
    x = torch.from_numpy(rng.standard_normal((B, S, d_in), np.float32))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, d_in), np.float32)) * 0.5 - 1.0)
    A = -torch.exp(torch.from_numpy(rng.standard_normal((d_in, N),
                                                        np.float32)) * 0.3)
    dbc = torch.from_numpy(rng.standard_normal((B, S, 4 + 2 * N),
                                               np.float32)).to(dtype)
    x, dt = x.to(dtype), dt.to(dtype)
    Bc, Cc = dbc[..., 4:4 + N], dbc[..., 4 + N:]
    rtol, atol = SCAN_TOL[dtype]
    n0 = scan.KERNEL.launches
    want_y, want_h = mamba1_scan(x, dt, A, Bc, Cc)
    for b, c in ((Bc, Cc), (Bc.contiguous(), Cc.contiguous())):
        y, h = scan.selective_scan(x, dt, A, b, c)
        assert y.dtype == dtype and h.dtype == torch.float32
        torch.testing.assert_close(y.float(), want_y.float(), rtol=rtol,
                                   atol=atol)
        torch.testing.assert_close(h, want_h, rtol=2e-5, atol=2e-5)
    assert scan.KERNEL.launches == n0 + 2
