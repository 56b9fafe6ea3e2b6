"""The port's byte and trip models (``kernels/trips.py`` and the
``trip_model`` beside each looped kernel's wrapper) against the JAX
package's own models: the scan's bytes against
``repro.kernels.ssm_scan.scan.analytic_hbm_bytes``, and the pages the
paged decode kernel's splits sweep against the pages the Pallas kernel's
grid admits (``grid_steps`` / ``padded_blocks`` and its ``pl.when`` skip
past ``kv_len``).  The trip models against the kernels themselves run in
``test_torch_kernel_emulation.py`` (``-k trip_model``).
"""
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import paged as jpaged
from repro.kernels.ssm_scan import scan as jscan
from repro_torch.kernels import trips
from repro_torch.kernels.decode_attention import decode, paged, prefill_paged
from repro_torch.kernels.flash_attention import flash
from repro_torch.kernels.ssm_scan import scan
from torch_one_thread import _one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("B,S,d_in,N", [(4, 454, 8192, 16), (2, 70, 128, 8),
                                        (1, 1, 40, 16), (3, 99, 200, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_bytes_match_the_jax_model(B, S, d_in, N, dtype):
    """x, dt, y, B, C in x's dtype, A and the final state in f32: the same
    tensors, each once, so the same count exactly."""
    e = torch.empty((), dtype=dtype).element_size()
    want = jscan.analytic_hbm_bytes(B, S, d_in, N, dtype_bytes=e)
    assert scan.hbm_bytes(B, S, d_in, N, dtype) == want
    (la,) = scan.trip_model(B, S, d_in, N, dtype)
    assert la.io_bytes == want and la.scratch_bytes == 0


def jax_admitted_pages(kv_len: int, page: int, NB: int, P: int) -> int:
    """Logical pages the Pallas kernel's grid runs its body on for one
    (slot, kv head): every (step j, page p) of ``grid_steps`` steps whose
    block j P + p passes ``bj * page < kv_len``."""
    return sum((j * P + p) * page < kv_len
               for j in range(jpaged.grid_steps(NB, P)) for p in range(P)
               if j * P + p < jpaged.padded_blocks(NB, P))


@pytest.mark.parametrize("B,KV,page,NB", [(4, 8, 16, 20), (6, 2, 4, 40),
                                          (2, 1, 1, 9), (3, 8, 16, 5)])
@pytest.mark.parametrize("P", [1, 2, 3])
def test_paged_decode_sweeps_the_pages_the_jax_grid_admits(B, KV, page, NB,
                                                           P):
    """The port's pieces, whole pages of [0, kv_len), are disjoint, cover
    the live positions, and sweep as many pages in all as the Pallas grid
    admits at any pages_per_step, at kv_len 0, mid-page and the full
    table."""
    rng = np.random.default_rng(B * NB + P)
    lens = rng.integers(0, NB * page + 1, size=B)
    lens[0], lens[-1] = 0, NB * page
    s0, s1 = paged.pieces(NB, B, KV, page, lens)
    for b, n in enumerate(lens):
        live = s1[b] > s0[b]
        assert (s0[b][live] % page == 0).all()
        covered = np.zeros(NB * page, dtype=int)
        for a, z in zip(s0[b][live], s1[b][live]):
            covered[a:z] += 1
        assert (covered[:n] == 1).all() and (covered[n:] == 0).all()
        swept = int(np.where(live, -(-s1[b] // page) - s0[b] // page,
                             0).sum())
        assert swept == jax_admitted_pages(int(n), page, NB, P)


def test_strided_trips_are_the_busiest_lane():
    """A warp runs a thread-strided loop as often as its lowest thread."""
    assert trips.strided(512, 128, 128).tolist() == [4, 4, 4, 4]
    assert trips.strided(32, 128, 128).tolist() == [1, 0, 0, 0]
    assert trips.strided(80, 64, 64).tolist() == [2, 1]
    assert trips.strided(0, 128, 128).tolist() == [0, 0, 0, 0]


def test_paged_decode_bytes_split_io_from_partials():
    """The split kernel reads q, the live K/V rows of every kv head, the
    live table entries and the lengths, and writes the partials; the
    combine reads them and writes out: the bound counts the I/O alone."""
    B, H, KV, D, page, NB = 4, 32, 8, 128, 16, 20
    lens = [96, 200, 316, 80]
    split, comb = paged.trip_model(B, H, KV, D, page, NB, lens,
                                   torch.bfloat16, torch.bfloat16)
    rows = sum(lens) * KV
    pages = sum(-(-n // page) for n in lens)
    assert split.io_bytes == B * H * D * 2 + 2 * rows * D * 2 + 4 * pages \
        + 4 * B
    sp = paged.splits(NB, B, KV)
    assert split.scratch_bytes == comb.scratch_bytes == 4 * B * H * sp * (
        D + 2)
    assert comb.io_bytes == B * H * D * 2
    assert split.warps == sp * KV * B * 4 and comb.warps == KV * B * 16


def test_trip_models_name_their_instantiations():
    bf = torch.bfloat16
    names = [la.function for la in (
        paged.trip_model(1, 32, 8, 128, 16, 4, [9], bf, bf)
        + paged.trip_model(1, 32, 8, 128, 16, 4, [9], bf, torch.int8)
        + decode.trip_model(1, 20, 32, 8, 128, 20, [0], bf)
        + prefill_paged.trip_model(1, 4, 32, 8, 128, 16, 4, [3], [7], bf)
        + flash.trip_model(1, 64, 64, 32, 8, 128, True)
        + scan.trip_model(1, 40, 64, 16, bf))]
    assert names == [
        r"paged_decode_kernelI13__nv_bfloat16S1_Li128E",
        r"_paged_decode_cu_.*decode_attention_combine_kernelI13__nv_bfloat16E",
        r"paged_decode_kernelI13__nv_bfloat16aLi128E",
        r"_paged_decode_cu_.*decode_attention_combine_kernelI13__nv_bfloat16E",
        r"decode_attention_kernelI13__nv_bfloat16Li128E",
        r"_decode_attention_cu_.*decode_attention_combine_kernelI"
        r"13__nv_bfloat16E",
        r"paged_prefill_tc_kernelI13__nv_bfloat16Li128E",
        r"flash_attention_tc_kernelILi128E",
        r"selective_scan_kernelI13__nv_bfloat16Li16ELi2E"]
