"""The paged decode kernel (split over pages, with the combine it
shares) emulated on the CPU as ``test_torch_kernel_emulation`` runs it
(its fixtures and cases: g++ against the stand-in CUDA headers, a
block's threads as ``std::thread``s), held against the plain version:
its pieces' and pages' edges at G = 4, 7 and 48, aliased tables, the
online softmax across tiles, splits that follow the static shapes,
kv_len 0, int8 pools and the misaligned-pool refusal.

This section was ``test_torch_kernel_emulation.py``'s; it lives in a
file of its own so that ``--dist loadfile`` gives it a worker of its
own.
"""
import pytest
import torch

from repro_torch.kernels.decode_attention import paged, prefill_paged
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_ref, paged_prefill_attention_ref)

from test_torch_kernel_emulation import (  # noqa: F401  (fixtures)
    PAGED_POOLS, TOL, _case, _one_thread, _paged_decode_case,
    cuda_path_on_cpu, emulated)


@pytest.mark.parametrize("q_dtype,pool", PAGED_POOLS,
                         ids=lambda x: str(x).replace("torch.", ""))
@pytest.mark.parametrize("G", [4, 7, 48])
def test_emulated_paged_decode_across_splits_and_pages(G, q_dtype, pool,
                                                       cuda_path_on_cpu):
    """B x KV = 12 leaves 22 splits of a 40-page table (page 4): kv_len
    of one token, one page, one page and a token, 100 (25 live pages, one
    or two a piece, pieces 13-21 empty) and the full table (two pages a
    piece), against the plain version; a slot with kv_len == 0 gives
    exact zeros.  G = 4 (granite-8b), 7 (qwen2-0.5b) and 48 (granite-20b:
    three row tiles of 16, each reading the piece again)."""
    B, KV, D, page, NB = 6, 2, 32, 4, 40
    assert paged.splits(NB, B, KV) == 22
    lens = [1, page, page + 1, 100, NB * page, 0]
    q, kp, vp, tbl, kv_len, ks, vs = _paged_decode_case(
        G + len(pool), B, G * KV, KV, D, page, NB, q_dtype, pool, lens)
    tol = TOL[q_dtype]
    n0 = paged.KERNEL.launches
    got = paged.paged_decode_attention(q, kp, vp, tbl, kv_len, 1,
                                       k_scale=ks, v_scale=vs)
    want = paged_decode_attention_ref(q, kp, vp, tbl, kv_len, 1, ks, vs)
    assert got.dtype == q_dtype and (got[-1] == 0).all()
    torch.testing.assert_close(got[:-1].float(), want[:-1].float(),
                               rtol=tol, atol=tol)
    assert paged.KERNEL.launches == n0 + 1


@pytest.mark.parametrize("q_dtype,pool", PAGED_POOLS,
                         ids=lambda x: str(x).replace("torch.", ""))
def test_emulated_paged_kernels_on_aliased_tables(q_dtype, pool,
                                                  cuda_path_on_cpu):
    """Prefix sharing maps one physical page into several tables: slot 1's
    first 3 pages are slot 0's, and slot 2's first page is too.  Decode at
    kv_len off the page edges and a prefill chunk from a base that is not
    a page multiple (a sharer's first chunk after a mid-page share) read
    the aliased pages as the plain version does."""
    B, H, KV, D, page, NB, T = 3, 8, 2, 32, 4, 6, 5
    q, kp, vp, tbl, _, _, _, ks, vs = _case(
        17 + len(pool), B, T, H, KV, D, page, NB, 2,
        torch.float32 if pool == "int8" else q_dtype, pool == "int8")
    q = q.to(q_dtype)
    tbl[1, :3] = tbl[0, :3]
    tbl[2, :1] = tbl[0, :1]
    tol = TOL[q_dtype]
    kv_len = torch.tensor([13, 14, 7], dtype=torch.int32)
    got = paged.paged_decode_attention(q[:, :1].contiguous(), kp, vp, tbl,
                                       kv_len, 1, k_scale=ks, v_scale=vs)
    want = paged_decode_attention_ref(q[:, :1], kp, vp, tbl, kv_len, 1, ks,
                                      vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    base = torch.tensor([10, 10, 2], dtype=torch.int32)
    new = base + torch.tensor([T, 3, T], dtype=torch.int32)
    got = prefill_paged.paged_prefill_attention(
        q, kp, vp, tbl, base, new, 1, k_scale=ks, v_scale=vs)
    want = paged_prefill_attention_ref(q, kp, vp, tbl, base, new, 1, ks, vs)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_emulated_paged_decode_online_softmax_across_tiles(dtype,
                                                           cuda_path_on_cpu):
    """B x KV = 33 leaves 8 splits of a 56-page table (page 16): the full
    table gives pieces of 7 pages, four 32-position tiles that straddle
    pages, so the online softmax carries m, l and acc across tiles and
    the 3-stage cp.async ring reuses its stages; 600 tokens give pieces
    of 5 pages and a shorter last one, and 37 tokens leave pieces 3-7
    empty."""
    B, H, KV, D, page, NB = 3, 44, 11, 16, 16, 56
    assert paged.splits(NB, B, KV) == 8
    q, kp, vp, tbl, kv_len, _, _ = _paged_decode_case(
        57, B, H, KV, D, page, NB, dtype, "f32" if dtype == torch.float32
        else "bf16", [NB * page, 600, 37])
    got = paged.paged_decode_attention(q, kp, vp, tbl, kv_len)
    want = paged_decode_attention_ref(q, kp, vp, tbl, kv_len)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_emulated_paged_decode_splits_follow_static_shapes(
        cuda_path_on_cpu, monkeypatch):
    """The split count and the scratch the wrapper hands the kernel depend
    on (NB, B, KV) only: every kv_len, from all zeros to the full table,
    launches the same grid."""
    calls = []
    monkeypatch.setattr(paged.KERNEL, "_fn",
                        lambda *a: calls.append(a) or 0)
    B, H, KV, D, page, NB = 4, 32, 8, 16, 16, 22
    for lens in ([0] * B, [1, 80, 316, 200], [NB * page] * B):
        q, kp, vp, tbl, kv_len, _, _ = _paged_decode_case(
            3, B, H, KV, D, page, NB, torch.float32, "f32", lens)
        paged.paged_decode_attention(q, kp, vp, tbl, kv_len)
    assert paged.splits(NB, B, KV) == 8
    assert {a[17] for a in calls} == {8}             # the splits argument
    assert paged.block_smem_bytes("decode", torch.bfloat16, torch.bfloat16,
                                  128, 16, 4) == \
        paged.block_smem_bytes("decode", torch.bfloat16, torch.bfloat16,
                               128, 1, 4)


def test_emulated_paged_decode_refuses_misaligned_pool(cuda_path_on_cpu):
    """The kernel copies K and V rows 16 bytes at a time: a pool view 4
    bytes past a 16-byte boundary is refused, not read another way, and
    the same values in an aligned pool go through."""
    q, kp, vp, tbl, kv_len, _, _ = _paged_decode_case(
        5, 2, 4, 2, 16, 4, 3, torch.float32, "f32", [5, 12])
    shifted = torch.zeros(kp.numel() + 1)[1:].view(kp.shape)
    shifted.copy_(kp)
    n0 = paged.KERNEL.launches
    for k, v in ((shifted, vp), (kp, shifted)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            paged.paged_decode_attention(q, k, v, tbl, kv_len)
    assert paged.KERNEL.launches == n0
    torch.testing.assert_close(
        paged.paged_decode_attention(q, shifted.clone(), vp, tbl, kv_len),
        paged_decode_attention_ref(q, kp, vp, tbl, kv_len),
        rtol=2e-5, atol=2e-5)
