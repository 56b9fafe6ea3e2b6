"""The port's plain paged attention (decode and ragged prefill) against
the JAX package's Pallas kernels, run as the JAX tests run them
(``interpret=True``), and against the JAX gather oracles, on the same
numpy inputs.  f32 is held with rtol = atol = 2e-5, as the JAX tests hold
Pallas against jnp: only the order of sums differs.

The one designed divergence: a prefill slot with ``new_len == 0`` comes
out of the Pallas kernel — and of the port's CUDA kernel, which follows
it — as exact zeros, while the oracles (JAX's and the port's plain
version) softmax its fully masked rows uniformly.  The Pallas zeros are
pinned here; against the kernel the empty slot is excluded.

The CUDA kernels themselves run only on the card (``chip_smoke.py``);
here the wrappers' CPU dispatch, argument checks and build plumbing are
tested.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import (
    paged_decode_attention as jdecode, paged_prefill_attention as jprefill)
from repro.kernels.decode_attention.ref import (
    paged_decode_attention_ref as jdecode_ref,
    paged_prefill_attention_ref as jprefill_ref)
from repro.models.kv_quant import quantize_rows as jquant
from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import paged, prefill_paged
from repro_torch.kernels.decode_attention.ref import (
    paged_decode_attention_ref, paged_prefill_attention_ref)

TOL = dict(rtol=2e-5, atol=2e-5)

# (B, T, H, KV, D, page, NB, L), int8 pools?, pages_per_step: GQA (G=2),
# MQA (G=4), G=7 (qwen2-0.5b's 14 heads over 2), MHA on single-row pages;
# NB not a multiple of P = 3
CASES = [((2, 6, 4, 2, 16, 8, 4, 2), False, 1),
         ((3, 8, 4, 1, 16, 4, 5, 1), True, 3),
         ((2, 7, 14, 2, 16, 4, 5, 2), True, 1),
         ((2, 4, 8, 8, 32, 1, 10, 1), False, 3)]
GEOMS = [g for g, _, _ in CASES]


def _id(case):
    g, quant, pps = case
    return f"{'x'.join(map(str, g))}-{'int8' if quant else 'f32'}-P{pps}"


def _case(seed, B, T, H, KV, D, page, NB, L, quant, empty=False):
    rng = np.random.RandomState(seed)
    P = B * NB + 3
    q = rng.randn(B, T, H, D).astype(np.float32)
    kp = rng.randn(L, P, page, KV, D).astype(np.float32)
    vp = rng.randn(L, P, page, KV, D).astype(np.float32)
    ks = vs = None
    if quant:
        kp, ks = map(np.array, jquant(jnp.asarray(kp)))
        vp, vs = map(np.array, jquant(jnp.asarray(vp)))
    tbl = rng.permutation(np.arange(1, P))[:B * NB].reshape(B, NB)
    base = rng.randint(0, NB * page - T + 1, size=B).astype(np.int32)
    new = (base + rng.randint(1, T + 1, size=B)).astype(np.int32)
    if empty:
        base[0] = new[0] = 0
    return dict(q=q, k=kp, v=vp, ks=ks, vs=vs, tbl=tbl.astype(np.int32),
                base=base, new=new, layer=int(rng.randint(0, L)))


def _torch(c):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in c.items()}


def _jax(c):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in c.items()}


@pytest.mark.parametrize("geom,quant,pps", CASES, ids=[_id(c) for c in CASES])
def test_plain_decode_matches_pallas_and_oracle(geom, quant, pps):
    c = _case(sum(geom) + quant, *geom, quant)
    c["q"] = c["q"][:, :1]
    c["new"] = np.maximum(c["new"], 1)              # decode: kv_len >= 1
    t, j = _torch(c), _jax(c)
    got = paged.paged_decode_attention(
        t["q"], t["k"], t["v"], t["tbl"], t["new"], c["layer"],
        k_scale=t["ks"], v_scale=t["vs"], pages_per_step=pps).numpy()
    pallas = jdecode(j["q"], j["k"], j["v"], j["tbl"], j["new"], c["layer"],
                     pages_per_step=pps, k_scale=j["ks"], v_scale=j["vs"],
                     interpret=True)
    oracle = jdecode_ref(j["q"], j["k"], j["v"], j["tbl"], j["new"],
                         c["layer"], k_scale=j["ks"], v_scale=j["vs"])
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)


@pytest.mark.parametrize("geom,quant,pps", CASES, ids=[_id(c) for c in CASES])
def test_plain_prefill_matches_pallas_and_oracle(geom, quant, pps):
    c = _case(sum(geom) + 7 * quant, *geom, quant, empty=geom[0] > 1)
    t, j = _torch(c), _jax(c)
    got = prefill_paged.paged_prefill_attention(
        t["q"], t["k"], t["v"], t["tbl"], t["base"], t["new"], c["layer"],
        k_scale=t["ks"], v_scale=t["vs"], pages_per_step=pps).numpy()
    pallas = np.asarray(jprefill(
        j["q"], j["k"], j["v"], j["tbl"], j["base"], j["new"], c["layer"],
        pages_per_step=pps, k_scale=j["ks"], v_scale=j["vs"],
        interpret=True))
    oracle = jprefill_ref(j["q"], j["k"], j["v"], j["tbl"], j["base"],
                          j["new"], c["layer"], k_scale=j["ks"],
                          v_scale=j["vs"])
    live = c["new"] > 0
    np.testing.assert_allclose(got[live], pallas[live], **TOL)
    np.testing.assert_allclose(got, np.asarray(oracle), **TOL)
    if not live.all():
        # the kernel semantics the CUDA kernel follows: exact zeros
        assert (pallas[~live] == 0).all()
        assert np.abs(got[~live]).max() > 0          # plain: uniform softmax


def test_plain_prefill_empty_slot_is_uniform_over_gathered_rows():
    """The plain version's empty-slot rows are the mean of the slot's
    gathered V rows (a uniform softmax over NEG_INF scores) — what the
    CUDA kernel replaces with zeros."""
    c = _torch(_case(3, 2, 4, 4, 2, 16, 4, 3, 1, False, empty=True))
    out = paged_prefill_attention_ref(c["q"], c["k"], c["v"], c["tbl"],
                                      c["base"], c["new"], c["layer"])
    vg = c["v"][c["layer"]][c["tbl"][0].long()].reshape(-1, 2, 16)
    want = vg.mean(0).repeat_interleave(2, dim=0)    # (H, D), G = 2
    torch.testing.assert_close(out[0, 0], want, **TOL)


def test_wrappers_take_plain_version_on_cpu_without_launching():
    c = _torch(_case(9, *GEOMS[0], False))
    before = (paged.KERNEL.launches, prefill_paged.KERNEL.launches)
    got = prefill_paged.paged_prefill_attention(
        c["q"], c["k"], c["v"], c["tbl"], c["base"], c["new"], c["layer"])
    want = paged_prefill_attention_ref(c["q"], c["k"], c["v"], c["tbl"],
                                       c["base"], c["new"], c["layer"])
    assert torch.equal(got, want)
    got = paged.paged_decode_attention(c["q"][:, :1], c["k"], c["v"],
                                       c["tbl"], c["new"], c["layer"])
    assert torch.equal(got, paged_decode_attention_ref(
        c["q"][:, :1], c["k"], c["v"], c["tbl"], c["new"], c["layer"]))
    assert (paged.KERNEL.launches, prefill_paged.KERNEL.launches) == before


def _layout_args(**change):
    B, T, H, KV, D, page, NB, L = 2, 3, 4, 2, 16, 4, 3, 2
    a = dict(q=torch.zeros(B, T, H, D),
             k=torch.zeros(L, 7, page, KV, D), v=torch.zeros(L, 7, page, KV, D),
             tbl=torch.zeros(B, NB, dtype=torch.int32),
             lens=(torch.zeros(B, dtype=torch.int32),), layer=1,
             ks=None, vs=None)
    a.update(change)
    return a


@pytest.mark.parametrize("change", [
    dict(q=torch.zeros(2, 3, 4, 16, dtype=torch.float16)),      # q dtype
    dict(q=torch.zeros(2, 3, 4, 24)),                           # head dim
    dict(q=torch.zeros(2, 3, 3, 16)),                           # H % KV
    dict(k=torch.zeros(2, 7, 4, 2, 16, dtype=torch.bfloat16),
         v=torch.zeros(2, 7, 4, 2, 16, dtype=torch.bfloat16)),  # pool dtype
    dict(k=torch.zeros(2, 7, 4, 2, 16, dtype=torch.int8),
         v=torch.zeros(2, 7, 4, 2, 16, dtype=torch.int8)),      # no scales
    dict(tbl=torch.zeros(2, 3, dtype=torch.int64)),             # table dtype
    dict(lens=(torch.zeros(3, dtype=torch.int32),)),            # lens shape
    dict(layer=2),                                              # layer range
    dict(q=torch.zeros(2, 4, 3, 16).transpose(1, 2)),           # contiguity
])
def test_layout_check_refuses(change):
    a = _layout_args(**change)
    with pytest.raises(ValueError):
        paged.check_layout("prefill", a["q"], a["k"], a["v"], a["tbl"],
                           a["lens"], a["layer"], a["ks"], a["vs"])


def test_layout_check_accepts_int8_with_scales():
    s = torch.zeros(2, 7, 4, 2)
    a = _layout_args(k=torch.zeros(2, 7, 4, 2, 16, dtype=torch.int8),
                     v=torch.zeros(2, 7, 4, 2, 16, dtype=torch.int8),
                     ks=s, vs=s)
    assert paged.check_layout("decode", a["q"], a["k"], a["v"], a["tbl"],
                              a["lens"], a["layer"], a["ks"], a["vs"]) \
        == (2, 3, 4, 2, 16, 7, 4, 3)


def test_prefill_grid_and_shared_memory_follow_the_kernels():
    """bf16 q runs the tensor-core prefill kernel: 32-row tiles of the
    T * G rows of each (kv head, slot), so the serving shape (B = 4,
    T = 32, H = 32, KV = 8) launches 128 blocks, and shared memory that
    does not grow with the page; f32 q keeps the CUDA-core kernel, one
    block per (kv head, slot), whose footprint grows with the page and
    refuses a page too large for a block."""
    assert prefill_paged.grid_blocks(4, 32, 32, 8, torch.bfloat16) == 128
    assert prefill_paged.grid_blocks(4, 32, 32, 8, torch.float32) == 32
    assert prefill_paged.grid_blocks(2, 20, 14, 2, torch.bfloat16) == 20
    bf = {paged.block_smem_bytes("prefill", torch.bfloat16, torch.bfloat16,
                                 128, pg, 4) for pg in (1, 16, 2048)}
    assert bf == {2 * (32 * 136 + 4 * 64 * 136)}
    assert paged.block_smem_bytes("prefill", torch.bfloat16, torch.int8,
                                  128, 16, 4) == \
        max(bf) + 4 * 64 * 128 + 16 * 64
    # split decode: a 3-stage ring of 32 K and 32 V rows padded by 16
    # bytes (int8: and their f32 scales), then G query rows, their 32
    # probabilities and corrections in f32, whatever the page
    for pg in (1, 16, 2048):
        assert paged.block_smem_bytes("decode", torch.bfloat16,
                                      torch.bfloat16, 128, pg, 4) == \
            3 * 2 * 32 * 136 * 2 + 4 * (4 * 128 + 4 * 32 + 4)
    assert paged.block_smem_bytes("decode", torch.float32, torch.int8, 64,
                                  16, 7) == \
        3 * 2 * 32 * 80 + 3 * 2 * 32 * 4 + 4 * (7 * 64 + 7 * 32 + 7)
    L, P, page, KV, D = 1, 3, 2048, 2, 16
    for dtype, refused in ((torch.float32, True), (torch.bfloat16, False)):
        a = _layout_args(q=torch.zeros(2, 3, 4, D, dtype=dtype),
                         k=torch.zeros(L, P, page, KV, D, dtype=dtype),
                         v=torch.zeros(L, P, page, KV, D, dtype=dtype),
                         layer=0)
        args = ("prefill", a["q"], a["k"], a["v"], a["tbl"], a["lens"],
                a["layer"])
        if refused:
            with pytest.raises(ValueError, match="shared memory"):
                paged.check_layout(*args)
        else:
            assert paged.check_layout(*args)[6] == page


def test_paged_decode_splits_depend_on_static_shapes_only():
    """About two blocks per SM over the grid (splits, KV, B), at most one
    split per page of the table: 8 at the serving shape (NB ~ 22, B = 4,
    KV = 8: 256 blocks), 22 at qwen2-0.5b's B = 6, KV = 2, one when the
    table holds one page."""
    assert paged.splits(22, 4, 8) == 8
    assert paged.splits(22, 4, 8) * 8 * 4 == 256
    assert paged.splits(131, 6, 2) == 22
    assert paged.splits(1, 4, 8) == 1
    assert paged.splits(5, 1, 1) == 5
    assert paged.splits(400, 64, 64) == 1


def test_wrappers_refuse_non_cpu_non_cuda_tensors():
    """Tensors that are not all on the CPU never reach the plain version:
    off a CUDA device the wrapper raises."""
    c = _torch(_case(9, *GEOMS[0], False))
    meta = {k: (v.to("meta") if isinstance(v, torch.Tensor) else v)
            for k, v in c.items()}
    with pytest.raises(ValueError, match="CUDA"):
        prefill_paged.paged_prefill_attention(
            meta["q"], meta["k"], meta["v"], meta["tbl"], meta["base"],
            meta["new"], c["layer"])
    with pytest.raises(ValueError, match="CUDA"):
        paged.paged_decode_attention(c["q"][:, :1], meta["k"], c["v"],
                                     c["tbl"], c["new"], c["layer"])


def test_build_plumbing_without_nvcc(tmp_path, monkeypatch):
    """The package imports and its CPU paths run without nvcc; the build
    compiles each source separately for sm_90a and links one library."""
    assert [p.name for p in build.sources()] == ["decode_attention.cu",
                                                 "flash_attention.cu",
                                                 "paged_decode.cu",
                                                 "paged_prefill.cu",
                                                 "selective_scan.cu",
                                                 "stream.cu"]
    cmds = build.compile_commands("nvcc", tmp_path)
    assert len(cmds) == 7 and all("arch=compute_90a,code=sm_90a" in c
                                  for c in cmds)
    assert str(tmp_path / "libkernels.so") in cmds[-1]
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    assert len(build.source_hash()) == 16
