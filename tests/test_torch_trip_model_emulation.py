"""The trip models (``kernels/trips.py``) against the emulated kernels'
own counts, as ``test_torch_kernel_emulation`` builds them: every marked
loop's ``REPRO_TRIP``, per thread, reduced to each warp by its largest
thread count (``_check_trips``), equals the model's per-warp trips, for
paged decode and prefill, dense decode, flash and the scan.

This section was ``test_torch_stream_scan_emulation.py``'s; it lives in
a file of its own so that ``--dist loadfile`` gives it a worker of its
own.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import decode, paged, prefill_paged
from repro_torch.kernels.flash_attention import flash
from repro_torch.kernels.ssm_scan import scan

from test_torch_kernel_emulation import (  # noqa: F401  (fixtures)
    CASES, DECODE_CASES, FLASH_CASES, PAGED_POOLS, _case, _dense,
    _one_thread, _paged_decode_case, cuda_path_on_cpu, emulated)
from test_torch_stream_scan_emulation import (
    SCAN_CASES, SCAN_LANE_CASES, _check_trips, _scan_inputs)


@pytest.mark.parametrize("q_dtype,pool", PAGED_POOLS,
                         ids=lambda x: str(x).replace("torch.", ""))
@pytest.mark.parametrize("G", [4, 48])
def test_trip_model_of_paged_decode(G, q_dtype, pool, emulated,
                                    cuda_path_on_cpu):
    """22 splits of a 40-page table (page 4): kv_len 0, one token, one
    page, one page and a token, 100 (pieces ending mid-page, pieces 13-21
    empty) and the full table; G = 48 walks three row tiles; int8 pools
    copy their scales."""
    B, KV, D, page, NB = 6, 2, 32, 4, 40
    lens = [1, page, page + 1, 100, NB * page, 0]
    q, kp, vp, tbl, kv_len, ks, vs = _paged_decode_case(
        G + len(pool), B, G * KV, KV, D, page, NB, q_dtype, pool, lens)
    model = paged.trip_model(B, G * KV, KV, D, page, NB, lens, q_dtype,
                             kp.dtype)
    _check_trips(emulated, model, lambda: paged.paged_decode_attention(
        q, kp, vp, tbl, kv_len, 1, k_scale=ks, v_scale=vs))


@pytest.mark.parametrize("case", [c for c in DECODE_CASES if c[4] >= 32],
                         ids=lambda c: "-".join(
                             str(x).replace("torch.", "") for x in c))
def test_trip_model_of_dense_decode(case, emulated, cuda_path_on_cpu):
    """kv_len below T, a kv_start in every slot but the first and an empty
    window in the last (kv_start >= kv_len)."""
    B, T, H, KV, D, dtype = case
    q, k, v = _dense(T + H, B, 1, T, H, KV, D, dtype)
    kv_len = T - 3
    start = [0] + [kv_len] * (B - 1) if B == 2 else [0, 5, kv_len]
    model = decode.trip_model(B, T, H, KV, D, kv_len, start, dtype)
    _check_trips(emulated, model, lambda: decode.decode_attention(
        q, k, v, kv_len, torch.tensor(start, dtype=torch.int32)))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_trip_model_of_paged_prefill(case, emulated, cuda_path_on_cpu):
    """bf16 q on the tensor-core body, f32 q on the CUDA-core one: causal
    from random, unaligned bases, an empty slot, G up to 48 over several
    row tiles, single-row pages, int8 pools."""
    *geom, dtype, int8 = case
    B, T, H, KV, D, page, NB, L = geom
    q, kp, vp, tbl, base, new, layer, ks, vs = _case(sum(geom), *geom,
                                                     dtype, int8, empty=True)
    model = prefill_paged.trip_model(B, T, H, KV, D, page, NB,
                                     base.tolist(), new.tolist(), kp.dtype,
                                     q.dtype)
    _check_trips(emulated, model, lambda: prefill_paged.
                 paged_prefill_attention(q, kp, vp, tbl, base, new, layer,
                                         k_scale=ks, v_scale=vs))


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_trip_model_of_flash(case, emulated, cuda_path_on_cpu):
    """bf16 on the tensor-core body, f32 on the CUDA-core one; causal and
    not, S != T both ways."""
    B, S, T, H, KV, D, causal, dtype = case
    q, k, v = _dense(S + T + D, B, S, T, H, KV, D, dtype)
    model = flash.trip_model(B, S, T, H, KV, D, causal, dtype)
    _check_trips(emulated, model, lambda: flash.launch(q, k, v, causal))


@pytest.mark.parametrize("case", SCAN_LANE_CASES + [
    c + (scan.LANES, (c[2] * (2 if c[4] == torch.bfloat16 else 4)) % 16
         == 0) for c in SCAN_CASES], ids=lambda c: "-".join(
             str(x).replace("torch.", "") for x in c))
def test_trip_model_of_the_scan(case, emulated, cuda_path_on_cpu,
                                monkeypatch):
    """The ragged last tile (S not a multiple of 32), 1, 2 and 4 lanes,
    16-byte tiles and plain loads."""
    B, S, d_in, N, dtype, lanes, vec = case
    monkeypatch.setattr(scan, "LANES", lanes)
    x, dt, A, Bc, Cc = _scan_inputs(np.random.default_rng(S + d_in), B, S,
                                    d_in, N, dtype)
    assert scan.copies_16_bytes(x, dt) == vec
    model = scan.trip_model(B, S, d_in, N, dtype, lanes, vec)
    _check_trips(emulated, model,
                 lambda: scan.selective_scan(x, dt, A, Bc, Cc))
