"""The port's BabelStream kernels' plain versions and wrappers against the
JAX package's Pallas kernels (run as the JAX tests run them,
``interpret=True``) and its jnp oracles, on the same numpy inputs; and
the port's BabelStream launcher on the CPU.

Tolerances, with their reasons:
  * copy, mul, add: exact.  Both sides round the scalar to the arrays'
    type first and each operation once.
  * triad: exact against the jnp oracle and the bf16 Pallas kernel, which
    round ``s * c`` before adding ``b``, as the port does.  The f32 Pallas
    kernel in interpret mode is contracted by XLA's CPU backend into one
    FMA (one rounding instead of two), so it is held within 2^-22 of
    |b| + |s c|: half an ulp of the product plus half an ulp of each sum.
  * dot: within 1e-5 of sum |a b|.  Products are exact in f32 (bf16 x bf16
    fits f32's mantissa, f32 products round once the same way) and only
    the order of the f32 sums differs, each within (log2 n + the Pallas
    grid's sequential steps) f32 epsilons of sum |a b|: under 3e-6 here.

The CUDA kernels themselves run only on the card (``chip_smoke.py``) and
through the emulated build (``test_torch_kernel_emulation.py``).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.stream import ref as jref
from repro.kernels.stream import stream as jstream
from repro_torch.kernels.stream import ref, stream
from repro_torch.launch import babelstream

REPO = Path(__file__).resolve().parents[1]
# tests/test_stream_kernels.py's shapes, and an odd one (3 rows of 1000)
SHAPES = [(8, 128), (256, 512), (1024, 128), (64, 1024), (3, 1000)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
OPS = ("copy", "mul", "add", "triad", "dot")
ARGS = {"copy": "a", "mul": "c", "add": "ab", "triad": "bc", "dot": "ab"}
TRIAD_FMA_TOL = 2.0 ** -22
DOT_TOL = 1e-5


def to_torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor, bit-exact (bf16 through uint16)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def inputs(shape, jdtype, seed):
    """a, b, c from one numpy generator, as JAX arrays and torch tensors
    holding the same values."""
    rng = np.random.default_rng(seed)
    js = {k: jnp.asarray(rng.standard_normal(shape, np.float32)
                         ).astype(jdtype) for k in "abc"}
    return js, {k: to_torch(v) for k, v in js.items()}


def as_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy()
    return np.asarray(x, np.float32).astype(np.float64)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("op", OPS)
def test_plain_matches_pallas_and_jnp(op, shape, dname):
    jdtype, tdtype = DTYPES[dname]
    js, ts = inputs(shape, jdtype, seed=sum(shape) + len(op))
    jargs = [js[k] for k in ARGS[op]]
    targs = [ts[k] for k in ARGS[op]]
    port = getattr(ref, op)(*targs)
    pallas = getattr(jstream, op)(*jargs, interpret=True)
    oracle = getattr(jref, op)(*jargs)
    if op == "dot":
        assert port.dtype == torch.float32 and port.shape == ()
        scale = np.abs(as_f64(ts[ARGS[op][0]]) * as_f64(ts[ARGS[op][1]])
                       ).sum()
        for want in (pallas, oracle):
            assert abs(port.item() - float(want)) <= DOT_TOL * scale
        return
    assert port.dtype == tdtype and port.shape == shape
    assert torch.equal(port, to_torch(oracle))
    if op == "triad" and dname == "f32":
        b, c = as_f64(ts["b"]), as_f64(ts["c"])
        bound = TRIAD_FMA_TOL * (np.abs(b) + np.abs(0.4 * c))
        assert (np.abs(as_f64(port) - as_f64(pallas)) <= bound).all()
    else:
        assert torch.equal(port, to_torch(pallas))


def test_scalar_rounds_to_dtype():
    """The scalar is rounded to the arrays' type first, as JAX rounds a
    Python float against a bf16 array."""
    assert ref.scalar_in(torch.bfloat16) == 0.400390625
    assert ref.scalar_in(torch.float32) == float(np.float32(0.4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_wrappers_take_plain_version_on_cpu(dtype):
    """CPU tensors go to the plain versions: same values, no launch."""
    g = torch.Generator().manual_seed(0)
    a, b, c = (torch.randn(3, 1000, generator=g).to(dtype) for _ in range(3))
    n0 = {k: v.launches for k, v in stream.KERNELS.items()}
    assert torch.equal(stream.copy(a), ref.copy(a))
    assert torch.equal(stream.mul(c), ref.mul(c))
    assert torch.equal(stream.mul(c, 1.5), ref.mul(c, 1.5))
    assert torch.equal(stream.add(a, b), ref.add(a, b))
    assert torch.equal(stream.triad(b, c), ref.triad(b, c))
    assert torch.equal(stream.dot(a, b), ref.dot(a, b))
    assert {k: v.launches for k, v in stream.KERNELS.items()} == n0
    assert set(stream.launch_counts()) == {"copy", "mul", "add", "triad",
                                           "dot"}
    out = stream.copy(a)
    assert out.data_ptr() != a.data_ptr()        # a new tensor, as in JAX


@pytest.mark.parametrize("op", ["copy", "mul", "add", "triad"])
def test_out_aliasing(op):
    """``out=`` writes the named tensor, also when it is an input."""
    g = torch.Generator().manual_seed(1)
    b, c = (torch.randn(8, 128, generator=g) for _ in range(2))
    args = {"copy": (b,), "mul": (c,), "add": (b, c), "triad": (b, c)}[op]
    want = getattr(ref, op)(*args)
    for target in (torch.empty_like(b), args[0]):
        got = getattr(stream, op)(*args, out=target)
        assert got is target and torch.equal(got, want)


@pytest.mark.parametrize("bad", [
    dict(a=torch.zeros(8), why="2-D"),
    dict(a=torch.zeros(4, 8, dtype=torch.float16), why="f32 or bf16"),
    dict(a=torch.zeros(4, 8).t(), why="contiguous"),
    dict(a=torch.zeros(0, 8), why="empty"),
    dict(a=torch.zeros(4, 8), b=torch.zeros(4, 9), why="shape"),
    dict(a=torch.zeros(4, 8), b=torch.zeros(4, 8, dtype=torch.bfloat16),
         why="dtype"),
], ids=lambda d: d["why"])
def test_layout_checks(bad):
    a, b = bad["a"], bad.get("b", bad["a"])
    with pytest.raises(ValueError):
        stream.add(a, b)
    if "b" not in bad:
        with pytest.raises(ValueError):
            stream.copy(a)


def test_dot_passes_and_launch_geometry():
    """dot sums 2^25 products in two launches (2^25 -> 4096 -> 1), each
    32 elements a thread in blocks of 256 (8192 a block); copy, mul, add
    and triad move one 16-byte vector (of each input) a thread in blocks
    of 1024 (4096 f32 or 8192 bf16 elements a block: 8192 blocks at 2^25
    f32)."""
    assert stream.dot_passes(2 ** 25) == [2 ** 25, 4096]
    assert stream.dot_passes(1000) == [1000]
    assert stream.dot_passes(8193) == [8193, 2]
    assert stream.launches("dot", torch.float32, 2 ** 25) == [
        ("stream_dot_f32", 4096, 256), ("stream_sum_f32", 1, 256)]
    assert stream.launches("dot", torch.bfloat16, 9009) == [
        ("stream_dot_bf16", 2, 256), ("stream_sum_f32", 1, 256)]
    assert stream.launches("triad", torch.bfloat16, 3000) == [
        ("stream_triad_bf16", 1, 1024)]
    assert stream.launches("add", torch.float32, 2 ** 25) == [
        ("stream_add_f32", 8192, 1024)]
    assert stream.launches("triad", torch.bfloat16, 9009) == [
        ("stream_triad_bf16", 2, 1024)]
    assert stream.launches("copy", torch.float32, 2 ** 25) == [
        ("stream_copy_f32", 8192, 1024)]
    assert stream.launches("mul", torch.float32, 2 ** 25) == [
        ("stream_mul_f32", 8192, 1024)]
    assert stream.launches("copy", torch.bfloat16, 2 ** 25) == [
        ("stream_copy_bf16", 4096, 1024)]
    assert stream.launches("mul", torch.bfloat16, 9009) == [
        ("stream_mul_bf16", 2, 1024)]
    assert stream.launches("copy", torch.float32, 3003) == [
        ("stream_copy_f32", 1, 1024)]
    assert [stream.block_elements(k, torch.float32) for k in
            ("copy", "mul", "add", "triad", "dot")] == [
                4096, 4096, 4096, 4096, 8192]
    assert [stream.block_elements(k, torch.bfloat16) for k in
            ("mul", "add", "triad")] == [8192, 8192, 8192]


def test_dot_alignment_check():
    """The card's dot loads 16 bytes at a time: a view 4 bytes past a
    16-byte boundary is refused there (the emulated kernel's test drives
    it through ``dot``); the plain version on the CPU takes any view."""
    base = torch.arange(1025, dtype=torch.float32)
    stream.check_aligned("dot", base[:1024], base[4:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        stream.check_aligned("dot", base[:1024], base[1:])
    a = base[1:].view(8, 128)
    assert torch.equal(stream.dot(a, a), ref.dot(a, a))


@pytest.mark.parametrize("op", ["copy", "mul", "add", "triad"])
def test_copy_mul_alignment_check(op):
    """The card's copy, mul, add and triad load and store 16 bytes at a
    time: a view 4 bytes past a 16-byte boundary, as input or as
    ``out=``, is refused there (the emulated kernel's test drives it
    through the wrappers); the plain version on the CPU takes any view,
    also in place (add and triad: ``out=`` each input in turn)."""
    base = torch.arange(1025, dtype=torch.float32)
    stream.check_aligned(op, base[:1024], base[4:])
    with pytest.raises(ValueError, match=f"{op}: arrays must be 16-byte"):
        stream.check_aligned(op, base[:1024], base[1:])
    a = base[1:].view(8, 128)
    fn, plain = getattr(stream, op), getattr(ref, op)
    if op in ("copy", "mul"):
        want = plain(a)
        assert torch.equal(fn(a), want)
        assert fn(a, out=a) is a and torch.equal(a, want)
        return
    for which in range(2):
        x, y = a.clone(), (a * 0.5).clone()
        want = plain(x, y)
        assert torch.equal(fn(x, y), want)
        out = (x, y)[which]
        assert fn(x, y, out=out) is out and torch.equal(out, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_babelstream_cpu_solution(dtype):
    """BabelStream's protocol on the plain versions: the arrays follow the
    scalar recurrence exactly (the wrappers round as it does) and the
    table has one row per function."""
    res = babelstream.run(16, 300, dtype, num_times=4, device="cpu")
    assert res.ok, res.errors
    assert res.errors["a"] == res.errors["b"] == res.errors["c"] == 0.0
    assert all(len(res.times[k]) == 4 for k in babelstream.FUNCTIONS)
    assert res.bytes_moved("triad") == 3 * 4800 * (4 if dtype ==
                                                   torch.float32 else 2)
    assert [line.split()[0] for line in res.table().splitlines()] == [
        "Function", "Copy", "Mul", "Add", "Triad", "Dot"]


def test_babelstream_check_finds_a_mismatch():
    ga, gb, gc, gsum = babelstream.gold(torch.float32, 5, 64)
    a, b, c = (torch.full((8, 8), g.item()) for g in (ga, gb, gc))
    errors, limits, _ = babelstream.check_solution(a, b, c, gsum, 5)
    assert all(errors[k] <= limits[k] for k in errors)
    c[3, 3] += 0.01
    errors, limits, _ = babelstream.check_solution(a, b, c, gsum, 5)
    assert errors["c"] > limits["c"]
    errors, limits, _ = babelstream.check_solution(a, b, c, gsum * 1.001, 5)
    assert errors["sum"] > limits["sum"]


def test_babelstream_launcher_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.babelstream", "--device",
         "cpu", "--rows", "64", "--cols", "256", "--num-times", "3"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "solution check: passed" in res.stdout
    for name in ("Copy", "Mul", "Add", "Triad", "Dot", "MBytes/sec",
                 "measured memory ceiling (copy)"):
        assert name in res.stdout
