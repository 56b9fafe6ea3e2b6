"""The port's configs and parameters against the JAX package's: configs
equal field for field, the weight bridge bit-exact, and ``init_params``
giving the JAX schema's shapes, dtypes and init kinds."""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import get_model as jget_model
from repro_torch import configs as tconfigs
from repro_torch.models.params import init_params, params_from_jax

# the archs the port runs, and all ten whose configs it mirrors
ARCHS = ["granite-8b", "qwen2-0.5b", "falcon-mamba-7b", "granite-20b",
         "phi4-mini-3.8b"]
ALL_ARCHS = ARCHS + ["llama4-scout-17b-a16e", "grok-1-314b", "zamba2-7b",
                     "whisper-large-v3", "qwen2-vl-72b"]
# the stub-frontend families: embedding inputs with M-RoPE, and the
# encoder-decoder (layernorm with biases, the gelu MLP with biases)
STUB_FRONTEND = ["qwen2-vl-72b", "whisper-large-v3"]
# the hybrid: a stacked Mamba2 trunk and the unstacked shared block
HYBRID = ["zamba2-7b"]
JNP_TO_TORCH = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
                jnp.dtype(jnp.float32): torch.float32,
                jnp.dtype(jnp.int32): torch.int32}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_equal_field_for_field(arch, reduced):
    j, t = jconfigs.get(arch), tconfigs.get(arch)
    if reduced:
        j, t = j.reduced(), t.reduced()
    jf = {f.name for f in dataclasses.fields(j)}
    tf = {f.name for f in dataclasses.fields(t)}
    assert jf == tf
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.head_dim == j.head_dim


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_bit_exact(dtype):
    cfg_j = dataclasses.replace(jconfigs.get("granite-8b").reduced(),
                                dtype=dtype)
    cfg_t = dataclasses.replace(tconfigs.get("granite-8b").reduced(),
                                dtype=dtype)
    pj = jax.tree.map(np.asarray, jget_model(cfg_j).init(jax.random.key(4)))
    pt = params_from_jax(pj, cfg_t, "cpu")
    fj, ft = _flat(pj), _flat(pt)
    assert fj.keys() == ft.keys()
    for k, a in fj.items():
        b = ft[k]
        assert tuple(b.shape) == a.shape and b.dtype == JNP_TO_TORCH[a.dtype]
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        twin = torch.int16 if a.dtype.itemsize == 2 else torch.int32
        np.testing.assert_array_equal(
            b.view(twin).numpy().view(bits), a.view(bits), err_msg=k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_bit_exact_mamba1(dtype):
    """falcon-mamba-7b's leaves, the Mamba1 mixer's included (``A_log``
    from the ``ssm_a`` init, ``dt_bias`` from ``ssm_dt``), bit for bit."""
    cfg_j = dataclasses.replace(jconfigs.get("falcon-mamba-7b").reduced(),
                                dtype=dtype)
    cfg_t = dataclasses.replace(tconfigs.get("falcon-mamba-7b").reduced(),
                                dtype=dtype)
    pj = jax.tree.map(np.asarray, jget_model(cfg_j).init(jax.random.key(5)))
    pt = params_from_jax(pj, cfg_t, "cpu")
    fj, ft = _flat(pj), _flat(pt)
    assert fj.keys() == ft.keys()
    assert "/blocks/mixer/A_log" in ft and "/blocks/mixer/dt_bias" in ft
    for k, a in fj.items():
        b = ft[k]
        assert tuple(b.shape) == a.shape and b.dtype == JNP_TO_TORCH[a.dtype]
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        twin = torch.int16 if a.dtype.itemsize == 2 else torch.int32
        np.testing.assert_array_equal(
            b.view(twin).numpy().view(bits), a.view(bits), err_msg=k)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", STUB_FRONTEND + HYBRID)
def test_bridge_bit_exact_stub_frontend(arch, dtype):
    """qwen2-vl's leaves (qkv biases), whisper's (the ``encoder`` and
    ``decoder`` stacks with ``ln3`` and ``cross``, ``ln_enc``, every norm
    bias and the gelu MLP's biases) and zamba2's (the Mamba2 mixer, the
    unstacked ``shared_attn``), bit for bit."""
    cfg_j = dataclasses.replace(jconfigs.get(arch).reduced(), dtype=dtype)
    cfg_t = dataclasses.replace(tconfigs.get(arch).reduced(), dtype=dtype)
    pj = jax.tree.map(np.asarray, jget_model(cfg_j).init(jax.random.key(6)))
    pt = params_from_jax(pj, cfg_t, "cpu")
    fj, ft = _flat(pj), _flat(pt)
    assert fj.keys() == ft.keys()
    if cfg_t.is_encoder_decoder:
        for k in ("/encoder/ffn/b_up", "/encoder/ffn/b_down",
                  "/encoder/ln1/bias", "/decoder/ln3/bias",
                  "/decoder/cross/wq", "/ln_enc/bias", "/ln_f/bias"):
            assert k in ft, k
    elif cfg_t.family == "hybrid":
        for k in ("/blocks/mixer/w_zx", "/blocks/mixer/A_log",
                  "/blocks/mixer/norm", "/shared_attn/attn/wq",
                  "/shared_attn/ffn/w_down"):
            assert k in ft, k
        assert ft["/shared_attn/attn/wq"].ndim == 2
    else:
        assert "/blocks/attn/bq" in ft and "/blocks/ffn/w_gate" in ft
    for k, a in fj.items():
        b = ft[k]
        assert tuple(b.shape) == a.shape and b.dtype == JNP_TO_TORCH[a.dtype]
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        twin = torch.int16 if a.dtype.itemsize == 2 else torch.int32
        np.testing.assert_array_equal(
            b.view(twin).numpy().view(bits), a.view(bits), err_msg=k)


def test_registries_hold_the_same_archs():
    assert sorted(tconfigs.registry()) == sorted(ALL_ARCHS) \
        == sorted(jconfigs.registry())


@pytest.mark.parametrize("arch", ALL_ARCHS[len(ARCHS):])
def test_unported_families_refused(arch):
    """Every arch that was a config mirror when the port began now runs.
    The MoE archs run, and so would their dense counterparts (swiglu, and
    for grok-1 the gelu MLP); qwen2-vl runs on both paths; the hybrid
    Mamba2 family (zamba2) and whisper run on the whole-batch path, and
    the paged path refuses them as the JAX ``PagedEngine`` does."""
    from repro_torch.models.transformer import check_supported
    cfg = tconfigs.get(arch)
    if cfg.n_experts:
        check_supported(cfg)
        check_supported(cfg, paged=True)
        check_supported(dataclasses.replace(cfg, n_experts=0,
                                            family="dense"))
        return
    check_supported(cfg)
    if cfg.family == "hybrid":
        with pytest.raises(ValueError, match="SSM and hybrid archs"):
            check_supported(cfg, paged=True)
    elif cfg.is_encoder_decoder:
        with pytest.raises(ValueError, match="encoder-decoder"):
            check_supported(cfg, paged=True)
    else:
        check_supported(cfg, paged=True)


def test_bridge_rejects_wrong_shape():
    cfg_t = tconfigs.get("qwen2-0.5b").reduced()
    cfg_j = jconfigs.get("granite-8b").reduced()     # no qkv bias, untied
    pj = jax.tree.map(np.asarray, jget_model(cfg_j).init(jax.random.key(0)))
    with pytest.raises(ValueError):
        params_from_jax(pj, cfg_t, "cpu")


@pytest.mark.parametrize("arch", ARCHS + STUB_FRONTEND + HYBRID)
def test_init_params_matches_jax_schema(arch):
    cfg_j = jconfigs.get(arch).reduced()
    cfg_t = tconfigs.get(arch).reduced()
    want = _flat(jax.tree.map(lambda s: s, jget_model(cfg_j)
                              .abstract_params()))
    gen = torch.Generator().manual_seed(0)
    got = _flat(init_params(cfg_t, gen, "cpu"))
    assert got.keys() == want.keys()
    for k, s in want.items():
        assert tuple(got[k].shape) == s.shape, k
        assert got[k].dtype == JNP_TO_TORCH[jnp.dtype(s.dtype)], k


def test_init_kinds():
    cfg = dataclasses.replace(tconfigs.get("qwen2-0.5b").reduced(),
                              dtype="float32", d_model=256, d_ff=512)
    p = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert (p["ln_f"]["scale"] == 1).all() and (p["ln_f"]["bias"] == 0).all()
    assert (p["blocks"]["attn"]["bq"] == 0).all()
    assert abs(p["embed"].std().item() - 0.02) < 0.002
    w = p["blocks"]["ffn"]["w_down"]                 # fan-in d_ff
    assert abs(w.std().item() - 1 / math.sqrt(cfg.d_ff)) < 0.1 / math.sqrt(
        cfg.d_ff)
    again = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(again["embed"], p["embed"])   # seeded: reproducible
