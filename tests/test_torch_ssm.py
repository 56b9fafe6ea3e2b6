"""The port's Mamba1 layers (``repro_torch.models.ssm``) and the
selective-scan wrapper against the JAX package, on the CPU.

Same inputs (numpy, from a seed) and the same weights (falcon-mamba-7b
``.reduced()`` in f32, bridged bit-exact from the JAX tree) go through
both.  Tolerances: the scans within rtol = atol = 2e-5, as
``tests/test_ssm_scan_kernel.py`` holds the Pallas kernel against the jnp
scan (f32, only the order of the N-sums and the exp implementations
differ); the blocks within 1e-4, as the port's dense layers are held
(f32 matmuls summed in another order in each framework).

The prefill state — which the JAX ``mamba1_block`` computes and drops —
is held against the JAX package's own single-step recurrence
(``mamba1_block`` with a state) stepped over the same inputs from zero.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import configs as jconfigs
from repro.kernels.ssm_scan.scan import selective_scan_fwd
from repro.models import get_model as jget_model
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch.kernels.ssm_scan import scan as tscan
from repro_torch.models import ssm as tssm
from repro_torch.models.params import params_from_jax
from repro_torch.models.transformer import layer_params

SCAN_TOL = dict(rtol=2e-5, atol=2e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "falcon-mamba-7b"

_jscan = jax.jit(lambda x, dt, A, Bc, Cc: jssm.mamba1_scan(x, dt, A, Bc, Cc,
                                                           chunk=1))


def _scan_inputs(B, S, d_in, N, seed=0, dbc=False):
    """x, dt, A, Bc, Cc as numpy f32, scaled as the JAX kernel test's (dt
    a softplus of a shifted normal, A = -exp(normal * 0.3)).  With
    ``dbc`` Bc and Cc are column slices of one (B, S, 4 + 2N) array, as
    the model's x_proj output is sliced."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, d_in), np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, d_in), np.float32)
                         * 0.5 - 1.0)).astype(np.float32)
    A = -np.exp(rng.standard_normal((d_in, N), np.float32) * 0.3)
    if dbc:
        full = rng.standard_normal((B, S, 4 + 2 * N), np.float32)
        return x, dt, A, full[..., 4:4 + N], full[..., 4 + N:]
    return (x, dt, A, rng.standard_normal((B, S, N), np.float32),
            rng.standard_normal((B, S, N), np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("S", [1, 2, 3, 9])
def test_causal_conv_and_conv_step_match_jax(S):
    """The shift-and-add causal conv over S tokens, and one step from a
    random state (S < K - 1 included)."""
    rng = np.random.default_rng(S)
    B, C, K = 2, 12, 4
    x = rng.standard_normal((B, S, C), np.float32)
    w = rng.standard_normal((C, K), np.float32)
    b = rng.standard_normal((C,), np.float32)
    st_ = rng.standard_normal((B, K - 1, C), np.float32)
    want = jssm.causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tssm.causal_conv(*_t(x, w, b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jy, jst = jssm.conv_step(jnp.asarray(x[:, 0]), jnp.asarray(st_),
                             jnp.asarray(w), jnp.asarray(b))
    ty, tst = tssm.conv_step(*_t(x[:, 0], st_, w, b))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("B,S,d_in,N", [(1, 64, 128, 16), (2, 37, 40, 8),
                                        (2, 1, 16, 16)])
def test_mamba1_scan_matches_jax(B, S, d_in, N):
    """The plain scan against the JAX ``mamba1_scan``, including an S that
    is a multiple of no chunk and a single step."""
    ins = _scan_inputs(B, S, d_in, N, seed=S)
    jy, jh = _jscan(*map(jnp.asarray, ins))
    ty, th = tssm.mamba1_scan(*_t(*ins))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)


@pytest.mark.parametrize("B,S,d_in,N,bd,c", [
    (1, 64, 128, 16, 128, 32),
    (2, 128, 256, 16, 128, 64),
    (1, 96, 128, 8, 128, 32),
])
def test_plain_scan_matches_pallas_interpret(B, S, d_in, N, bd, c):
    """The plain scan against the Pallas kernel in interpret mode, at the
    JAX kernel test's shapes: y and h_final."""
    ins = _scan_inputs(B, S, d_in, N, seed=B + S)
    jy, jh = selective_scan_fwd(*map(jnp.asarray, ins), block_d=bd, chunk=c,
                                interpret=True)
    ty, th = tssm.mamba1_scan(*_t(*ins))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)


@settings(max_examples=6, deadline=None)
@given(B=st.integers(1, 2), nc=st.integers(1, 3),
       c=st.sampled_from([16, 32]), N=st.sampled_from([8, 16]),
       seed=st.integers(0, 2**30))
def test_plain_scan_property_against_pallas(B, nc, c, N, seed):
    ins = _scan_inputs(B, nc * c, 128, N, seed=seed)
    jy, jh = selective_scan_fwd(*map(jnp.asarray, ins), block_d=128, chunk=c,
                                interpret=True)
    ty, th = tssm.mamba1_scan(*_t(*ins))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)


def test_mamba1_step_matches_jax():
    rng = np.random.default_rng(5)
    B, d_in, N = 3, 24, 8
    x_t, dt_t = (rng.standard_normal((B, d_in), np.float32) for _ in "ab")
    dt_t = np.abs(dt_t) * 0.1
    A = -np.exp(rng.standard_normal((d_in, N), np.float32))
    B_t, C_t = (rng.standard_normal((B, N), np.float32) for _ in "ab")
    h = rng.standard_normal((B, d_in, N), np.float32)
    jy, jh = jssm.mamba1_step(*map(jnp.asarray, (x_t, dt_t, A, B_t, C_t, h)))
    ty, th = tssm.mamba1_step(*_t(x_t, dt_t, A, B_t, C_t, h))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)


def _mixer(seed=2):
    """Layer 0's mixer parameters of falcon-mamba-7b ``.reduced()`` in f32,
    as the JAX tree and as the port's bridged copy."""
    jcfg = dataclasses.replace(jconfigs.get(ARCH).reduced(), dtype="float32")
    tcfg = dataclasses.replace(tconfigs.get(ARCH).reduced(), dtype="float32")
    jp = jax.tree.map(np.asarray, jget_model(jcfg).init(jax.random.key(seed)))
    tp = params_from_jax(jp, tcfg, "cpu")
    jmix = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["blocks"]["mixer"])
    return jcfg, jmix, tcfg, layer_params(tp["blocks"], 0)["mixer"]


@pytest.fixture(scope="module")
def mixer():
    return _mixer()


def _jstep_over(jcfg, jmix, x):
    """The JAX package's own recurrence: ``mamba1_block`` with a state,
    stepped over every token of x from a zero state.  Returns (outs (B, S,
    d), final state)."""
    B, S, d = x.shape
    d_in = d * jcfg.ssm_expand
    state = jssm.Mamba1State(
        conv=jnp.zeros((B, jcfg.ssm_conv - 1, d_in), jnp.float32),
        ssm=jnp.zeros((B, d_in, jcfg.ssm_state), jnp.float32))
    step = jax.jit(partial(jssm.mamba1_block, cfg=jcfg))
    outs = []
    for t in range(S):
        out, state = step(jnp.asarray(x[:, t:t + 1]), jmix, state=state)
        outs.append(np.asarray(out))
    return np.concatenate(outs, axis=1), state


@pytest.mark.parametrize("S", [1, 2, 7])
def test_mamba1_block_prefill_matches_jax(mixer, S):
    """Prefill output against the JAX block's; the state it returns (the
    JAX block returns None) against the JAX recurrence stepped over the
    same tokens: h_fin, and the conv tail, zero-padded when S < K - 1."""
    jcfg, jmix, tcfg, tmix = mixer
    x = np.random.default_rng(S).standard_normal((2, S, jcfg.d_model),
                                                 np.float32)
    jout, jstate = jax.jit(partial(jssm.mamba1_block, cfg=jcfg))(
        jnp.asarray(x), jmix)
    assert jstate is None
    tout, tstate = tssm.mamba1_block(torch.from_numpy(x), tmix, tcfg)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    souts, sstate = _jstep_over(jcfg, jmix, x)
    np.testing.assert_allclose(tout.numpy(), souts, **TOL)
    np.testing.assert_allclose(tstate.ssm.numpy(), np.asarray(sstate.ssm),
                               **TOL)
    np.testing.assert_allclose(tstate.conv.numpy(), np.asarray(sstate.conv),
                               **TOL)
    if S < jcfg.ssm_conv - 1:
        assert (tstate.conv[:, :jcfg.ssm_conv - 1 - S] == 0).all()


def test_mamba1_block_decode_matches_jax(mixer):
    """Three decode steps from a random state: outputs and states."""
    jcfg, jmix, tcfg, tmix = mixer
    rng = np.random.default_rng(11)
    B, d = 2, jcfg.d_model
    d_in = d * jcfg.ssm_expand
    conv = rng.standard_normal((B, jcfg.ssm_conv - 1, d_in), np.float32)
    h = rng.standard_normal((B, d_in, jcfg.ssm_state), np.float32)
    jst = jssm.Mamba1State(conv=jnp.asarray(conv), ssm=jnp.asarray(h))
    tst = tssm.Mamba1State(*_t(conv, h))
    step = jax.jit(partial(jssm.mamba1_block, cfg=jcfg))
    for i in range(3):
        x = rng.standard_normal((B, 1, d), np.float32)
        jout, jst = step(jnp.asarray(x), jmix, state=jst)
        tout, tst = tssm.mamba1_block(torch.from_numpy(x), tmix, tcfg, tst)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
        np.testing.assert_allclose(tst.ssm.numpy(), np.asarray(jst.ssm),
                                   **TOL)
        np.testing.assert_allclose(tst.conv.numpy(), np.asarray(jst.conv),
                                   **TOL)


def test_plain_flag_and_wrapper_agree_on_cpu(mixer):
    """On CPU tensors the wrapper is the plain scan (no launch), so the
    block's kernel path and plain path are equal."""
    _, _, tcfg, tmix = mixer
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 9, tcfg.d_model), np.float32))
    n0 = tscan.KERNEL.launches
    a, sa = tssm.mamba1_block(x, tmix, tcfg)
    b, sb = tssm.mamba1_block(x, tmix, tcfg, plain=True)
    assert torch.equal(a, b) and torch.equal(sa.ssm, sb.ssm)
    assert torch.equal(sa.conv, sb.conv) and tscan.KERNEL.launches == n0


def test_wrapper_takes_strided_views_on_cpu():
    """B and C as column slices of one array, as the model passes them."""
    ins = _scan_inputs(2, 21, 40, 16, seed=9, dbc=True)
    x, dt, A, Bc, Cc = _t(*ins[:3]) + [torch.from_numpy(np.asarray(a))
                                       for a in ins[3:]]
    assert Bc.stride(-1) == 1 and not Bc.is_contiguous()
    ty, th = tscan.selective_scan(x, dt, A, Bc, Cc)
    jy, jh = _jscan(*map(jnp.asarray, ins))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **SCAN_TOL)


def _layout_args(**over):
    x, dt, A, Bc, Cc = _t(*_scan_inputs(2, 5, 16, 8, seed=1))
    args = dict(x=x, dt=dt, A=A, Bc=Bc, Cc=Cc)
    args.update(over)
    return args


@pytest.mark.parametrize("bad", [
    "N", "A_dtype", "dt_shape", "x_dtype", "Bc_stride", "Cc_dtype",
    "x_strided", "empty"])
def test_scan_layout_refuses(bad):
    """What the kernel does not take is refused before any launch."""
    a = _layout_args()
    if bad == "N":
        a = _layout_args(**dict(zip(("x", "dt", "A", "Bc", "Cc"),
                                    _t(*_scan_inputs(2, 5, 16, 4)))))
    elif bad == "A_dtype":
        a["A"] = a["A"].double()
    elif bad == "dt_shape":
        a["dt"] = a["dt"][:, :4].contiguous()
    elif bad == "x_dtype":
        a["x"] = a["x"].bfloat16()
    elif bad == "Bc_stride":
        a["Bc"] = a["Bc"].transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "Cc_dtype":
        a["Cc"] = a["Cc"].bfloat16()
    elif bad == "x_strided":
        a["x"] = a["x"].transpose(0, 1).contiguous().transpose(0, 1)
    else:
        a = _layout_args(**dict(zip(("x", "dt", "A", "Bc", "Cc"),
                                    _t(*_scan_inputs(2, 0, 16, 8)))))
    with pytest.raises(ValueError, match="selective scan"):
        tscan.scan_layout(**a)
    with pytest.raises(ValueError, match="CUDA device"):
        tscan.check_scan(**_layout_args())
    shape = tscan.scan_layout(**_layout_args())
    assert shape == (2, 5, 16, 8)
