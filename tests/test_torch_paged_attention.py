"""The port's plain paged-attention decodes (GQA and MLA) against the JAX
package's jnp references and its Pallas kernels (interpret mode,
``pipeline="off"``), on the same numpy inputs; plus the device dispatch
and the pricing helpers.

Tolerance: the repo's kernel tolerance, rtol=2e-5 / atol=2e-6 at float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro.kernels import quantize as jq
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-6)


def _inputs(seed, B, KV, G, hd, page, nb, trash=False, q_scale=1.0):
    rng = np.random.RandomState(seed)
    P = 1 + B * nb
    q = rng.standard_normal((B, KV, G, hd)).astype(np.float32) * q_scale
    kp = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, page, KV, hd)).astype(np.float32)
    bt = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    if not trash:
        free = list(range(1, P))
        for b in range(B):
            live = rng.randint(1, nb + 1)
            for j in range(live):
                bt[b, j] = free.pop()
            pos[b] = rng.randint(0, live * page)
    return q, kp, vp, bt, pos


def _three_ways(args, **kw):
    ja = [jnp.asarray(a) for a in args]
    want_jnp = np.asarray(jpa.paged_attention_reference(*ja, **kw))
    want_pallas = np.asarray(jpa.paged_attention(*ja, **kw, interpret=True,
                                                 pipeline="off"))
    got = ops.paged_attention(*[torch.from_numpy(a) for a in args], **kw)
    return got.numpy(), want_jnp, want_pallas


@pytest.mark.parametrize("B,KV,G,hd,page,nb", [
    (3, 2, 2, 16, 4, 5),      # GQA, odd block count
    (2, 4, 1, 32, 8, 3),      # MHA (G=1)
    (4, 1, 8, 64, 16, 2),     # single KV head
])
def test_reference_matches_jax_reference_and_pallas(B, KV, G, hd, page, nb):
    args = _inputs(B * 7 + nb, B, KV, G, hd, page, nb)
    got, want_jnp, want_pallas = _three_ways(args, scale=hd ** -0.5)
    np.testing.assert_allclose(got, want_jnp, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def test_reference_soft_cap_matches():
    args = _inputs(11, 2, 2, 2, 16, 4, 3, q_scale=4.0)
    got, want_jnp, want_pallas = _three_ways(args, scale=0.25, soft_cap=30.0)
    np.testing.assert_allclose(got, want_jnp, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def test_reference_idle_trash_lanes_finite_and_equal():
    args = _inputs(5, 2, 2, 2, 16, 4, 3, trash=True)
    got, want_jnp, want_pallas = _three_ways(args, scale=0.25)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_jnp, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def _int8_pools(args, first_pool):
    """The arrays of ``args`` with the two pools from ``first_pool`` on
    quantized to int8 by the reference; returns (numpy args, {scale kwarg
    suffix index: scales})."""
    args = list(args)
    scales = []
    for i in (first_pool, first_pool + 1):
        q, s = jq.quantize(jnp.asarray(args[i]), "int8", -1)
        args[i] = np.asarray(q)
        scales.append(np.asarray(s))
    return args, scales


def test_cpu_tensors_dispatch_to_plain_version_and_kernel_refuses_them():
    args = [torch.from_numpy(a) for a in _inputs(3, 2, 2, 2, 16, 4, 3)]
    assert ops.resolve("paged_attention", torch.device("cpu")) is \
        tpa.paged_attention_reference
    assert ops.resolve("paged_attention", torch.device("cuda")) is \
        tpa.paged_attention
    n = tpa.paged_attention.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpa.paged_attention(*args, scale=0.25)
    ops.paged_attention(*args, scale=0.25)
    assert tpa.paged_attention.launches == n     # the plain version ran
    # scale pools: the plain version dequantizes int8 pools as repro's
    # jnp reference does
    qargs, (ks, vs) = _int8_pools(_inputs(3, 2, 2, 2, 16, 4, 3), 1)
    want = jpa.paged_attention_reference(
        *[jnp.asarray(a) for a in qargs], scale=0.25, k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    got = tpa.paged_attention_reference(
        *[torch.from_numpy(a) for a in qargs], scale=0.25,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ctx,page,n_q,pipeline", [
    (1, 16, 1, "off"), (17, 16, 1, "off"), (256, 16, 1, "off"),
    (100, 8, 5, "off"), (100, 8, 5, "double"), (33, 4, 1, "double")])
def test_pricing_helpers_equal_reference(ctx, page, n_q, pipeline):
    assert tpa.live_blocks(ctx, page, n_q) == jpa.live_blocks(ctx, page, n_q)
    kw = dict(context_len=ctx, page_size=page, n_heads=16, kv_heads=8,
              head_dim=128, isize=2, n_q=n_q, pipeline=pipeline)
    assert tpa.paged_decode_vmem_bytes(**kw) == \
        jpa.paged_decode_vmem_bytes(**kw)
    assert tpa.paged_decode_vmem_bytes(**kw, kv_isize=1, scale_isize=4) == \
        jpa.paged_decode_vmem_bytes(**kw, kv_isize=1, scale_isize=4)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------

def _mla_inputs(seed, B, H, r, dr, page, nb, trash=False):
    rng = np.random.RandomState(seed)
    P = 1 + B * nb
    ql = rng.standard_normal((B, H, r)).astype(np.float32)
    qr = rng.standard_normal((B, H, dr)).astype(np.float32)
    cp = rng.standard_normal((P, page, r)).astype(np.float32)
    rp = rng.standard_normal((P, page, dr)).astype(np.float32)
    bt = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    if not trash:
        free = list(range(1, P))
        for b in range(B):
            live = rng.randint(1, nb + 1)
            for j in range(live):
                bt[b, j] = free.pop()
            pos[b] = rng.randint(0, live * page)
    return ql, qr, cp, rp, bt, pos


def _mla_three_ways(args, **kw):
    ja = [jnp.asarray(a) for a in args]
    want_jnp = np.asarray(jpa.mla_paged_attention_reference(*ja, **kw))
    want_pallas = np.asarray(jpa.mla_paged_attention(
        *ja, **kw, interpret=True, pipeline="off"))
    got = ops.mla_paged_attention(*[torch.from_numpy(a) for a in args], **kw)
    return got.numpy(), want_jnp, want_pallas


@pytest.mark.parametrize("B,H,r,dr,page,nb,trash", [
    (3, 4, 32, 8, 4, 5, False),      # smoke widths, ragged tables
    (2, 8, 64, 16, 8, 3, False),
    (4, 2, 128, 32, 16, 2, False),
    (3, 4, 32, 8, 4, 3, True),       # idle lanes: every entry trash page 0
])
def test_mla_reference_matches_jax_reference_and_pallas(B, H, r, dr, page,
                                                        nb, trash):
    args = _mla_inputs(B * 11 + r, B, H, r, dr, page, nb, trash=trash)
    got, want_jnp, want_pallas = _mla_three_ways(args, scale=192 ** -0.5)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want_jnp, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def test_mla_cpu_tensors_dispatch_to_plain_version_and_kernel_refuses():
    args = [torch.from_numpy(a)
            for a in _mla_inputs(3, 2, 4, 32, 8, 4, 3)]
    assert ops.resolve("mla_paged_attention", torch.device("cpu")) is \
        tpa.mla_paged_attention_reference
    assert ops.resolve("mla_paged_attention", torch.device("cuda")) is \
        tpa.mla_paged_attention
    n = tpa.mla_paged_attention.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpa.mla_paged_attention(*args, scale=0.1)
    ops.mla_paged_attention(*args, scale=0.1)
    assert tpa.mla_paged_attention.launches == n  # the plain version ran
    # scale pools: the plain version dequantizes as repro's reference; the
    # kernel still refuses CPU tensors
    qargs, (cs, rs) = _int8_pools(_mla_inputs(3, 2, 4, 32, 8, 4, 3), 2)
    want = jpa.mla_paged_attention_reference(
        *[jnp.asarray(a) for a in qargs], scale=0.1, c_scale=jnp.asarray(cs),
        r_scale=jnp.asarray(rs))
    targs = [torch.from_numpy(a) for a in qargs]
    tkw = dict(c_scale=torch.from_numpy(cs), r_scale=torch.from_numpy(rs))
    got = tpa.mla_paged_attention_reference(*targs, scale=0.1, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tpa.mla_paged_attention(*targs, scale=0.1, **tkw)


@pytest.mark.parametrize("ctx,page,n_q,pipeline", [
    (1, 16, 1, "off"), (679, 16, 1, "off"), (100, 8, 5, "double")])
def test_mla_pricing_helper_equals_reference(ctx, page, n_q, pipeline):
    kw = dict(context_len=ctx, page_size=page, n_heads=128, lora_rank=512,
              rope_dim=64, isize=2, n_q=n_q, pipeline=pipeline)
    assert tpa.mla_paged_decode_vmem_bytes(**kw) == \
        jpa.mla_paged_decode_vmem_bytes(**kw)
    assert tpa.mla_paged_decode_vmem_bytes(**kw, kv_isize=1,
                                           scale_isize=4) == \
        jpa.mla_paged_decode_vmem_bytes(**kw, kv_isize=1, scale_isize=4)
