"""The tensor-core GQA kernels' arithmetic order (``csrc/gqa_core.cu``),
modelled in plain PyTorch by ``kernels.paged_attention.gqa_split_model``,
against the JAX package's GQA references on the CPU (the jnp references
and the Pallas kernels with ``pipeline="off"`` in interpret mode), on the
same numpy inputs at small widths.

The model walks each slot's visible lines in chunks of
``GQA_CHUNK_PAGES`` pages and tiles of 16 lines with an online softmax
over the T * G rows of a KV head, each row masked past its own line
pos + t; folds the line scales of quantized pools into the scores and into
P; takes P as bf16 hi + lo; and merges the chunks' (m, l, acc) in chunk
order.  The card tests hold the kernels against this model as well as
against the plain versions.  Constants are read from the core's source, so
the two cannot drift.

Tolerance: atol = rtol = 5e-5.  The inputs are bf16 values held in
float32, so products are exact and only three things separate the model
from the float32 references: p as hi + lo keeps 2^-18 of each p's
relative error (at most ~2^-18 max|v| ~ 1.5e-5 on an output at |v| <= 4),
float32 sums in another order (~1e-6), and, with scales, the dequantizing
multiply moved after the dot product (one float32 rounding).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import paged_attention as jpa
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quantize as kvq

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "csrc" / "gqa_core.cu").read_text()
TOL = dict(atol=5e-5, rtol=5e-5)


def _int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE)
    assert m, name
    return int(m.group(1))


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 values, kept in float32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _case(seed, B, T, KV, G, hd, page, nb, lens, backed=True, q_std=1.0):
    """Queries (B, T, KV, G, hd), pools (P, page, KV, hd), tables and
    first-token positions: slot b holds lens[b] committed lines, its T
    query tokens at pos .. pos + T - 1; the drafts' lines past them are
    backed by pages, or on trash entries (``backed`` False).  ``lens``
    None: every slot idle (all entries trash page 0, pos 0)."""
    rng = np.random.default_rng(seed)
    P = 1 + B * nb
    q = _bf16(rng.standard_normal((B, T, KV, G, hd), dtype=np.float32)
              * q_std)
    kp, vp = (_bf16(rng.standard_normal((P, page, KV, hd), dtype=np.float32))
              for _ in range(2))
    bt = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    if lens is not None:
        free = list(rng.permutation(np.arange(1, P)))
        for b, n in enumerate(lens):
            lines = n + T - 1 if backed else n
            live = min(nb, -(-lines // page))
            bt[b, :live] = [free.pop() for _ in range(live)]
            pos[b] = n - 1
    return q, kp, vp, bt, pos


def _torch(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _jax(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _jax_codes(codes: torch.Tensor) -> jnp.ndarray:
    if codes.dtype == torch.int8:
        return jnp.asarray(codes.numpy())
    return jnp.asarray(codes.view(torch.uint8).numpy().view(
        ml_dtypes.float8_e4m3fn))


def test_constants_read_from_the_source():
    assert _int("kChunkPages") == tpa.GQA_CHUNK_PAGES == 1
    assert _int("kRows") == tpa.GQA_ROW_TILE == 64
    assert _int("kTileLines") == tpa.GQA_TILE_LINES == 16
    assert _int("kMaxStages") == tpa.RING_MAX_STAGES
    assert "HP = HD < 64 ? 64 : HD" in SOURCE
    # the workspace: (hd float32 sums + m, l) per (slot, KV head, row,
    # chunk), the chunks a table of n_blocks pages holds
    assert "max_chunks = (p.n_blocks + kChunkPages - 1) / kChunkPages" \
        in SOURCE
    assert tpa.gqa_workspace_bytes(4, 5, 8, 5, 33, 128) == (
        4 * 8 * 25 * 33 * 130 * 4)
    assert tpa.gqa_row_groups(4, 5, 8, 5) == 32
    assert tpa.gqa_row_groups(2, 9, 1, 8) == 4       # 72 rows: two tiles
    # a call is one kernel launch; the last block of a row group merges
    assert SOURCE.count("<<<") == 1
    assert "atomicAdd(counter, 1) == nc - 1" in SOURCE


@pytest.mark.parametrize("hd,quantized,page,want", [
    # qwen3 width: a chunk at page 16 is one tile, staged synchronously
    # as the off walk; at page 32 two tiles, at page 64 four
    (128, False, 16, 1), (128, True, 16, 1), (128, False, 32, 2),
    (128, True, 64, 4), (256, False, 64, 4), (256, True, 32, 2),
    # smoke widths at pages 4 and 8: a chunk is under one tile
    (16, False, 4, 1), (16, True, 8, 1), (32, False, 8, 1),
    (64, True, 64, 4),
])
def test_core_stages_fit_and_stay_in_a_chunk(hd, quantized, page, want):
    # the ring's stage count is the core's own shared memory
    # (Shape::smem_bytes): 1 KB of alignment, the queries' atoms, the
    # widened K and V tiles of a quantized pool, then the stages
    assert "1024 + kQBytes + (kQuant ? 2 * kTileBytes : 0)" in SOURCE
    assert ("kRawBytes = 2 * kTileLines * HD + 2 * kTileLines * 4"
            in SOURCE)
    assert "kStageBytes = kQuant ? kRawBytes : 2 * kTileBytes" in SOURCE
    stages = tpa.gqa_core_stages(hd, quantized, page)
    assert stages == want
    atoms = max(hd, 64) // 64
    tile = atoms * 16 * 128
    stage = 32 * hd + 128 if quantized else 2 * tile
    smem = 1024 + atoms * 64 * 128 + (2 * tile if quantized else 0)
    assert smem + stages * stage <= 227 * 1024


# (B, KV, G, hd, page, nb, lens): every head dim the core is built for;
# pos 0; lines on chunk edges (a chunk is a page); G 16, past the float32
# decode kernel's limit; every slot idle
DECODE_CASES = [
    (3, 2, 2, 16, 4, 5, (1, 9, 20)),
    (2, 2, 3, 32, 8, 4, (16, 17)),
    (2, 1, 8, 64, 16, 3, (32, 33)),
    (2, 2, 2, 128, 16, 4, (64, 1)),
    (2, 1, 2, 256, 16, 2, (32, 5)),
    (2, 1, 16, 32, 8, 3, (24, 7)),
    (2, 2, 2, 16, 4, 5, None),
]


@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
@pytest.mark.parametrize("B,KV,G,hd,page,nb,lens", DECODE_CASES)
def test_split_model_matches_jax_decode(B, KV, G, hd, page, nb, lens,
                                        soft_cap):
    q, kp, vp, bt, pos = _case(B * 100 + hd + G, B, 1, KV, G, hd, page, nb,
                               lens, q_std=4.0 if soft_cap else 1.0)
    kw = dict(scale=hd ** -0.5, soft_cap=soft_cap)
    want = jpa.paged_attention_reference(*_jax(q[:, 0], kp, vp, bt, pos),
                                         **kw)
    got = tpa.gqa_split_model(*_torch(q[:, 0], kp, vp, bt, pos), **kw)
    assert got.shape == (B, KV, G, hd) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (B, T, KV, G, hd, page, nb, lens, backed): chains crossing pages and
# chunks from pos 0; a chain past the table (24 lines); the drafts on
# trash entries; 72 rows of one (slot, KV head), past one 64-row tile;
# every slot idle
VERIFY_CASES = [
    (3, 4, 2, 2, 16, 4, 5, (1, 14, 30), True),
    (2, 5, 2, 5, 32, 8, 3, (20, 23), True),
    (2, 5, 2, 5, 32, 8, 3, (20, 10), False),
    (2, 9, 1, 8, 64, 16, 2, (3, 20), True),
    (2, 3, 2, 2, 128, 16, 3, None, True),
]


@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
@pytest.mark.parametrize("B,T,KV,G,hd,page,nb,lens,backed", VERIFY_CASES)
def test_split_model_matches_jax_verify(B, T, KV, G, hd, page, nb, lens,
                                        backed, soft_cap):
    q, kp, vp, bt, pos = _case(B * 10 + T + hd, B, T, KV, G, hd, page, nb,
                               lens, backed, q_std=4.0 if soft_cap else 1.0)
    kw = dict(scale=hd ** -0.5, soft_cap=soft_cap)
    want = jpa.paged_attention_verify_reference(*_jax(q, kp, vp, bt, pos),
                                                **kw)
    got = tpa.gqa_split_model(*_torch(q, kp, vp, bt, pos), **kw)
    assert got.shape == (B, T, KV, G, hd)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("soft_cap", [0.0, 20.0])
def test_split_model_matches_pallas_off_walks(soft_cap):
    # the Pallas kernels with pipeline="off" in interpret mode, decode and
    # verify, at the reference's smoke widths (its "double" walk fails
    # under this jax)
    q, kp, vp, bt, pos = _case(41, 3, 4, 2, 2, 16, 4, 5, (1, 9, 18),
                               q_std=4.0 if soft_cap else 1.0)
    kw = dict(scale=0.25, soft_cap=soft_cap)
    want = jpa.paged_attention(*_jax(q[:, 0], kp, vp, bt, pos), **kw,
                               interpret=True, pipeline="off")
    got = tpa.gqa_split_model(*_torch(q[:, 0], kp, vp, bt, pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jpa.paged_attention_verify(*_jax(q, kp, vp, bt, pos), **kw,
                                      interpret=True, pipeline="off")
    got = tpa.gqa_split_model(*_torch(q, kp, vp, bt, pos), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("T", [1, 3])
def test_split_model_with_scales_matches_jax(kv_dtype, T):
    q, kp, vp, bt, pos = _case(7 + T, 3, T, 2, 3, 32, 8, 5, (1, 16, 33))
    (kq, ks), (vq, vs) = (kvq.quantize(torch.from_numpy(a), kv_dtype)
                          for a in (kp, vp))
    jargs = (jnp.asarray(q), _jax_codes(kq), _jax_codes(vq), *_jax(bt, pos))
    jkw = dict(scale=32 ** -0.5, k_scale=jnp.asarray(ks.numpy()),
               v_scale=jnp.asarray(vs.numpy()))
    targs = (torch.from_numpy(q), kq, vq, *_torch(bt, pos))
    tkw = dict(scale=32 ** -0.5, k_scale=ks, v_scale=vs)
    if T == 1:
        want = jpa.paged_attention_reference(jargs[0][:, 0], *jargs[1:],
                                             **jkw)
        got = tpa.gqa_split_model(targs[0][:, 0], *targs[1:], **tkw)
        pallas = jpa.paged_attention(jargs[0][:, 0], *jargs[1:], **jkw,
                                     interpret=True, pipeline="off")
    else:
        want = jpa.paged_attention_verify_reference(*jargs, **jkw)
        got = tpa.gqa_split_model(*targs, **tkw)
        pallas = jpa.paged_attention_verify(*jargs, **jkw, interpret=True,
                                            pipeline="off")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def test_split_model_t1_equals_decode_bit_for_bit():
    q, kp, vp, bt, pos = _case(5, 3, 1, 2, 5, 64, 8, 6, (1, 17, 40))
    for kw in (dict(scale=0.125), dict(scale=0.125, soft_cap=30.0)):
        dec = tpa.gqa_split_model(*_torch(q[:, 0], kp, vp, bt, pos), **kw)
        ver = tpa.gqa_split_model(*_torch(q, kp, vp, bt, pos), **kw)[:, 0]
        assert torch.equal(dec, ver)


def test_split_model_chunks_depend_only_on_the_visible_lines():
    # the same visible lines under a wider table (trash entries past the
    # slot's pages): equal bytes, decode and verify; the rows of a verify
    # slab whose lines end before the last chunk equal a shorter walk's
    q, kp, vp, bt, pos = _case(3, 2, 3, 2, 2, 32, 8, 4, (20, 9))
    wide = np.concatenate([bt, np.zeros((2, 5), np.int32)], axis=1)
    for qq in (q[:, 0], q):
        got = tpa.gqa_split_model(*_torch(qq, kp, vp, bt, pos), scale=0.2)
        got_wide = tpa.gqa_split_model(*_torch(qq, kp, vp, wide, pos),
                                       scale=0.2)
        assert torch.equal(got, got_wide)
    # slot 0 at pos 19 with T 3 walks 22 lines (three chunks of 8); its
    # first token sees 20 of them, as a decode at pos 19 does
    ver = tpa.gqa_split_model(*_torch(q, kp, vp, bt, pos), scale=0.2)
    dec = tpa.gqa_split_model(*_torch(q[:, 0], kp, vp, bt, pos), scale=0.2)
    np.testing.assert_allclose(ver[:, 0].numpy(), dec.numpy(), **TOL)


@pytest.mark.parametrize("pos,T,page,nb,G,KV,want", [
    # chip_smoke.py's row 3 (qwen3-14b verify, k 4) at its committed
    # lines: 101 / 167 / 194 / 233 lines in chunks of 16
    ((96, 162, 189, 228), 5, 16, 33, 5, 8, (16, 1056, 368, 32)),
    # its row 1 shape (qwen3-0.6b decode, 32 blocks) at the same lines
    ((96, 162, 189, 228), 1, 16, 32, 2, 8, (16, 1024, 360, 32)),
    # one page: one chunk, written directly, no merge
    ((0, 15), 1, 16, 32, 2, 8, (16, 512, 16, 0)),
    # 72 rows of a KV head: two row tiles; 12 lines, one chunk written
    # directly, and 29 lines, two chunks merged
    ((3, 20), 9, 16, 2, 8, 1, (16, 8, 6, 2)),
])
def test_split_plan_counts_the_blocks(pos, T, page, nb, G, KV, want):
    plan = tpa.gqa_split_plan(pos, T, page, nb, G, KV)
    assert (plan["chunk_lines"], plan["grid"], plan["blocks"],
            plan["merges"]) == want
