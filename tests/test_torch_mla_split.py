"""The tensor-core MLA kernels' arithmetic order (``csrc/mla_core.cu``),
modelled in plain PyTorch by ``kernels.paged_attention.mla_split_model``,
against the JAX package's MLA references on the CPU, on the same numpy
inputs at small widths.

The model walks each (slot, token) row's visible lines in chunks of
``MLA_CHUNK_PAGES`` pages, tiles of 16 lines with an online softmax,
folds the line scales of quantized pools into the scores and into P, takes
P as bf16 hi + lo, and merges the chunks' (m, l, acc) in chunk order.  The
card tests hold the kernels against this model as well as against the
plain versions.  Constants are read from the core's source, so the two
cannot drift.

Tolerance: atol = rtol = 5e-5.  The inputs are bf16 values held in
float32, so products are exact and only three things separate the model
from the float32 reference: p as hi + lo keeps 2^-18 of each p's relative
error (at most ~2^-18 max|c| ~ 1.5e-5 on an output at |c| <= 4), float32
sums in another order (~1e-6), and, with scales, the dequantizing
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

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "csrc" / "mla_core.cu").read_text()
TOL = dict(atol=5e-5, rtol=5e-5)
SCALE = 192 ** -0.5


def _int(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", HEADER)
    assert m, name
    return int(m.group(1))


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 values, kept in float32."""
    return torch.from_numpy(a).bfloat16().float().numpy()


def _case(seed, B, T, H, r, dr, page, nb, lens):
    """Queries (B, T, H, r / dr), pools, tables and first-token positions;
    slot b holds lens[b] visible lines for its first token (None: every
    slot idle, all entries trash page 0, pos 0)."""
    rng = np.random.default_rng(seed)
    P = 1 + B * nb
    ql, qr = (_bf16(rng.standard_normal((B, T, H, d), dtype=np.float32)
                    * 0.5) for d in (r, dr))
    c, kr = (_bf16(rng.standard_normal((P, page, d), dtype=np.float32))
             for d in (r, dr))
    bt = np.zeros((B, nb), np.int32)
    pos = np.zeros((B,), np.int32)
    if lens is not None:
        free = list(rng.permutation(np.arange(1, P)))
        for b, n in enumerate(lens):
            live = min(nb, -(-(n + T - 1) // page))
            bt[b, :live] = [free.pop() for _ in range(live)]
            pos[b] = n - 1
    return ql, qr, c, kr, bt, pos


def _torch(*arrs):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)


def _jax(*arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def test_constants_read_from_the_header():
    assert _int("kChunkPages") == tpa.MLA_CHUNK_PAGES
    assert _int("kHeads") == tpa.MLA_HEAD_TILE
    assert _int("kTileLines") == 16 == tpa.MLA_RING_TILE_LINES
    assert _int("kMaxStages") == tpa.RING_MAX_STAGES
    assert "NO = RP < 256 ? RP : 256" in HEADER
    assert tpa.MLA_COLUMN_PART == 256
    # the workspace: (r float32 sums + m, l) per (row, chunk, head)
    assert "chunks * n_heads * (r + 2) * 4" in HEADER
    assert tpa.mla_workspace_bytes(4, 17, 128, 512) == 4 * 9 * 128 * 514 * 4
    # a call launches the split and the merge kernel
    assert HEADER.count("<<<") == 2 == tpa.MLA_CORE_LAUNCHES
    assert tpa.mla_launches_per_call(torch.bfloat16) == 2
    assert tpa.mla_launches_per_call(torch.float32) == 1


@pytest.mark.parametrize("r,dr,quantized,page,want", [
    # deepseek-v2 width: a chunk at page 16 is 2 tiles, at page 32 four
    (512, 64, False, 16, 2), (512, 64, True, 16, 2), (512, 64, False, 32, 4),
    (512, 64, True, 32, 4),
    # smoke width at page 8: a chunk is one tile, staged synchronously
    (32, 8, False, 8, 1), (32, 8, True, 8, 1), (128, 32, False, 16, 2),
])
def test_core_stages_fit_and_stay_in_a_chunk(r, dr, quantized, page, want):
    # the ring's stage count is the core's own shared memory
    # (Shape::smem_bytes): 1 KB of alignment, the queries' atoms, the
    # widened tile of a quantized pool, then the stages
    assert "1024 + kQBytes + (kQuant ? kTileBytes : 0)" in HEADER
    assert ("kRawBytes = kTileLines * (R + DR) + 2 * kTileLines * 4"
            in HEADER)
    stages = tpa.mla_core_stages(r, dr, quantized, page)
    assert stages == want
    atoms = -(-r // 64) + 1
    tile = atoms * 16 * 128
    stage = 16 * (r + dr) + 128 if quantized else tile
    smem = 1024 + atoms * 64 * 128 + (tile if quantized else 0)
    assert smem + stages * stage <= 227 * 1024


# (B, H, r, dr, page, nb, lens): smoke widths; heads past a multiple of
# 8; lines exactly on chunk edges (chunk = 2 pages), one line, a full
# table; every slot idle
DECODE_CASES = [
    (3, 4, 32, 8, 8, 4, (1, 9, 20)),
    (3, 12, 64, 16, 16, 3, (32, 33, 48)),
    (2, 8, 128, 32, 8, 6, (16, 48)),
    (2, 5, 256, 64, 32, 2, (1, 64)),
    (2, 4, 32, 8, 8, 4, None),
]


@pytest.mark.parametrize("B,H,r,dr,page,nb,lens", DECODE_CASES)
def test_split_model_matches_jax_decode(B, H, r, dr, page, nb, lens):
    ql, qr, c, kr, bt, pos = _case(B * 100 + r + dr, B, 1, H, r, dr, page,
                                   nb, lens)
    want = jpa.mla_paged_attention_reference(
        *_jax(ql[:, 0], qr[:, 0], c, kr, bt, pos), scale=SCALE)
    got = tpa.mla_split_model(*_torch(ql[:, 0], qr[:, 0], c, kr, bt, pos),
                              scale=SCALE)
    assert got.shape == (B, H, r) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,T,H,r,dr,page,nb,lens", [
    (3, 3, 4, 32, 8, 8, 5, (1, 14, 30)),     # chains across chunk edges
    (2, 4, 12, 64, 16, 16, 3, (29, 45)),     # and past the table
    (2, 2, 8, 128, 64, 32, 2, (63, 1)),
])
def test_split_model_matches_jax_verify(B, T, H, r, dr, page, nb, lens):
    ql, qr, c, kr, bt, pos = _case(B * 10 + T + r, B, T, H, r, dr, page,
                                   nb, lens)
    want = jpa.mla_paged_attention_verify_reference(
        *_jax(ql, qr, c, kr, bt, pos), scale=SCALE)
    got = tpa.mla_split_model(*_torch(ql, qr, c, kr, bt, pos), scale=SCALE)
    assert got.shape == (B, T, H, r)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_codes(codes: torch.Tensor) -> jnp.ndarray:
    if codes.dtype == torch.int8:
        return jnp.asarray(codes.numpy())
    return jnp.asarray(codes.view(torch.uint8).numpy().view(
        ml_dtypes.float8_e4m3fn))


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("T", [1, 3])
def test_split_model_with_scales_matches_jax(kv_dtype, T):
    ql, qr, c, kr, bt, pos = _case(7 + T, 3, T, 6, 64, 8, 8, 5,
                                   (1, 16, 33))
    (cq, cs), (rq, rs) = (kvq.quantize(torch.from_numpy(a), kv_dtype)
                          for a in (c, kr))
    jargs = (*_jax(ql, qr), _jax_codes(cq), _jax_codes(rq), *_jax(bt, pos))
    jkw = dict(scale=SCALE, c_scale=jnp.asarray(cs.numpy()),
               r_scale=jnp.asarray(rs.numpy()))
    targs = (*_torch(ql, qr), cq, rq, *_torch(bt, pos))
    tkw = dict(scale=SCALE, c_scale=cs, r_scale=rs)
    if T == 1:
        want = jpa.mla_paged_attention_reference(
            *(a[:, 0] for a in jargs[:2]), *jargs[2:], **jkw)
        got = tpa.mla_split_model(*(a[:, 0] for a in targs[:2]),
                                  *targs[2:], **tkw)
    else:
        want = jpa.mla_paged_attention_verify_reference(*jargs, **jkw)
        got = tpa.mla_split_model(*targs, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_split_model_chunks_depend_only_on_the_visible_lines():
    # the same visible lines under a wider table (trash entries past the
    # slot's pages), and a one-token verify against decode: equal bytes
    ql, qr, c, kr, bt, pos = _case(3, 2, 1, 4, 32, 8, 8, 4, (20, 9))
    wide = np.concatenate([bt, np.zeros((2, 5), np.int32)], axis=1)
    dec = tpa.mla_split_model(*_torch(ql[:, 0], qr[:, 0], c, kr, bt, pos),
                              scale=SCALE)
    dec_wide = tpa.mla_split_model(
        *_torch(ql[:, 0], qr[:, 0], c, kr, wide, pos), scale=SCALE)
    ver = tpa.mla_split_model(*_torch(ql, qr, c, kr, bt, pos),
                              scale=SCALE)[:, 0]
    assert torch.equal(dec, dec_wide) and torch.equal(dec, ver)


@pytest.mark.parametrize("pos,T,page,nb,H,r,want", [
    # the serve path's decode call: 679 lines in chunks of 32, two head
    # tiles, two column parts
    ((96, 162, 189, 228), 1, 16, 16, 128, 512, (32, 128, 96)),
    # its verify call (T 4, 17 blocks)
    ((96, 162, 189, 228), 4, 16, 17, 128, 512, (32, 576, 388)),
    # smoke widths: one head tile, one part
    ((0, 8, 19), 1, 8, 4, 4, 32, (16, 6, 4)),
])
def test_split_plan_counts_the_blocks(pos, T, page, nb, H, r, want):
    plan = tpa.mla_split_plan(pos, T, page, nb, H, r)
    assert (plan["chunk_lines"], plan["grid"], plan["blocks"]) == want
