"""The float32 GEMM core's tile walk (``csrc/gemm_core.cuh``) rehearsed
on the CPU with numpy: the constants are read from the header, so the
two cannot drift.

The header's thread -> shared-memory slot maps of its producers (16-byte
copies of 4 floats, or one copy per element; dense A and B, and the
direct convolution's im2col A) and its thread -> output map are emulated
at the edge shapes of the card tests: every A / B element of a slab must
land in its slot exactly once, slots past an edge (M, N, K, the
convolution's padding) must be zeros, and every output of a tile must be
owned by exactly one thread.  Then whole launches are walked through the
ring (stage order, in-order fused multiply-adds per output) and held
against the plain versions within the float32 "sum" tolerance.  No JAX,
no card; a few seconds.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import conv_direct, inner_product
from repro_torch.launch.primitives import tolerance

HEADER = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" /
          "csrc" / "gemm_core.cuh").read_text()


def _int(pattern: str) -> int:
    m = re.search(pattern, HEADER)
    assert m, pattern
    return int(m.group(1))


BM = _int(r"constexpr int BM = (\d+)")
BN = _int(r"constexpr int BM = \d+, BN = (\d+)")
BK = _int(r"constexpr int BM = \d+, BN = \d+, BK = (\d+);")
STAGES = _int(r"constexpr int kStages = (\d+);")
THREADS = _int(r"constexpr int kThreads = (\d+);")
TX = _int(r"constexpr int kTx = (\d+);")            # threads along a row
HALF = _int(r"constexpr int kHalf = (\d+);")        # between quadrants
A_STRIDE = BK + _int(r"constexpr int kAStride = BK \+ (\d+)")
VEC, ELEMENT = 0, 1                       # gemm::Producer
T = np.arange(THREADS)


def test_constants_read_from_the_header():
    # 8 x 8 outputs a thread, in four 4 x 4 quadrants HALF apart
    assert (BM, BN, HALF) == (128, 128, 64)
    assert THREADS * 64 == BM * BN and TX * 8 == BN
    assert BK % 4 == 0 and STAGES >= 2 and A_STRIDE % 4 == 0
    # the ring, dynamic shared memory: two blocks fit an SM's 228 KB
    smem = STAGES * (BM * A_STRIDE + BK * BN) * 4
    assert re.search(r"kSmemBytes = kStages \* kStageFloats \* 4", HEADER)
    assert 2 * (smem + 1024) <= 228 * 1024
    # wait for the oldest of the ring's in-flight groups
    assert "cp_async::wait<kStages - 2>()" in HEADER


def slots(w: int, cols: int, rows: int):
    """gemm::Slots<W, kRows, kCols>: (row, col) of every (thread, copy)."""
    per_row = cols // w
    step = THREADS // per_row
    copies = rows * per_row // THREADS
    assert THREADS % per_row == 0 and copies * THREADS == rows * per_row
    r = T[:, None] // per_row + np.arange(copies)[None, :] * step
    c = np.broadcast_to((w * (T % per_row))[:, None], r.shape)
    return r, c


def producer(offset: int, row: int) -> int:
    """gemm::producer: 16-byte copies for rows of a multiple of 4 floats
    from a 16-byte aligned base (``offset`` in floats from one)."""
    return VEC if row % 4 == 0 and offset % 4 == 0 else ELEMENT


def fill(stage, rows, cols, src_of, w):
    """Emulate one slab's copies into ``stage`` (NaN where unwritten):
    ``src_of(row, col)`` gives (value block (.., w), valid); invalid
    copies write zeros.  Returns the count of writes per slot."""
    r, c = slots(w, cols, rows)
    vals, ok = src_of(r, c)
    hits = np.zeros(stage.shape, np.int64)
    for e in range(w):
        stage[r, c + e] = np.where(ok, vals[..., e], 0.0)
        np.add.at(hits, (r, c + e), 1)
    return hits


def dense_src(mat, r0, c0, w):
    """Sources of a copy at (row r0 + r, col c0 + c) of a dense matrix:
    a 16-byte copy is whole inside or outside (rows of a multiple of 4)."""
    def src(r, c):
        rr, cc = r0 + r, c0 + c
        ok = (rr < mat.shape[0]) & (cc < mat.shape[1])
        if w == 4:
            assert mat.shape[1] % 4 == 0
        vals = np.zeros(r.shape + (w,), np.float32)
        for e in range(w):
            inside = ok & (cc + e < mat.shape[1])
            assert (inside == ok).all()       # no copy straddles an edge
            vals[..., e] = np.where(
                inside, mat[np.minimum(rr, mat.shape[0] - 1),
                            np.minimum(cc + e, mat.shape[1] - 1)], 0.0)
        return vals, ok
    return src


def im2col(x, kh, kw):
    """A (N H W, KH KW Cin) of the direct convolution, padding KH // 2
    before (conv_direct.pad_split)."""
    n, h, wd, cin = x.shape
    (pt, pb), (pl, pr) = (conv_direct.pad_split(kh),
                          conv_direct.pad_split(kw))
    xp = np.pad(x, ((0, 0), (pt, pb), (pl, pr), (0, 0)))
    cols = [xp[:, dh:dh + h, dw:dw + wd, :] for dh in range(kh)
            for dw in range(kw)]
    return np.concatenate(cols, axis=-1).reshape(n * h * wd, -1)


def conv_src(x, kh, kw, m0, k0, w):
    """ConvA<W>: copy (r, c) reads channels k .. k + W - 1 of one pixel
    and tap (Cin % 4 == 0 for W = 4), zeros in the padding."""
    n, h, wd, cin = x.shape
    M, K = n * h * wd, kh * kw * cin

    def src(r, c):
        m, k = m0 + r, k0 + c
        tap, ci = k // cin, k % cin
        dh, dw = tap // kw, tap % kw
        nn, rem = m // (h * wd), m % (h * wd)
        ih = rem // wd + dh - kh // 2
        iw = rem % wd + dw - kw // 2
        ok = (m < M) & (k < K) & (ih >= 0) & (ih < h) & (iw >= 0) & (iw < wd)
        if w == 4:
            assert cin % 4 == 0 and (ci % 4 == 0).all()
        vals = np.zeros(r.shape + (w,), np.float32)
        for e in range(w):
            vals[..., e] = np.where(
                ok, x[np.where(ok, nn, 0), np.where(ok, ih, 0),
                      np.where(ok, iw, 0), np.where(ok, ci + e, 0)], 0.0)
        return vals, ok
    return src


def owners():
    """Thread -> its 8 x 8 outputs (4 x 4 quadrants: rows 4 ty and
    HALF + 4 ty, columns 4 tx and HALF + 4 tx), as tile (row, col) index
    arrays of shapes (threads, 8) and (threads, 8)."""
    tx, ty = T % TX, T // TX
    e = np.arange(4)
    rows = np.concatenate([4 * ty[:, None] + e, HALF + 4 * ty[:, None] + e],
                          axis=1)
    cols = np.concatenate([4 * tx[:, None] + e, HALF + 4 * tx[:, None] + e],
                          axis=1)
    return rows, cols


def test_every_output_of_a_tile_has_one_owner():
    rows, cols = owners()
    hits = np.zeros((BM, BN), np.int64)
    np.add.at(hits, (rows[:, :, None], cols[:, None, :]), 1)
    assert (hits == 1).all()


def test_warp_reads_are_conflict_free_and_broadcast():
    # shared-memory banks of a warp's float4 reads in the K loop: B covers
    # TX contiguous float4s (each a broadcast to the warp's 32 / TX rows of
    # threads); A is 32 / TX addresses, each broadcast to TX threads, in
    # at most two 16-byte bank groups' worth of conflict
    rows, cols = owners()
    for warp in range(THREADS // 32):
        lanes = slice(32 * warp, 32 * warp + 32)
        b_bytes = np.unique(cols[lanes, 0]) * 4
        assert len(b_bytes) == TX and np.ptp(b_bytes) == (TX - 1) * 16
        a_bytes = np.unique(rows[lanes, 0]) * A_STRIDE * 4
        assert len(a_bytes) == 32 // TX
        groups = [(b // 16) % 8 for b in a_bytes]
        assert max(groups.count(g) for g in groups) <= 2


@pytest.mark.parametrize("w", [4, 1])
@pytest.mark.parametrize("operand", ["A", "B"])
def test_producer_slots_cover_each_slab_once(operand, w):
    rows, cols = (BM, BK) if operand == "A" else (BK, BN)
    r, c = slots(w, cols, rows)
    hits = np.zeros((rows, cols), np.int64)
    for e in range(w):
        np.add.at(hits, (r, c + e), 1)
    assert (hits == 1).all()
    # a warp's 32 copies of one instruction are contiguous in the slab
    flat = r[:32, 0] * cols + c[:32, 0]
    assert (np.diff(flat) == w).all()


def padded(mat, r0, c0, rows, cols):
    """mat[r0:r0 + rows, c0:c0 + cols] with zeros past its edges."""
    out = np.zeros((rows, cols), np.float32)
    part = mat[r0:r0 + rows, c0:c0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def walk(A_src, A_mat, B_mat, M, N, K, wa, wb):
    """One launch of gemm_tile through the ring, tile by tile: returns C
    (M, N) float32.  Every stage is checked as it is filled: each slot
    written once, equal to the operand's slab with zeros past its edges
    (``A_mat`` is A materialised)."""
    C = np.full((M, N), np.nan, np.float32)
    rows, cols = owners()
    nk = -(-K // BK)
    for m0 in range(0, M, BM):
        for n0 in range(0, N, BN):
            ring_a = np.full((STAGES, BM, A_STRIDE), np.nan, np.float32)
            ring_b = np.full((STAGES, BK, BN), np.nan, np.float32)
            acc = np.zeros((THREADS, 8, 8), np.float32)
            filled = {}

            def load(kt):
                s = kt % STAGES
                ring_a[s] = np.nan
                ring_b[s] = np.nan
                ha = fill(ring_a[s], BM, BK, A_src(m0, kt * BK, wa), wa)
                hb = fill(ring_b[s], BK, BN,
                          dense_src(B_mat, kt * BK, n0, wb), wb)
                assert (ha[:, :BK] == 1).all() and (ha[:, BK:] == 0).all()
                assert (hb == 1).all()
                np.testing.assert_array_equal(
                    ring_a[s][:, :BK], padded(A_mat, m0, kt * BK, BM, BK))
                np.testing.assert_array_equal(
                    ring_b[s], padded(B_mat, kt * BK, n0, BK, BN))
                filled[s] = kt
            for kt in range(min(STAGES - 1, nk)):
                load(kt)
            for kt in range(nk):
                if kt + STAGES - 1 < nk:
                    # the stage refilled now held slab kt - 1, done with
                    assert (kt + STAGES - 1) % STAGES != kt % STAGES
                    load(kt + STAGES - 1)
                s = kt % STAGES
                assert filled[s] == kt
                a = ring_a[s][rows]                 # (threads, 8, A_STRIDE)
                b = ring_b[s][:, cols]              # (BK, threads, 8)
                for kk in range(BK):                    # k in order, fma
                    prod = (a[:, :, kk, None].astype(np.float64) *
                            b[kk][:, None, :].astype(np.float64))
                    acc = (prod + acc).astype(np.float32)
            m, n = m0 + rows, n0 + cols
            for i in range(8):
                for j in range(8):
                    ok = (m[:, i] < M) & (n[:, j] < N)
                    C[m[ok, i], n[ok, j]] = acc[ok, i, j]
    assert not np.isnan(C).any()
    return C


# (M, K, N, offset of x, offset of w): ragged against every tile dimension,
# K under one slab and K % BK != 0, K = 1, N = 1, K % 4 != 0 (element-wise
# A), N % 4 != 0 (element-wise B), storage offsets 1, 2 and 3; one whole
# tile of one whole slab
@pytest.mark.parametrize("m,k,n,ox,ow", [
    (131, 77, 133, 0, 0), (1, 1, 1, 0, 0), (129, 1, 257, 0, 0),
    (200, 12, 136, 0, 0), (70, 36, 1, 0, 0), (257, 48, 8, 0, 0),
    (64, 100, 130, 0, 0), (96, 64, 72, 1, 3), (96, 64, 72, 3, 0),
    (128, 32, 128, 2, 2),
])
def test_inner_product_walk_matches_plain(m, k, n, ox, ow):
    rng = np.random.default_rng(m + k + n + ox)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((k, n), dtype=np.float32)
    wa, wb = (4 if producer(ox, k) == VEC else 1,
              4 if producer(ow, n) == VEC else 1)
    words = inner_product.describe_plan(-2 - ((wa == 1) | (wb == 1) << 1))
    assert words.startswith("cuda-cores f32, A ")
    got = walk(lambda m0, k0, w_: dense_src(x, m0, k0, w_), x, w, m, n, k,
               wa, wb)
    want = inner_product.inner_product_reference(torch.from_numpy(x),
                                                 torch.from_numpy(w))
    torch.testing.assert_close(torch.from_numpy(got), want,
                               **tolerance("sum", "float32", k))


@pytest.mark.parametrize("p,t,cin,cout", [(16, 1, 128, 128), (3, 300, 65, 9)])
def test_winograd_walk_matches_plain(p, t, cin, cout):
    from repro_torch.kernels import conv_winograd
    rng = np.random.default_rng(p + t)
    v = rng.standard_normal((p, t, cin), dtype=np.float32)
    u = rng.standard_normal((p, cin, cout), dtype=np.float32)
    wa = 4 if producer(0, cin) == VEC else 1
    wb = 4 if producer(0, cout) == VEC else 1
    got = np.stack([walk(lambda m0, k0, w_, i=i: dense_src(v[i], m0, k0, w_),
                         v[i], u[i], t, cout, cin, wa, wb)
                    for i in range(p)])
    want = conv_winograd.winograd_elementwise_stage_reference(
        torch.from_numpy(v), torch.from_numpy(u))
    torch.testing.assert_close(torch.from_numpy(got), want,
                               **tolerance("sum", "float32", cin))


@pytest.mark.parametrize("n,h,w,cin,cout,kh,kw", [
    (2, 7, 5, 3, 17, 3, 3), (2, 9, 11, 16, 24, 3, 3), (2, 6, 9, 5, 7, 2, 2),
    (1, 5, 4, 8, 9, 1, 5),
])
def test_conv_walk_matches_plain(n, h, w, cin, cout, kh, kw):
    rng = np.random.default_rng(n + h + cin)
    x = rng.standard_normal((n, h, w, cin), dtype=np.float32)
    wt = rng.standard_normal((kh, kw, cin, cout), dtype=np.float32) * 0.1
    M, K = n * h * w, kh * kw * cin
    wa = 4 if producer(0, cin) == VEC else 1
    wb = 4 if producer(0, cout) == VEC else 1
    # the im2col producer's stages equal the materialised A's slabs
    got = walk(lambda m0, k0, w_: conv_src(x, kh, kw, m0, k0, w_),
               im2col(x, kh, kw), wt.reshape(K, cout), M, cout, K, wa, wb)
    want = conv_direct.conv2d_direct_reference(torch.from_numpy(x),
                                               torch.from_numpy(wt))
    torch.testing.assert_close(torch.from_numpy(got).reshape(want.shape),
                               want, **tolerance("sum", "float32", K, 0.1))


def test_resources_read_nvcc_reports_of_the_core_kernels():
    # chip_smoke.py prints each float32 core kernel's registers and spills
    # from nvcc's -Xptxas -v report
    from repro_torch.kernels.build import resources
    log = "".join(
        f"ptxas info    : Function properties for {name}\n"
        f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
        f"bytes spill loads\nptxas info    : Used {regs} registers, used 1 "
        "barriers, 400 bytes cmem[0]\n"
        for name, regs, spill in (
            ("_ZN12_GLOBAL__N_125winograd_stage_f32_kernelILi4ELi1EEEvPKfS2"
             "_Pfiiib", 128, 0),
            ("_ZN51_GLOBAL__N__04cf38d3_18_conv_direct_cu_cf58742224conv2d_"
             "direct_f32_kernelILi1ELi4EEEvPKfS2_Pfiiiiiiib", 123, 8),
            ("_ZN12_GLOBAL__N_125inner_product_bf16_kernelILi128EEEvv", 90,
             0)))
    assert resources(log) == [
        "winograd_stage_f32_kernel<4, 1> 128 regs, 0 B spilled",
        "conv2d_direct_f32_kernel<1, 4> 123 regs, 8 B spilled"]
