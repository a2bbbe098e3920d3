"""Decode over a dense cache whose lines are cut over ``model`` (KV heads
that do not divide the axis, and MLA's latent lines always) against the
JAX package's GSPMD ``decode_step``, on the CPU: gloo ranks of the port
(one spawn of 4 ranks, torch on two intra-op threads) and the reference
in one subprocess with 8 forced host devices under its
``launch/specs.py::decode_specs`` shardings, side by side, in float32 on
smoke configs:

* ``qwen 1x4``: qwen3-0.6b's smoke (4 heads, 2 KV heads) at (data 1,
  model 4): the query heads split and gathered, the lines cut
  (``LocalLayout(kv_seq=True)``);
* ``gqa 6h 1x4``: qwen3-14b's smoke with 6 heads and 2 KV heads at (1,
  4): neither divides; heads whole on every rank, lines cut
  (``context_parallel`` beside ``kv_seq``);
* ``tp_oproj 6h 1x4``: the same under ``tp_attn_inner``: the flat H x hd
  o-projection split over ``model`` after the merge;
* ``head-parallel 2x2``: qwen3-0.6b's smoke at (2, 2): its KV heads, every
  line, no merge;
* ``mla 2x2`` / ``mla absorb 2x2``: deepseek-v2's smoke (MLA, MoE) at (2,
  2), the expanded and the absorbed form: the latent lines cut;
* ``whisper 1x4``: whisper-small's smoke (4 heads, 4 KV heads, which 4
  divides: head parallel) with 2 KV heads, so that its self and cross
  caches (16 source frames, which 4 divides) are both cut.

Each case starts from the same weights (a step-0 checkpoint; whisper's
cross gates set in [0.5, 1.5)) and the same global cache, drawn from a
seed with numpy: lines below ``P0`` random, the rest zeros (the cross
lines all random).  Then ``STEPS`` decode steps of the same tokens at
positions P0, P0 + 1, ...: the positions cross from rank 0's block of
the lines into rank 1's, and ranks 2 and 3 see no line at all.

Held:

* every step's logits, each rank's rows, within rtol 1e-5 plus 1e-5 of
  the step's largest logit (``LOGITS_RTOL``, derived there);
* each rank's cache block after the steps equal to the reference's
  caches cut to that block (``LINES_RTOL``): the untouched lines bit for
  bit, the written ones within the bar;
* one step's walked ``model`` bytes equal ``train.step.
  decode_wire_bytes`` (rtol 1e-12), by edge;
* the merge (``collectives.kv_merge``) of four blocks of a cache, one of
  them with no visible line, equals the plain version over the whole
  cache;
* the plain version's log-sum-exp against ``torch.logsumexp`` of the
  plain scores, and a row that sees no line (o = 0, lse = -inf);
* the per-device W of one decode smoke cell at (1, 8) against the
  reference's ``analyze_compiled``, within ``W_BAR`` (derived there).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.core.analysis import analyze_step
from repro_torch.launch import specs as tspecs
from repro_torch.models import decode_step
from repro_torch.models.common import (HEAD_PARALLEL, LocalLayout,
                                       ShapeCell, layout_of)
from repro_torch.models.params import tree_map, tree_paths
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.mesh import (batch_shard, batch_shards,
                                       fake_world, make_host_mesh, spawn,
                                       use_mesh)
from repro_torch.train import CheckpointManager, make_initial_state
from repro_torch.train.loop import abstract_state, state_shards
from repro_torch.train.step import decode_local_config, decode_wire_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, SEED = 4, 64, 5
P0, STEPS = 13, 6          # positions 13..18: blocks of 16 lines at model 4
# a logit sums D products whose partial sums reach the row's largest
# logit; the attention output it reads was merged over the ranks in
# another order than GSPMD's (float32 sums, exp weights), so a logit near
# zero keeps its terms' roundings: the bar adds 1e-5 of the step's
# largest magnitude, as LINES_RTOL does for a cache line (one of 1024
# logits of the 6-head case read 1.5e-6 at 0.05, the rest within 1e-5)
LOGITS_RTOL = 1e-5
LINES_RTOL = 1e-5          # tests/test_torch_seq_parallel.py's derivation
THREADS = 2

# tag -> (arch, heads, kv heads, (pod, data, model), absorb, tp_oproj);
# 0: the smoke config's
CASES = {
    "qwen 1x4": ("qwen3-0.6b", 0, 0, (1, 1, 4), False, False),
    "gqa 6h 1x4": ("qwen3-14b", 6, 2, (1, 1, 4), False, False),
    "tp_oproj 6h 1x4": ("qwen3-14b", 6, 2, (1, 1, 4), False, True),
    "head-parallel 2x2": ("qwen3-0.6b", 0, 0, (1, 2, 2), False, False),
    "mla 2x2": ("deepseek-v2-236b", 0, 0, (1, 2, 2), False, False),
    "mla absorb 2x2": ("deepseek-v2-236b", 0, 0, (1, 2, 2), True, False),
    "whisper 1x4": ("whisper-small", 0, 2, (1, 1, 4), False, False),
}
LAYOUTS = {
    "qwen 1x4": LocalLayout(kv_seq=True),
    "gqa 6h 1x4": LocalLayout(context_parallel=True, kv_seq=True),
    "tp_oproj 6h 1x4": LocalLayout(context_parallel=True, kv_seq=True),
    "head-parallel 2x2": HEAD_PARALLEL,
    "mla 2x2": HEAD_PARALLEL,
    "mla absorb 2x2": HEAD_PARALLEL,
    "whisper 1x4": LocalLayout(kv_seq=True),
}

# The W check: one decode cell of a smoke config widened to d_model 256
# (hd 32, 6 heads, 2 KV heads, d_ff 512) at (data 1, model 8), B 8 x S
# 64: heads whole, lines cut.  W (per-device FLOPs), the port's walk over
# the reference's compiled module, under the bar of
# tests/test_torch_seq_parallel.py (W_BAR and its derivation there: the
# two counts part where XLA folds or rewrites arithmetic and where the
# programs do different redundant work; 15% each way, the reference's
# own bar for its ledger against the HLO)
W_MESH, W_B, W_S = (1, 8), 8, 64
W_BAR = 1.15


def case_cfg(tag: str):
    arch, heads, kv, _, absorb, inner = CASES[tag]
    cfg = tcfg.smoke(tcfg.get_config(arch))
    return dataclasses.replace(
        cfg, n_heads=heads or cfg.n_heads, n_kv_heads=kv or cfg.n_kv_heads,
        mla_absorb=absorb, tp_attn_inner=inner,
        name=f"{cfg.name}-decode-{tag.replace(' ', '-')}")


def w_cfg():
    cfg = tcfg.smoke(tcfg.get_config("qwen3-14b"))
    return dataclasses.replace(cfg, d_model=256, n_heads=6, n_kv_heads=2,
                               head_dim=32, d_ff=512, name="qwen3-14b-w")


def _mesh(shape):
    pod, data, model = shape
    return make_host_mesh(data=data, model=model, pod=pod)


def global_caches(cfg) -> dict:
    """The whole caches of a case, by tree path (numpy float32): the
    self / latent lines below P0 random, the rest zeros; the cross lines
    all random."""
    rng = np.random.default_rng(SEED)
    out = {}
    for k, d in tree_paths(tspecs.exact_cache_defs(cfg, B, S)):
        a = np.zeros(d.shape, np.float32)
        lines = slice(None) if k.split("/")[-1] in ("ck", "cv") else \
            slice(0, P0)
        a[:, :, lines] = 0.5 * rng.standard_normal(
            a[:, :, lines].shape).astype(np.float32)
        out[k] = a
    return out


def tokens(cfg) -> np.ndarray:
    return np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (STEPS, B)).astype(np.int32)


def _gather_objects(obj, world: int) -> list:
    import torch.distributed as dist
    every = [None] * world
    dist.all_gather_object(every, obj)
    return every


def _case(tag: str, init_dir: str, world: int) -> dict:
    """The case on its mesh: the rank's layout; every rank's logits per
    step and cache block after the steps, numpy; one step's walked
    ``model`` bytes by edge and ``decode_wire_bytes``."""
    from repro_torch.core.roofline.op_collectives import (CollectiveWalk,
                                                          summarize)
    cfg = case_cfg(tag)
    mesh = _mesh(CASES[tag][3])
    mgr = CheckpointManager(os.path.join(init_dir, cfg.name), mesh=mesh,
                            shards=state_shards(cfg, mesh))
    params = mgr.restore(abstract_state(cfg, mesh), 0,
                         device="cpu")[0]["params"]
    local = decode_local_config(cfg, mesh)
    specs = tspecs.prefill_cache_specs(cfg, B, S, mesh)
    whole = global_caches(cfg)
    caches = tree_map(lambda d, sp, k: (
        torch.from_numpy(whole[k]) if shd.leaf_block(sp, mesh) is None
        else shd.leaf_block(sp, mesh).take(torch.from_numpy(whole[k]))
    ).clone(), tspecs.exact_cache_defs(cfg, B, S), specs,
        _path_tree(tspecs.exact_cache_defs(cfg, B, S)))
    rows = B // batch_shards(mesh)
    lo = batch_shard(mesh) * rows
    toks = torch.from_numpy(tokens(cfg))[:, lo:lo + rows]
    logits = []
    with use_mesh(mesh, process_wide=True), torch.no_grad():
        for i in range(STEPS):
            pos = torch.full((rows,), P0 + i, dtype=torch.int32)
            step = lambda: decode_step(params, local, caches,  # noqa: E731
                                       toks[i][:, None], pos)
            if i == 1:
                with CollectiveWalk(mesh=mesh) as walk:
                    lg = step()
                c = summarize(walk.ops)
                walked = ({k[0]: v for k, v in c.by_axes.items()},
                          dict(c.by_edge))
            else:
                lg = step()
            logits.append(lg.numpy())
    blocks = _gather_objects(
        (np.stack(logits), {k: v.numpy() for k, v in tree_paths(caches)}),
        world)
    return {"blocks": blocks, "layout": layout_of(local),
            "mesh": mesh.sizes, "walked": walked,
            "wire": decode_wire_bytes(cfg, mesh.sizes, B, S)}


def _path_tree(defs):
    """A tree of ``defs``' structure holding each leaf's path."""
    paths = iter(k for k, _ in tree_paths(defs))
    return tree_map(lambda _: next(paths), defs)


def _merge_check() -> dict:
    """kv_merge over the 4 ranks of the four blocks of one cache (16
    lines a rank; the position in block 1, so blocks 2 and 3 see no
    line): each rank's merged output and the plain version over the whole
    cache (on every rank alike)."""
    from repro_torch.models.attention import dense_attention
    from repro_torch.parallel.collectives import kv_merge
    rng = np.random.default_rng(SEED + 2)
    Bm, KV, G, hd, L = 3, 2, 3, 16, 16
    q = torch.from_numpy(rng.standard_normal((Bm, KV, G, hd)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((Bm, 4 * L, KV, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((Bm, 4 * L, KV, hd)).astype(
        np.float32))
    pos = torch.tensor([20, 17, 31], dtype=torch.int32)
    whole = dense_attention(q, k, v, pos, scale=0.25)
    mesh = make_host_mesh(data=1, model=4)
    r = mesh.coord("model")
    with use_mesh(mesh, process_wide=True):
        o, lse = dense_attention(q, k[:, r * L:(r + 1) * L].contiguous(),
                                 v[:, r * L:(r + 1) * L].contiguous(),
                                 (pos - r * L).clamp(max=L - 1), scale=0.25,
                                 return_lse=True)
        merged = kv_merge(o, lse, "model")
    return {"merged": merged.numpy(), "whole": whole.numpy(),
            "empty_lse": bool(torch.isinf(lse).all()) if r >= 2 else None,
            "empty_o": float(o.abs().max()) if r >= 2 else None}


def four_ranks(rank: int, world: int, init_dir: str) -> dict:
    torch.set_num_threads(THREADS)
    out = {tag: _case(tag, init_dir, world) for tag in CASES}
    out["merge"] = _gather_objects(_merge_check(), world)
    return out


def w_walk() -> float:
    """The port's per-device W of the W cell, rank 0 of a fake world of
    8 (fake tensors)."""
    cfg = w_cfg()
    with fake_world(8):
        mesh = make_host_mesh(data=W_MESH[0], model=W_MESH[1])
        args, _, _ = tspecs.decode_specs(cfg, ShapeCell("w", W_S, W_B,
                                                        "decode"), mesh)
        local = decode_local_config(cfg, mesh)

        def fn(p, c, t, pos):
            with use_mesh(mesh, process_wide=True), torch.no_grad():
                return decode_step(p, local, c, t, pos)
        rep = analyze_step(fn, args=args, mesh=mesh, dtype=cfg.dtype)
    return rep.character.flops_dev


_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, jax, numpy as np
    import jax.numpy as jnp
    from repro.configs import get_config, smoke
    from repro.core.analysis import analyze_step
    from repro.launch import specs as specs_mod
    from repro.models import decode_step, init_cache
    from repro.models.common import ShapeCell
    from repro.parallel.mesh import make_mesh, mesh_context
    from repro.parallel.sharding import sharding_context
    from repro.train import CheckpointManager
    from repro.train.checkpoint import _flat
    from repro.train.loop import make_initial_state

    out_path, init_dir, cache_dir = sys.argv[1:4]
    B, S, P0, STEPS = {B}, {S}, {P0}, {STEPS}
    CASES = {CASES!r}
    W_MESH, W_B, W_S = {W_MESH!r}, {W_B}, {W_S}
    out = {{}}

    def case_cfg(tag):
        arch, heads, kv, _, absorb, inner = CASES[tag]
        cfg = smoke(get_config(arch))
        return dataclasses.replace(
            cfg, n_heads=heads or cfg.n_heads,
            n_kv_heads=kv or cfg.n_kv_heads, mla_absorb=absorb,
            tp_attn_inner=inner,
            name=f"{{cfg.name}}-decode-{{tag.replace(' ', '-')}}")

    def mesh_of(shape):
        pod, data, model = shape
        if pod > 1:
            return make_mesh(shape, ("pod", "data", "model"))
        return make_mesh((data, model), ("data", "model"))

    for tag, (arch, heads, kv, shape, absorb, inner) in CASES.items():
        cfg = case_cfg(tag)
        mesh = mesh_of(shape)
        abstract = jax.eval_shape(make_initial_state(cfg))
        params = CheckpointManager(os.path.join(init_dir, cfg.name)).restore(
            abstract, 0)[0]["params"]
        with np.load(os.path.join(cache_dir, cfg.name + ".npz")) as f:
            whole = {{k: f[k] for k in f.files}}
        flat, tree = jax.tree_util.tree_flatten_with_path(
            init_cache(cfg, B, S))
        keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                         for p in path) for path, _ in flat]
        caches = jax.tree_util.tree_unflatten(
            tree, [jnp.asarray(whole[k]) for k in keys])
        toks = whole["__tokens__"]
        with sharding_context(mesh):
            _, in_sh, _ = specs_mod.decode_specs(
                cfg, ShapeCell("d", S, B, "decode"), mesh)
            with mesh_context(mesh):
                fn = jax.jit(lambda p, c, t, pos: decode_step(p, cfg, c, t,
                                                              pos),
                             in_shardings=in_sh)
                p = jax.device_put(params, in_sh[0])
                c = jax.device_put(caches, in_sh[1])
                for i in range(STEPS):
                    t = jax.device_put(jnp.asarray(toks[i][:, None]),
                                       in_sh[2])
                    lg, c = fn(p, c, t, jnp.int32(P0 + i))
                    out[f"{{tag}}/logits/{{i}}"] = np.asarray(lg)
        for k, v in _flat(c).items():
            out[f"{{tag}}/cache/{{k}}"] = np.asarray(v)

    # the W cell: the reference's analyze_compiled of one rank's module
    cfg = dataclasses.replace(smoke(get_config("qwen3-14b")), d_model=256,
                              n_heads=6, n_kv_heads=2, head_dim=32,
                              d_ff=512, name="qwen3-14b-w")
    mesh = make_mesh(W_MESH, ("data", "model"))
    with sharding_context(mesh):
        cell = ShapeCell("w", W_S, W_B, "decode")
        args, in_sh, _ = specs_mod.decode_specs(cfg, cell, mesh)
        rep, _ = analyze_step(
            lambda p, c, t, pos: decode_step(p, cfg, c, t, pos),
            args=args, mesh=mesh, in_shardings=in_sh, label="w decode")
        out["w/decode"] = np.asarray(rep.character.flops_dev)
    np.savez(out_path, **out)
    print("RESULT ok")
""").format(B=B, S=S, P0=P0, STEPS=STEPS, CASES=CASES, W_MESH=W_MESH,
            W_B=W_B, W_S=W_S)


def _set_gates(state) -> None:
    """Cross gates init to 0, which hides the cross path: set them in
    [0.5, 1.5)."""
    rng = np.random.default_rng(SEED + 3)
    for k, t in tree_paths(state["params"]):
        if k.endswith("/gate"):
            t.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess, started first, and the port's ranks and
    walk meanwhile: {"ref", "four", "w"}."""
    tmp = tmp_path_factory.mktemp("decode_seq")
    init_dir, cache_dir = str(tmp / "init"), str(tmp / "caches")
    os.makedirs(cache_dir)
    for tag in CASES:
        cfg = case_cfg(tag)
        state = make_initial_state(cfg, 0, "cpu")()
        _set_gates(state)
        CheckpointManager(os.path.join(init_dir, cfg.name)).save(state, 0)
        np.savez(os.path.join(cache_dir, cfg.name + ".npz"),
                 __tokens__=tokens(cfg), **global_caches(cfg))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ref_path = tmp / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(ref_path), init_dir,
         cache_dir], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)
    try:
        four = spawn(four_ranks, 4, device="cpu", args=(init_dir,),
                     timeout=400)
        w = w_walk()
        stdout, stderr = proc.communicate(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "RESULT ok" in stdout, (stdout[-2000:], stderr[-3000:])
    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    return {"ref": ref, "four": four, "w": w}


def _rank_rows(sizes, r):
    from repro_torch.parallel.mesh import Mesh
    mesh = Mesh(tuple(sizes), tuple(sizes.values()), rank=r)
    rows = B // batch_shards(mesh)
    return mesh, batch_shard(mesh) * rows, rows


@pytest.mark.parametrize("tag", list(CASES))
def test_decode_logits_match_reference(runs, tag):
    got, ref = runs["four"][tag], runs["ref"]
    assert got["layout"] == LAYOUTS[tag]
    for r, (logits, _) in enumerate(got["blocks"]):
        _, lo, rows = _rank_rows(got["mesh"], r)
        for i in range(STEPS):
            want = ref[f"{tag}/logits/{i}"]
            np.testing.assert_allclose(
                logits[i], want[lo:lo + rows], rtol=LOGITS_RTOL,
                atol=LOGITS_RTOL * float(np.abs(want).max()),
                err_msg=f"rank {r} step {i}")


@pytest.mark.parametrize("tag", list(CASES))
def test_decode_cache_blocks_match_reference(runs, tag):
    got, ref = runs["four"][tag], runs["ref"]
    cfg = case_cfg(tag)
    defs = tspecs.exact_cache_defs(cfg, B, S)
    specs = tspecs.prefill_cache_specs(cfg, B, S, got["mesh"])
    start = global_caches(cfg)
    for r, (_, block) in enumerate(got["blocks"]):
        mesh, _, _ = _rank_rows(got["mesh"], r)
        blk = dict(tree_paths(tree_map(
            lambda d, sp: shd.leaf_block(sp, mesh), defs, specs)))
        assert set(block) == set(blk)
        for k, v in block.items():
            def cut(a):
                t = torch.from_numpy(a)
                return (t if blk[k] is None else blk[k].take(t)).numpy()
            want, before = cut(ref[f"{tag}/cache/{k}"]), cut(start[k])
            assert v.shape == want.shape, (r, k, v.shape, want.shape)
            same = (before != 0) | (want == 0)   # lines the steps left
            np.testing.assert_array_equal(v[same], want[same])
            np.testing.assert_allclose(
                v, want, rtol=LINES_RTOL,
                atol=LINES_RTOL * float(np.abs(want).max()),
                err_msg=f"{r} {k}")


@pytest.mark.parametrize("tag", list(CASES))
def test_decode_walk_equals_decode_wire_bytes(runs, tag):
    got = runs["four"][tag]
    axes, edges = got["walked"]
    wire = got["wire"]
    np.testing.assert_allclose(axes["model"], wire["model"], rtol=1e-12)
    for edge in ("kv_merge", "head_gather", "tp_reduce", "tp_gather"):
        np.testing.assert_allclose(edges.get(edge, 0.0), wire[edge],
                                   rtol=1e-12, atol=0, err_msg=edge)
    cut = LAYOUTS[tag].kv_seq or tag.startswith("mla")
    assert (wire["kv_merge"] > 0) == cut


def test_merge_with_empty_ranks_equals_the_whole_attention(runs):
    every = runs["four"]["merge"]
    for r, res in enumerate(every):
        np.testing.assert_allclose(res["merged"], res["whole"], rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")
        if r >= 2:
            assert res["empty_lse"] and res["empty_o"] == 0.0


def test_per_device_w_against_reference(runs):
    got, want = runs["w"], float(runs["ref"]["w/decode"])
    ratio = got / want
    print(f"W decode at (1, 8): walk {got:.6g} / compiled {want:.6g} = "
          f"{ratio:.4f}")
    assert 1 / W_BAR <= ratio <= W_BAR, ratio


# --------------------------------------------------------------------------
# row 1's log-sum-exp, the plain version (the kernel: the cuda file)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("soft_cap", [0.0, 30.0])
def test_plain_lse_is_logsumexp_of_the_plain_scores(soft_cap):
    from repro_torch.kernels.paged_attention import (
        paged_attention_reference)
    rng = np.random.default_rng(SEED + 4)
    Bq, KV, G, hd, page, nb = 3, 2, 4, 16, 8, 4
    q = torch.from_numpy(rng.standard_normal((Bq, KV, G, hd)).astype(
        np.float32))
    pool = rng.standard_normal((1 + Bq * nb, page, KV, hd)).astype(
        np.float32)
    k, v = torch.from_numpy(pool), torch.from_numpy(pool[::-1].copy())
    bt = torch.arange(1, 1 + Bq * nb, dtype=torch.int32).view(Bq, nb)
    pos = torch.tensor([0, 17, -1], dtype=torch.int32)
    o0 = paged_attention_reference(q, k, v, bt, pos, scale=0.3,
                                   soft_cap=soft_cap)
    o, lse = paged_attention_reference(q, k, v, bt, pos, scale=0.3,
                                       soft_cap=soft_cap, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (Bq, KV, G)
    # the seen rows' output is the same bits with or without lse
    assert torch.equal(o[:2], o0[:2])
    # the plain scores, by hand
    kk = k[bt.long()].reshape(Bq, nb * page, KV, hd)
    s = torch.einsum("bkgh,bskh->bkgs", q, kk) * 0.3
    if soft_cap:
        s = torch.tanh(s / soft_cap) * soft_cap
    for b in range(2):
        n = int(pos[b]) + 1
        torch.testing.assert_close(lse[b], torch.logsumexp(s[b, ..., :n], -1),
                                   rtol=1e-6, atol=1e-6)
    # a row that sees no line: o 0 and lse -inf, no NaN
    assert torch.equal(o[2], torch.zeros_like(o[2]))
    assert torch.isneginf(lse[2]).all()
    assert not torch.isnan(o).any()


def test_decode_specs_are_one_ranks_blocks():
    cfg = case_cfg("qwen 1x4")
    cell = ShapeCell("d", S, B, "decode")
    with fake_world(8, rank=6):
        mesh = make_host_mesh(data=2, model=4)
        args, in_specs, _ = tspecs.decode_specs(cfg, cell, mesh)
        local = decode_local_config(cfg, mesh)
    params, caches, tok, pos = args
    assert tuple(tok.shape) == (B // 2, 1) and tuple(pos.shape) == (B // 2,)
    assert layout_of(local) == LocalLayout(kv_seq=True)
    assert (local.n_heads, local.n_kv_heads) == (1, 2)
    k = caches[0]["b0"]["k"]
    # (layers, batch, lines, KV, hd): rows over data, lines over model
    assert tuple(k.shape) == (2, B // 2, S // 4, 2, cfg.hd)
    assert in_specs[1][0]["b0"]["k"] == (None, "data", "model")
    wq = params["segments"][0]["b0"]["mixer"]["wq"]
    assert tuple(wq.shape) == (2, cfg.d_model, 1, cfg.hd)


def test_decode_wire_bytes_refuses_lines_the_axis_does_not_divide():
    with pytest.raises(NotImplementedError, match="does not divide"):
        decode_wire_bytes(case_cfg("qwen 1x4"), {"data": 1, "model": 3}, 4,
                          64)
