"""Context-parallel attention (query heads that do not divide ``model``)
against the JAX package's GSPMD step, on the CPU: gloo ranks of the port
(one spawn of 4 ranks, torch on two intra-op threads) and the reference
in one subprocess with 8 forced host devices under ``launch/specs.py``
shardings, side by side, in float32 on smoke configs:

* ``gqa 1x4``: a smoke GQA config (qwen3-14b's) with 6 heads and 2 KV
  heads at (data 1, model 4), remat "full";
* ``whisper 1x4``: whisper-small's smoke with 6 heads at (1, 4), remat
  "full": self and cross attention context parallel, and an encoder of
  18 frames, which 4 does not divide, whole on every rank;
* ``gqa 2x1x2``: 3 heads and one KV head at (pod 2, data 1, model 2),
  remat "dots";
* ``tp_oproj 1x4``: the first config under ``tp_attn_inner`` (o gathered,
  the flat H x hd o-projection split over ``model``), remat "none";
* ``whole ffn 1x4``: the first config with d_ff 130, which 4 does not
  divide: the rules replicate the FFN and every rank runs it whole (a
  ``whole_ffn`` layout beside ``context_parallel``), remat "full".

and, for the prefill alone, each other layout whose rank returns its own
block of the dense cache (``prefill(..., cache_blocks=True)``):

* ``kv-sliced prefill 1x4``: qwen3-0.6b's smoke (4 heads, 2 KV heads)
  at (1, 4): a ``kv_sliced`` rank re-projects every KV head for its rows
  of the lines (``attention._block_lines``);
* ``head-parallel prefill 2x2``: the same at (data 2, model 2): the
  rank's KV heads, every line;
* ``mla prefill 2x2``: deepseek-v2's smoke (MLA, MoE) at (2, 2): the
  latent lines cut to the rank's rows (``line_rows(latent=True)``);
* ``vision prefill 1x4``: llama-3.2-vision's smoke at (1, 4), kv sliced:
  its cross-attention lines ck / cv cut to the rank's rows of the 16
  image tokens (``transformer._cross_attend``).

Held, each case from one initial state (a step-0 checkpoint the test
writes; the ranks restore their blocks, the reference the whole):

* the rank's local config has the case's layout
  (``models.common.LocalLayout``);

* loss, nll and the step's grad norm: rtol 1e-5 (as
  ``tests/test_torch_train_tp.py``: float32 sums of the same terms in
  other orders);
* every gradient leaf (the ranks' mean over the batch axes, the model
  blocks gathered whole): |g - g_ref| <= 1e-5 |g_ref| + 1e-5 max|g_ref|
  of the leaf, the reference's gradient bar at rtol 1e-5;
* the step's walked ``model`` bytes equal ``train.step.tp_wire_bytes``
  (rtol 1e-12), the sequence gathers included;
* prefill: the rank's last logits (whole: gathered over ``model``)
  within rtol 1e-5, atol 1e-6 of the reference's rows (the atol a
  2-layer case's, ``logits_atol``), and its block of
  the cache (``launch/specs.py::prefill_cache_specs``) within rtol 1e-5
  plus 1e-5 of the leaf's largest magnitude (``LINES_RTOL``) of the
  reference's states cut to that block.

The per-device W of one train and one prefill smoke cell (d_model 256,
6 heads, at (1, 8): context parallel) against the reference's
``analyze_compiled``: the bar and its derivation are beside ``W_BAR``.
The prefill's is held less the two layouts' difference in products
(``layout_products``), whose every piece is read from both programs:
the reference's dots from its compiled module's HLO, by op and result
shape (``hlo_cost.module_cost`` with only those dots priced, less the
walk with none), the port's products from its walk.
"""

import dataclasses
import json
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
from repro_torch.models import prefill
from repro_torch.models.common import (HEAD_PARALLEL, LocalLayout,
                                       ShapeCell, layout_of)
from repro_torch.models.params import tree_paths
from repro_torch.parallel import sharding as shd
from repro_torch.parallel.collectives import all_reduce_
from repro_torch.parallel.mesh import (batch_shard, batch_shards, dp_axes,
                                       fake_world, make_host_mesh, spawn,
                                       use_mesh)
from repro_torch.train import (CheckpointManager, OptConfig,
                               SyntheticLMData, TrainConfig,
                               make_initial_state, make_train_step)
from repro_torch.train.loop import abstract_state, state_shards
from repro_torch.train.step import (tp_wire_bytes, train_local_config,
                                    value_and_grad)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, SEED = 4, 16, 3
OPT = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
RTOL = 1e-5
GRAD_RTOL = GRAD_ATOL = 1e-5
LOGITS_RTOL, LOGITS_ATOL = 1e-5, 1e-6
# a cache line sums D products, rounded in another order than the
# reference's, then qk-normed and rotated: an element near zero keeps its
# terms' roundings, so the bar adds 1e-5 of the leaf's largest magnitude
LINES_RTOL = 1e-5
THREADS = 2

# tag -> (arch, heads, kv heads, (pod, data, model), remat, tp_oproj,
# d_ff, train step held (else the prefill alone)); 0: the smoke config's
CASES = {
    "gqa 1x4": ("qwen3-14b", 6, 2, (1, 1, 4), "full", False, 0, True),
    "whisper 1x4": ("whisper-small", 6, 6, (1, 1, 4), "full", False, 0,
                    True),
    "gqa 2x1x2": ("qwen3-14b", 3, 1, (2, 1, 2), "dots", False, 0, True),
    "tp_oproj 1x4": ("qwen3-14b", 6, 2, (1, 1, 4), "none", True, 0, True),
    "whole ffn 1x4": ("qwen3-14b", 6, 2, (1, 1, 4), "full", False, 130,
                      True),
    "kv-sliced prefill 1x4": ("qwen3-0.6b", 0, 0, (1, 1, 4), "none", False,
                              0, False),
    "head-parallel prefill 2x2": ("qwen3-0.6b", 0, 0, (1, 2, 2), "none",
                                  False, 0, False),
    "mla prefill 2x2": ("deepseek-v2-236b", 0, 0, (1, 2, 2), "none", False,
                        0, False),
    "vision prefill 1x4": ("llama-3.2-vision-90b", 0, 0, (1, 1, 4), "none",
                           False, 0, False),
}
CP = LocalLayout(context_parallel=True)
LAYOUTS = {"gqa 1x4": CP, "whisper 1x4": CP, "gqa 2x1x2": CP,
           "tp_oproj 1x4": CP,
           "whole ffn 1x4": LocalLayout(context_parallel=True,
                                        whole_ffn=True),
           "kv-sliced prefill 1x4": LocalLayout(kv_sliced=True),
           "head-parallel prefill 2x2": HEAD_PARALLEL,
           "mla prefill 2x2": HEAD_PARALLEL,
           "vision prefill 1x4": LocalLayout(kv_sliced=True)}
STEPS = [tag for tag in CASES if CASES[tag][7]]
FRAMES = 18                      # whisper's encoder frames: 4 does not divide

# The W check: one train and one prefill cell of a smoke config widened to
# d_model 256 (hd 32, 6 heads, d_ff 512), at (data 1, model 8), B 8 x S 64
W_MESH, W_B, W_S = (1, 8), 8, 64
# W (per-device FLOPs), the port's walk over the reference's compiled
# module: the walk counts every aten op where XLA counts its fusions'
# HLO ops, under one convention (op_cost.py); they part where XLA folds
# or rewrites arithmetic (a softmax's max and subtract, the norms'
# reductions, the causal mask's select) and where the two programs do
# different redundant work: GSPMD may compute a replicated product once
# a device where the port computes it on every rank alike, and the port
# computes K / V over the whole sequence on every rank as the reference's
# constraint (kv replicated) asks.  On one device the two counts part by
# 0.1% (decode) to 5.5% (a train step) (PERF.md); the bar is 15% each way,
# the reference's own bar for its ledger against the HLO (1.15).  The
# prefill's layouts part by more: its bar holds W less their difference.
W_BAR = 1.15


def case_cfg(tag: str):
    """The case's config (and its own name, so its initial state has a
    directory of its own)."""
    arch, heads, kv, _, remat, inner, d_ff, _ = CASES[tag]
    cfg = tcfg.smoke(tcfg.get_config(arch))
    cfg = dataclasses.replace(
        cfg, n_heads=heads or cfg.n_heads, n_kv_heads=kv or cfg.n_kv_heads,
        remat=remat, tp_attn_inner=inner, d_ff=d_ff or cfg.d_ff,
        name=f"{cfg.name}-{tag.replace(' ', '-')}")
    if cfg.is_encoder_decoder:
        cfg = dataclasses.replace(cfg, n_audio_frames=FRAMES)
    return cfg


def logits_atol(cfg) -> float:
    """LOGITS_ATOL is a 2-layer case's bar: each layer adds the roundings
    of its sums in another order than the reference's (the row-parallel
    reduces over ``model``; the gathers are exact), so a deeper case
    takes it times L / 2: llama-3.2-vision's smoke has 5 layers, its
    period (one cross-attention layer, four self-attention)."""
    return LOGITS_ATOL * max(1.0, cfg.n_layers / 2)


def w_cfg():
    cfg = tcfg.smoke(tcfg.get_config("qwen3-14b"))
    return dataclasses.replace(cfg, d_model=256, n_heads=6, n_kv_heads=2,
                               head_dim=32, d_ff=512, remat="full",
                               name="qwen3-14b-w")


def _mesh(shape):
    pod, data, model = shape
    return make_host_mesh(data=data, model=model, pod=pod)


def _gather_objects(obj, world: int) -> list:
    import torch.distributed as dist
    every = [None] * world
    dist.all_gather_object(every, obj)
    return every


def _case(tag: str, init_dir: str, world: int) -> dict:
    """The case on its mesh: its local layout; every rank's prefill logits
    and cache block, numpy; for a train case also rank 0's loss / nll /
    grad norm, its gradients (batch-axis mean, gathered whole), the
    walked ``model`` bytes and ``tp_wire_bytes``."""
    cfg = case_cfg(tag)
    mesh = _mesh(CASES[tag][3])
    mgr = CheckpointManager(os.path.join(init_dir, cfg.name), mesh=mesh,
                            shards=state_shards(cfg, mesh))
    state = mgr.restore(abstract_state(cfg, mesh), 0, device="cpu")[0]
    data = SyntheticLMData(cfg, B, S, seed=SEED, device="cpu",
                           shard=batch_shard(mesh),
                           shards=batch_shards(mesh))
    batch = data.batch_at(0)
    local = train_local_config(cfg, mesh)
    src = {k: batch[k] for k in ("enc_embeds", "img_embeds") if k in batch}
    with use_mesh(mesh, process_wide=True), torch.no_grad():
        lg, st = prefill(state["params"], local, batch["tokens"],
                         cache_blocks=True, **src)
    blocks = _gather_objects(
        (lg.numpy(), {k: v.numpy() for k, v in tree_paths(st)}), world)
    out = {"blocks": blocks, "layout": layout_of(local), "mesh": mesh.sizes}
    if not CASES[tag][7]:
        return out
    sh = dict(tree_paths(state_shards(cfg, mesh)))
    with use_mesh(mesh, process_wide=True):
        _, _, grads = value_and_grad(state["params"], batch, local)
        axes, R = dp_axes(mesh), batch_shards(mesh)
        whole = {}
        for k, g in tree_paths(grads):
            g = all_reduce_(g.clone(), axes) / R
            b = sh[f"params/{k}"]
            whole[k] = (g if b is None else b.gather(g)).numpy()
    from repro_torch.core.roofline.op_collectives import (CollectiveWalk,
                                                          summarize)
    tc = TrainConfig(opt=OPT)
    with CollectiveWalk(mesh=mesh) as walk:
        _, m = make_train_step(cfg, tc, mesh)(state, batch)
    walked = {k[0]: v for k, v in summarize(walk.ops).by_axes.items()}
    return {**out, "grads": whole, "walked": walked,
            "metrics": {k: float(m[k]) for k in ("loss", "nll",
                                                 "grad_norm")},
            "tp": tp_wire_bytes(cfg, mesh.sizes, B, S, tc)}


def four_ranks(rank: int, world: int, init_dir: str) -> dict:
    torch.set_num_threads(THREADS)
    return {tag: _case(tag, init_dir, world) for tag in CASES}


def w_walks() -> dict:
    """The port's per-device W of the W cells, rank 0 of a fake world of
    8 (fake tensors): {kind: (W, its matrix products' FLOPs)}, and the
    prefill's products in attention and the logits, by scope
    ({"pieces": ...})."""
    from repro_torch.core.roofline import op_cost
    products = op_cost._MATMUL_OPS | op_cost._SDPA_OPS
    cfg = w_cfg()
    out = {}
    with fake_world(8):
        mesh = make_host_mesh(data=W_MESH[0], model=W_MESH[1])
        for kind in ("train", "prefill"):
            cell = ShapeCell("w", W_S, W_B, kind)
            if kind == "train":
                args, _, _ = tspecs.train_specs(cfg, cell, mesh)
                fn = make_train_step(cfg, TrainConfig(), mesh)
            else:
                args, _, _ = tspecs.prefill_specs(cfg, cell, mesh)
                local = train_local_config(cfg, mesh)

                def fn(p, t, local=local):
                    with use_mesh(mesh, process_wide=True), torch.no_grad():
                        return prefill(p, local, t, cache_blocks=True)
            rep = analyze_step(fn, args=args, mesh=mesh, dtype=cfg.dtype)
            prods = [r for r in rep.record["ops"] if r["op"] in products]
            out[kind] = (rep.character.flops_dev,
                         op_cost.price(prods).flops)
            if kind == "prefill":
                out["pieces"] = {piece: op_cost.price(
                    [r for r in prods if r["scope"] == scope]).flops
                    for piece, scope in (("attention", "fused_attention"),
                                         ("logits", "logits"))}
    return out


_REFERENCE = textwrap.dedent("""
    import json, os, re, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, jax, numpy as np
    from repro.configs import get_config, smoke
    from repro.core.analysis import analyze_step
    from repro.core.roofline import hlo_cost
    from repro.launch import specs as specs_mod
    from repro.models import loss_fn, prefill
    from repro.models.common import ShapeCell
    from repro.parallel.mesh import make_mesh, mesh_context
    from repro.parallel.sharding import sharding_context
    from repro.train import CheckpointManager, SyntheticLMData
    from repro.train.checkpoint import _flat
    from repro.train.loop import make_initial_state
    from repro.train.optimizer import OptConfig
    from repro.train.step import TrainConfig, make_train_step

    out_path, init_dir = sys.argv[1:3]
    B, S, SEED, FRAMES = {B}, {S}, {SEED}, {FRAMES}
    CASES = {CASES!r}
    W_MESH, W_B, W_S = {W_MESH!r}, {W_B}, {W_S}
    OPT = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    out = {{}}

    def case_cfg(tag):
        arch, heads, kv, _, remat, inner, d_ff, _ = CASES[tag]
        cfg = smoke(get_config(arch))
        cfg = dataclasses.replace(
            cfg, n_heads=heads or cfg.n_heads,
            n_kv_heads=kv or cfg.n_kv_heads, remat=remat,
            tp_attn_inner=inner, d_ff=d_ff or cfg.d_ff,
            name=f"{{cfg.name}}-{{tag.replace(' ', '-')}}")
        if cfg.is_encoder_decoder:
            cfg = dataclasses.replace(cfg, n_audio_frames=FRAMES)
        return cfg

    def mesh_of(shape):
        pod, data, model = shape
        if pod > 1:
            return make_mesh(shape, ("pod", "data", "model"))
        return make_mesh((data, model), ("data", "model"))

    def dot_key(op):
        # the dot's source op (its op_name below the loops' calls) and
        # its result's dims
        m = re.search(r'op_name="([^"]*)"', op.attrs)
        name = (m.group(1) if m else "").rsplit("closed_call/", 1)[-1]
        if name.startswith("jit("):
            name = name.split(")/", 1)[-1]
        return name + "|" + op.shape.split("[", 1)[1].split("]", 1)[0]

    def dots(compiled):
        # {{dot key: its FLOPs}}: the module's W walked again with only
        # that key's dots priced, less the walk with none (loops and
        # fusions counted as W counts them)
        text = compiled.as_text()
        base, keys = hlo_cost._dot_flops, set()
        try:
            hlo_cost._dot_flops = lambda op, c: keys.add(dot_key(op)) or 0.0
            none = hlo_cost.module_cost(text).flops
            table = {{}}
            for k in sorted(keys):
                hlo_cost._dot_flops = (lambda op, c, k=k: base(op, c)
                                       if dot_key(op) == k else 0.0)
                table[k] = hlo_cost.module_cost(text).flops - none
        finally:
            hlo_cost._dot_flops = base
        return np.asarray(json.dumps(table))

    for tag, (arch, heads, kv, shape, remat, inner, _, step_held) in \
            CASES.items():
        cfg = case_cfg(tag)
        mesh = mesh_of(shape)
        abstract = jax.eval_shape(make_initial_state(cfg))
        state0 = CheckpointManager(os.path.join(init_dir, cfg.name)).restore(
            abstract, 0)[0]
        batch = SyntheticLMData(cfg, B, S, seed=SEED).batch_at(0)
        with sharding_context(mesh):
            _, in_sh, out_sh = specs_mod.train_specs(
                cfg, ShapeCell("t", S, B, "train"), mesh)
            _, p_sh, _ = specs_mod.prefill_specs(
                cfg, ShapeCell("p", S, B, "prefill"), mesh)
            with mesh_context(mesh):
                if step_held:
                    state = jax.device_put(state0, in_sh[0])
                    b = jax.device_put(batch, in_sh[1])
                    grad = jax.jit(lambda p, bb: jax.grad(
                        lambda q: loss_fn(q, bb, cfg)[0])(p),
                        in_shardings=(in_sh[0]["params"], in_sh[1]))
                    for k, v in _flat(grad(state["params"], b)).items():
                        out[f"{{tag}}/grad/{{k}}"] = np.asarray(v)
                    step = jax.jit(
                        make_train_step(cfg, TrainConfig(opt=OPT)),
                        in_shardings=in_sh, out_shardings=out_sh)
                    _, m = step(state, b)
                    for k in ("loss", "nll", "grad_norm"):
                        out[f"{{tag}}/{{k}}"] = np.asarray(m[k])
                src = [batch[k] for k in ("enc_embeds", "img_embeds")
                       if k in batch]
                kw = ("enc_embeds" if cfg.is_encoder_decoder else
                      "img_embeds")
                fn = jax.jit(lambda p, t, *s: prefill(
                    p, cfg, t, **({{kw: s[0]}} if s else {{}})),
                    in_shardings=p_sh)
                args = [jax.device_put(state0["params"], p_sh[0]),
                        jax.device_put(batch["tokens"], p_sh[1])]
                args += [jax.device_put(s, p_sh[2]) for s in src]
                lg, st = fn(*args)
                out[f"{{tag}}/prefill/logits"] = np.asarray(lg)
                for k, v in _flat(st).items():
                    out[f"{{tag}}/prefill/{{k}}"] = np.asarray(v)

    # the W cells: the reference's analyze_compiled of one rank's module
    cfg = dataclasses.replace(smoke(get_config("qwen3-14b")), d_model=256,
                              n_heads=6, n_kv_heads=2, head_dim=32,
                              d_ff=512, remat="full", name="qwen3-14b-w")
    mesh = make_mesh(W_MESH, ("data", "model"))
    with sharding_context(mesh):
        cell = ShapeCell("w", W_S, W_B, "train")
        args, in_sh, out_sh = specs_mod.train_specs(cfg, cell, mesh)
        rep, comp = analyze_step(make_train_step(cfg, TrainConfig()),
                                 args=args, mesh=mesh, in_shardings=in_sh,
                                 out_shardings=out_sh, label="w train")
        out["w/train"] = np.asarray(rep.character.flops_dev)
        out["w/train/dots"] = dots(comp)
        cell = ShapeCell("w", W_S, W_B, "prefill")
        args, in_sh, _ = specs_mod.prefill_specs(cfg, cell, mesh)
        rep, comp = analyze_step(lambda p, t: prefill(p, cfg, t),
                                 args=args, mesh=mesh, in_shardings=in_sh,
                                 label="w prefill")
        out["w/prefill"] = np.asarray(rep.character.flops_dev)
        out["w/prefill/dots"] = dots(comp)
    np.savez(out_path, **out)
    print("RESULT ok")
""").format(B=B, S=S, SEED=SEED, FRAMES=FRAMES, CASES=CASES, W_MESH=W_MESH,
            W_B=W_B, W_S=W_S)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess, started first, and the port's ranks and
    walks meanwhile: {"ref", "four", "w"}."""
    tmp = tmp_path_factory.mktemp("seq_parallel")
    init_dir = str(tmp / "init")
    for tag in CASES:
        cfg = case_cfg(tag)
        state = make_initial_state(cfg, 0, "cpu")()
        CheckpointManager(os.path.join(init_dir, cfg.name)).save(state, 0)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ref_path = tmp / "ref.npz"
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(ref_path), init_dir],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    try:
        four = spawn(four_ranks, 4, device="cpu", args=(init_dir,),
                     timeout=400)
        w = w_walks()
        stdout, stderr = proc.communicate(timeout=420)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert "RESULT ok" in stdout, (stdout[-2000:], stderr[-3000:])
    with np.load(ref_path) as f:
        ref = {k: f[k] for k in f.files}
    return {"ref": ref, "four": four, "w": w}


@pytest.mark.parametrize("tag", STEPS)
def test_context_parallel_step_matches_reference(runs, tag):
    got, ref = runs["four"][tag], runs["ref"]
    assert got["layout"] == LAYOUTS[tag]
    for k, v in got["metrics"].items():
        np.testing.assert_allclose(v, float(ref[f"{tag}/{k}"]), rtol=RTOL,
                                   atol=1e-12, err_msg=k)
    assert set(got["grads"]) == {k.split("/grad/", 1)[1] for k in ref
                                 if k.startswith(f"{tag}/grad/")}
    for k, g in got["grads"].items():
        want = ref[f"{tag}/grad/{k}"].astype(np.float64)
        assert g.shape == want.shape, k
        bar = GRAD_RTOL * np.abs(want) + GRAD_ATOL * max(
            float(np.abs(want).max()), 1e-30)
        err = np.abs(g.astype(np.float64) - want)
        assert (err <= bar).all(), (k, float(err.max()),
                                    float((err / bar).max()))


@pytest.mark.parametrize("tag", STEPS)
def test_context_parallel_walk_equals_tp_wire_bytes(runs, tag):
    got = runs["four"][tag]
    assert got["tp"]["seq_gather"] > 0
    np.testing.assert_allclose(got["walked"]["model"], got["tp"]["model"],
                               rtol=1e-12)


@pytest.mark.parametrize("tag", list(CASES))
def test_context_parallel_prefill_matches_reference(runs, tag):
    got, ref = runs["four"][tag], runs["ref"]
    assert got["layout"] == LAYOUTS[tag]
    cfg = case_cfg(tag)
    sizes = got["mesh"]
    names, shape = tuple(sizes), tuple(sizes.values())
    from repro_torch.parallel.mesh import Mesh
    specs = tspecs.prefill_cache_specs(cfg, B, S, sizes)
    from repro_torch.models import cache_param_defs
    from repro_torch.models.params import tree_map
    for r, (logits, block) in enumerate(got["blocks"]):
        mesh = Mesh(names, shape, rank=r)
        rows = B // batch_shards(mesh)
        lo = batch_shard(mesh) * rows
        np.testing.assert_allclose(
            logits, ref[f"{tag}/prefill/logits"][lo:lo + rows],
            rtol=LOGITS_RTOL, atol=logits_atol(cfg), err_msg=f"rank {r}")
        blk = dict(tree_paths(tree_map(
            lambda d, sp: shd.leaf_block(sp, mesh),
            cache_param_defs(cfg, B, S), specs)))
        assert set(block) == set(blk)
        for k, v in block.items():
            want = ref[f"{tag}/prefill/{k}"]
            want = torch.from_numpy(want)
            want = (want if blk[k] is None else blk[k].take(want)).numpy()
            assert v.shape == want.shape, (r, k, v.shape, want.shape)
            np.testing.assert_allclose(
                v, want, rtol=LINES_RTOL,
                atol=LINES_RTOL * float(np.abs(want).max()),
                err_msg=f"{r} {k}")


# query rows of each sequence that the reference's compiled prefill
# attends a device: its chunk loop (S / attn_chunk = 4 trips) runs on 8
# query rows a trip on every device (the loop's output is f32[4, B, 8,
# KV, G, hd]), where the port's rank attends its own S / n = 8
REF_ATTN_ROWS = 32


def layout_products() -> dict:
    """The prefill W cell's per-device matrix products, piece by piece,
    as each layout runs them: {piece: (reference, port)}.  Both project
    q on the rank's T / n rows; the reference projects K and V on those
    rows and one of them again on all T, the port both on all T; the
    reference runs the o-projection on all T rows after gathering o, the
    port on its T / n rows, then gathers the output; attention as
    ``REF_ATTN_ROWS`` says; the FFN and the logits alike."""
    cfg = w_cfg()
    n, L, T = W_MESH[1], cfg.n_layers, W_B * W_S
    r, D, F = T // n, cfg.d_model, cfg.d_ff // n
    Hhd, KVhd = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd

    def attention(rows):         # Q K^T and P V, `rows` of each sequence
        return L * 2 * 2 * W_B * rows * W_S * Hhd

    return {"q": (L * 2 * r * D * Hhd,) * 2,
            "kv": (L * 2 * (2 * r + T) * D * KVhd, L * 2 * 2 * T * D * KVhd),
            "o": (L * 2 * T * Hhd * D, L * 2 * r * Hhd * D),
            "attention": (attention(REF_ATTN_ROWS), attention(W_S // n)),
            "ffn": (L * 3 * 2 * T * D * F,) * 2,
            "logits": (2 * T * D * (cfg.vocab_size // n),) * 2}


def reference_pieces(table: dict) -> dict:
    """The reference's dots ({op name|result dims: FLOPs}, read from its
    compiled module) summed by piece of :func:`layout_products`; a dot of
    no piece fails."""
    cfg = w_cfg()
    out = dict.fromkeys(layout_products(), 0.0)
    for key, flops in table.items():
        name, dims = key.split("|")
        last = int(dims.split(",")[-1])
        if "fused_attention" in name:
            piece = "attention"
        elif name.startswith("logits"):
            piece = "logits"
        elif name.startswith("bqhx,hxd->bqd"):
            piece = "o"
        elif name.startswith("bsd,dhk->bshk"):
            piece = {cfg.n_heads * cfg.hd: "q",
                     cfg.n_kv_heads * cfg.hd: "kv"}[last]
        elif name == "dot_general":
            piece = "ffn"
        else:
            raise AssertionError(f"a dot of no piece: {key}")
        out[piece] += flops
    return out


def _w(runs, kind):
    """(port W, its products; reference W, its dots by key) of a W cell."""
    got, got_prod = runs["w"][kind]
    table = json.loads(str(runs["ref"][f"w/{kind}/dots"]))
    return got, got_prod, float(runs["ref"][f"w/{kind}"]), table


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_per_device_w_against_reference(runs, kind):
    """The train cell's W against the reference's as it is; the prefill
    cell's against the reference's less the layouts' difference in
    products (:func:`layout_products`, its pieces held against both
    programs by :func:`test_prefill_products_differ_by_the_layouts_alone`:
    GSPMD repeats the o-projection and attention on more rows, the port
    the K / V projections), each within W_BAR."""
    got, got_prod, want, table = _w(runs, kind)
    layout = 0.0
    if kind == "prefill":
        layout = sum(a - b for a, b in layout_products().values())
    ratio = got / (want - layout)
    print(f"W {kind} at (1, 8): walk {got:.6g} / compiled {want:.6g} = "
          f"{got / want:.4f} raw; products {got_prod:.6g}, dots "
          f"{sum(table.values()):.6g}; less the layouts' difference "
          f"{layout:.6g}: {ratio:.4f}")
    assert 1 / W_BAR <= ratio <= W_BAR, ratio


def test_prefill_products_differ_by_the_layouts_alone(runs):
    """Each piece of :func:`layout_products` is there: the reference's
    dots, read from its compiled prefill, piece by piece; the port's
    walked products in attention and the logits (by their scopes) and in
    the rest together (K / V and the FFN share a shape)."""
    got, got_prod, want, table = _w(runs, "prefill")
    claims = layout_products()
    ref = reference_pieces(table)
    for piece, (theirs, _) in claims.items():
        assert ref[piece] == theirs, (piece, ref[piece], theirs)
    mine = runs["w"]["pieces"]
    for piece in ("attention", "logits"):
        assert mine[piece] == claims[piece][1], (piece, mine[piece])
    assert got_prod == sum(c[1] for c in claims.values()), got_prod


def test_heads_that_divide_keep_the_head_parallel_layout():
    """A config whose heads divide the axis is not context parallel: the
    training mode's local config equals serving's there."""
    cfg = tcfg.smoke(tcfg.get_config("qwen3-0.6b"))
    local = shd.tp_local_config(cfg, 2, train=True)
    assert layout_of(local) == HEAD_PARALLEL
    assert local == shd.tp_local_config(cfg, 2)
    cp = shd.tp_local_config(dataclasses.replace(cfg, n_heads=6), 4,
                             train=True)
    assert layout_of(cp) == CP and cp.n_heads == 6
    assert shd.tp_width_error(dataclasses.replace(cfg, n_heads=6), 4) \
        is not None
    assert shd.tp_width_error(dataclasses.replace(cfg, n_heads=6), 4,
                              train=True) is None
