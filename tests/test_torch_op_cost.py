"""The op-level cost walk (``core/roofline/op_cost.py``), the step
character (``extract.py``) and kernel substitution (``substitute.py``).

The walk's conventions on single ops (a matmul's FLOPs, elementwise and
transcendental counts, a gather charged its rows, an in-place pool write
charged its region, views free), then the walk of the port's smoke decode
step against the reference's HLO cost walk
(``repro.core.roofline.hlo_cost``, through ``repro.serve.crosscheck``) on
the same config, the scope tags' neutrality, and ``substitute.py`` against
the reference's on the same dicts."""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models as jm
import repro.serve as jserve
from repro.core.roofline import substitute as jsub
from repro.serve import crosscheck as jxc
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.core.roofline import extract, op_cost
from repro_torch.core.roofline import substitute as tsub
from repro_torch.core.roofline.hardware import chip_scope
from repro_torch.serve import crosscheck as txc


def _walk(fn, *args, params=None, pools=None):
    return op_cost.walk(fn, *args, params=params, pools=pools)[0]


# --------------------------------------------------------------------------
# conventions on single ops
# --------------------------------------------------------------------------

def test_matmul_flops_and_bytes():
    a, b = torch.zeros(8, 32), torch.zeros(32, 16)
    c = _walk(lambda: a @ b)
    assert c.flops == 2 * 8 * 16 * 32
    assert c.bytes == (8 * 32 + 32 * 16 + 8 * 16) * 4
    assert c.op_counts == {"mm": 1}
    x, w = torch.zeros(3, 5, 8), torch.zeros(3, 8, 4)
    assert _walk(torch.bmm, x, w).flops == 2 * 3 * 5 * 4 * 8
    # einsum lowers to a matmul over the contracted size
    e = _walk(lambda: torch.einsum("bqh,bsh->bqs", x, torch.zeros(3, 7, 8)))
    assert e.flops == 2 * 3 * 5 * 7 * 8


def test_elementwise_reductions_and_movement():
    x, y = torch.zeros(4, 6), torch.zeros(4, 6)
    assert _walk(torch.add, x, y).flops == 24
    assert _walk(torch.add, x, y).bytes == 3 * 24 * 4
    assert _walk(lambda: x.sum(-1)).flops == 24
    assert _walk(lambda: x.amax(-1)).flops == 0          # compares only
    assert _walk(lambda: torch.where(x > 0, x, y)).flops == 0
    assert _walk(lambda: x.to(torch.bfloat16)).flops == 0
    # a broadcast operand counts the elements it spans
    b = torch.zeros(6)
    assert _walk(torch.mul, x, b.expand(4, 6)).bytes == (24 + 6 + 24) * 4


def test_transcendentals_counted_apart():
    x = torch.zeros(10)
    for fn in (torch.exp, torch.tanh, torch.rsqrt, torch.sqrt, torch.sin,
               torch.cos, torch.sigmoid, torch.erf, torch.log,
               lambda t: t ** 0.5):
        c = _walk(fn, x)
        assert (c.flops, c.transcendentals) == (10, 10), fn
    sq = _walk(lambda t: t ** 2, x)                      # a multiply in HLO
    assert (sq.flops, sq.transcendentals) == (10, 0)
    silu = _walk(torch.nn.functional.silu, x)            # x * logistic(x)
    assert (silu.flops, silu.transcendentals) == (20, 10)
    sm = _walk(lambda t: torch.softmax(t, -1), torch.zeros(3, 10))
    assert (sm.flops, sm.transcendentals) == (120, 30)


def test_gather_charged_its_rows_not_the_table():
    table = torch.zeros(1000, 64)
    idx = torch.tensor([3, 7, 7], dtype=torch.long)
    c = _walk(lambda: table[idx], params={"t": table})
    rows = 3 * 64 * 4
    assert c.bytes == 2 * rows + 3 * 8
    assert c.by_category == {"param": rows, "pool": 0.0,
                             "activation": rows + 3 * 8}
    e = _walk(torch.nn.functional.embedding, idx, table,
              params={"t": table})
    assert e.param_bytes == rows and e.bytes == 2 * rows + 3 * 8


def test_inplace_pool_write_charged_its_region():
    pool = torch.zeros(100, 16, 8, 32)        # (pages, page, KV, hd)
    blk = torch.tensor([5, 9], dtype=torch.long)
    off = torch.tensor([0, 3], dtype=torch.long)
    new = torch.ones(2, 8, 32)
    region = 2 * 8 * 32 * 4
    c = _walk(lambda: pool.index_put_((blk, off), new), pools=[pool])
    assert c.pool_bytes == region                      # written once
    assert c.activation_bytes == region + 2 * 2 * 8    # values + indices
    acc = _walk(lambda: pool.index_put_((blk, off), new, accumulate=True),
                pools=[pool])
    assert acc.pool_bytes == 2 * region                # read-modify-write
    # a copy into a slice of a pool costs the slice (the source's fill
    # writes it once, the copy reads it)
    s = _walk(lambda: pool[5, :4].copy_(torch.ones(4, 8, 32)), pools=[pool])
    piece = 4 * 8 * 32 * 4
    assert s.pool_bytes == piece and s.bytes == 3 * piece
    # index_add_: fills of the target and the source, then indices, source
    # and the region read, the region written
    ia = _walk(lambda: torch.zeros(10, 4).index_add_(
        0, blk, torch.ones(2, 4)))
    assert ia.bytes == 10 * 4 * 4 + 4 * (2 * 4 * 4) + 2 * 8


def test_views_are_free_and_a_copy_is_not():
    x = torch.zeros(4, 8, 16)
    for fn in (lambda: x.view(32, 16), lambda: x.permute(2, 0, 1),
               lambda: x.transpose(0, 1), lambda: x[1:3], lambda: x[0],
               lambda: x.unsqueeze(0), lambda: x[None].squeeze(0),
               lambda: x.reshape(4, 128), lambda: x[:, :1].expand(4, 8, 16),
               lambda: x.detach()):
        c = _walk(fn)
        assert c.bytes == 0 and c.flops == 0
    c = _walk(lambda: x.permute(2, 0, 1).contiguous())
    assert c.bytes == 2 * x.numel() * 4
    # a view of a parameter stays a parameter
    w = torch.zeros(8, 16)
    c = _walk(lambda: torch.zeros(3, 16) @ w.t(), params=[w])
    assert c.param_bytes == w.numel() * 4


def test_named_scope_innermost_tracked_tag():
    x = torch.zeros(8, 8)
    mode = op_cost.OpCostMode()
    with mode:
        with op_cost.named_scope("logits"):
            x + x
            with op_cost.named_scope("untracked"):
                x * x
            with op_cost.named_scope("paged_attention"):
                x @ x
        x - x
    s = mode.cost.scopes
    assert s["logits"]["flops"] == 128 and s["logits"]["bytes"] == 6 * 256
    assert s["paged_attention"]["flops"] == 2 * 8 * 8 * 8
    assert mode.cost.flops == 128 + 1024 + 64
    assert op_cost.current_scope() is None


# --------------------------------------------------------------------------
# the step character
# --------------------------------------------------------------------------

def test_characterize_and_dump_keys():
    w = torch.zeros(16, 32)
    char = extract.characterize(lambda x: (x @ w).exp(), torch.zeros(4, 16),
                                params=[w])
    assert char.flops_dev == 2 * 4 * 32 * 16 + 4 * 32
    assert char.transcendentals_dev == 4 * 32
    assert char.memory.argument_bytes == 4 * 16 * 4
    assert char.memory.output_bytes == 4 * 32 * 4
    assert char.cost_raw["naive_flops"] == 2 * 4 * 32 * 16
    assert char.bytes_by_category["param"] == 16 * 32 * 4
    d = extract.character_as_dict(char)
    want = {"flops_dev", "hbm_bytes_dev", "transcendentals_dev",
            "collective_wire_bytes_dev", "collective_ici_bytes_dev",
            "collective_dcn_bytes_dev", "collective_by_kind",
            "collective_by_axes", "n_collective_ops", "memory", "op_counts",
            "scopes", "cost_raw"}
    assert want <= set(d) and d["collective_wire_bytes_dev"] == 0.0
    base = char.subtract(char)
    assert (base.flops_dev, base.hbm_bytes_dev) == (0.0, 0.0)
    t = extract.terms_from_character(char, chip_scope(), dtype="float32")
    assert t.flops_dev == char.flops_dev and t.ici_wire_bytes_dev == 0.0


# --------------------------------------------------------------------------
# the smoke decode step against the reference's HLO cost walk
# --------------------------------------------------------------------------

def _engines(arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    ecfg = dict(num_slots=4, page_size=4, max_len=32)
    jeng = jserve.Engine(jc, jp, jserve.EngineConfig(kernel_backend="jnp",
                                                     **ecfg))
    teng = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu", **ecfg))
    jeng.reset()                  # a live pool: the walks need only shapes
    teng.reset()
    return jeng, teng


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "deepseek-v2-236b"])
def test_walk_flops_match_reference_hlo_walk(arch):
    """FlopCounterMode counts the matmuls alone; both walks count those the
    same way (2 x result x contracted size), so whatever separates the
    port's walk from the reference's HLO walk lies in the non-matmul ops
    (index arithmetic, masks, softmax spelling): the tolerance is the
    port walk's non-matmul FLOPs, W - naive.  Transcendentals match but
    for the RoPE tables: the port computes one (sin, cos) table of B x
    dr / 2 angles a step and hands it to every layer, the reference's MLA
    computes it for the queries and the latent key of each layer segment
    (GQA's are hoisted out of its layer loop, so they match exactly)."""
    jeng, teng = _engines(arch)
    ref = jxc.decode_step_character(jeng)
    got = txc.decode_step_character(teng)
    naive = got.cost_raw["naive_flops"]
    assert abs(got.flops_dev - ref.flops_dev) <= got.flops_dev - naive
    cfg = teng.cfg
    table = 2 * teng.ecfg.num_slots * (cfg.rope_head_dim // 2)
    extra = ref.transcendentals_dev - got.transcendentals_dev
    if arch == "qwen3-0.6b":
        assert extra == 0
    else:
        tables = 2 * len(cfg.segments())
        assert extra == (tables - 1) * table, (extra, table)
    assert set(got.scopes) == set(ref.scopes)


def test_named_scope_changes_no_stream_and_no_op(monkeypatch):
    """The tags are Python-only: with every ``named_scope`` a no-op the
    engine's greedy streams and the decode step's dispatched ops (what a
    captured graph launches) are the same, on an arch that opens all four
    of the port's tagged regions (MLA paged attention, MoE dispatch and
    experts, logits)."""
    import contextlib
    from repro_torch.models import attention, layers, mla, moe
    cfg = tcfg.smoke(tcfg.get_config("deepseek-v2-236b"))
    params = tm.init_params(cfg, device="cpu")

    def run():
        eng = tserve.Engine(cfg, params, tserve.EngineConfig(
            device="cpu", num_slots=2, page_size=4, max_len=32))
        reqs = [eng.submit(np.random.RandomState(i).randint(
            0, cfg.vocab_size, 9).astype(np.int32),
            tserve.GenerateConfig(max_new_tokens=6)) for i in range(3)]
        eng.step()
        ops = txc.decode_step_character(eng).op_counts
        eng.run()
        return [list(r.generated) for r in reqs], ops

    with_tags = run()
    for mod in (attention, layers, mla, moe):
        monkeypatch.setattr(mod, "named_scope",
                            lambda tag: contextlib.nullcontext())
    assert run() == with_tags


# --------------------------------------------------------------------------
# substitution, against the reference on the same dicts
# --------------------------------------------------------------------------

def test_substitute_equals_reference():
    d = {"flops_dev": 5e9, "hbm_bytes_dev": 3e9,
         "scopes": {"paged_attention": {"flops": 1e8, "bytes": 9e8},
                    "fused_attention": {"flops": 4e9, "bytes": 2e9}}}
    for n_q in (1, 4):
        for qo in (0.0, 512.0):
            args = (copy.deepcopy(d), [7, 30, 129], 2048.0, qo, n_q)
            assert tsub.substitute_paged_attention(*args) == \
                jsub.substitute_paged_attention(*args)
            assert tsub.paged_attention_kernel_bytes(*args[1:]) == \
                jsub.paged_attention_kernel_bytes(*args[1:])
    assert tsub.substitute_paged_attention({"hbm_bytes_dev": 1.0}, [1],
                                           1.0) is None
    cell = dict(d, compute_s=1e-3, memory_s=2e-3, ici_s=0.0, dcn_s=0.0,
                n_chips=1, dtype="bfloat16", model_flops_total=4e9)
    for S in (512, 8192):
        assert tsub.flash_attention_ai(S) == jsub.flash_attention_ai(S)
        from repro.core.roofline.hardware import TPU_V5E
        from repro_torch.core.roofline.hardware import H100_SXM
        # the same arithmetic on the same chip numbers
        chip = dataclasses.replace(H100_SXM, hbm_bw=TPU_V5E.hbm_bw,
                                   peak_flops_by_dtype={
                                       "bfloat16": TPU_V5E.flops_for(
                                           "bfloat16")})
        assert tsub.substitute_flash(copy.deepcopy(cell), S, chip) == \
            jsub.substitute_flash(copy.deepcopy(cell), S, TPU_V5E)
        got = tsub.substitute_flash(copy.deepcopy(cell), S)
        assert got["memory_s"] == got["hbm_bytes_dev"] / H100_SXM.hbm_bw
