"""The port's sharding rules, tensor-parallel gates and collective ledger
against the JAX package's (``repro.parallel.sharding``,
``repro.serve.shard``, ``repro.serve.scheduler``), in one process (no
ranks): ``resolve_spec`` on the reference's cases and a hypothesis sweep,
the parameter and pool specs of every paging arch at tp 2 / 4 / 8, the
gates and local configs at tp 1-8, the analytic collective bytes, the
scopes, and the tensor-parallel ledger terms.  All exact (specs, counts,
bytes) or rel 1e-12 (terms)."""

import dataclasses

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.configs as jcfg
import repro.core.roofline.hardware as jhw
import repro.models as jm
import repro.parallel.sharding as jshd
import repro.serve.scheduler as jsch
import repro.serve.shard as jshard
import repro_torch.configs as tcfg
import repro_torch.core.roofline.hardware as thw
import repro_torch.models as tm
import repro_torch.parallel.sharding as tshd
import repro_torch.serve.scheduler as tsch
import repro_torch.serve.shard as tshard
from repro.models.common import BlockDef as JBlock
from repro_torch.models.common import BlockDef as TBlock
from repro_torch.models.params import tree_leaves

MESH = {"data": 16, "model": 16}
MESH3 = {"pod": 2, "data": 16, "model": 16}
CASES = [
    (["d_model", "d_ff"], [1024, 17408], MESH),
    (["vocab", "d_model"], [151936, 5120], MESH),
    (["batch", "seq"], [256, 4096], MESH3),
    (["batch", "seq"], [8, 4096], MESH3),
    (["batch", "seq"], [1, 4096], MESH3),
    (["vocab", "d_model"], [122753, 2304], MESH),
    (["batch", "kv_seq", "kv_heads", "head_dim"], [128, 32768, 8, 128], MESH),
    (["batch", "kv_seq", "kv_heads", "head_dim"], [128, 32768, 128, 128],
     MESH),
    (["experts", "d_model", "d_ff"], [160, 5120, 1536], MESH),
    (["layers", "none", "kv_seq", "kv_heads", "head_dim"],
     [28, 300, 16, 8, 128], {"data": 1, "model": 2}),
    ([None, "heads"], [4, 6], {"model": 3}),
]
PAGING = [a for a in jcfg.ALL_ARCHS
          if a not in ("whisper-small", "llama-3.2-vision-90b")]


def _j(spec):
    return tuple(spec)


@pytest.mark.parametrize("logical,shape,mesh", CASES)
def test_resolve_spec_equals_reference(logical, shape, mesh):
    for rules in ("DEFAULT", "DECODE_TP_RULES"):
        want = jshd.resolve_spec(logical, shape, mesh, getattr(jshd, rules))
        got = tshd.resolve_spec(logical, shape, mesh, getattr(tshd, rules))
        assert got == _j(want), (rules, got, want)


NAMES = sorted(tshd.DEFAULT_RULES)


@settings(max_examples=150, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(NAMES),
                          st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 40,
                                           151936])),
                min_size=1, max_size=5),
       st.sampled_from([1, 2, 3, 4, 8]), st.sampled_from([1, 2, 4, 16]),
       st.sampled_from([1, 2]), st.booleans())
def test_resolve_spec_sweep_equals_reference(dims, model, data, pod, tp):
    logical = [n for n, _ in dims]
    shape = [s for _, s in dims]
    mesh = {"pod": pod, "data": data, "model": model}
    rules = "DECODE_TP_RULES" if tp else "DEFAULT"
    want = jshd.resolve_spec(logical, shape, mesh, getattr(jshd, rules))
    assert tshd.resolve_spec(logical, shape, mesh,
                             getattr(tshd, rules)) == _j(want)


def _ref_specs(defs, mesh):
    return jshd.jax.tree.map(
        lambda d: _j(jshd.resolve_spec(d.logical, d.shape, mesh,
                                       jshd.DECODE_TP_RULES)),
        defs, is_leaf=lambda x: isinstance(x, jshd.ParamDef))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flat(t, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", PAGING)
@pytest.mark.parametrize("tp", [2, 4, 8])
def test_param_and_pool_specs_equal_reference(arch, tp):
    mesh = {"data": 1, "model": tp}
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    want = _ref_specs(jm.model_param_defs(jc), mesh)
    want["embed"]["tok"] = ()
    got = tshard.param_pspecs(tc, mesh)
    assert _flat(got) == _flat(want)
    want = _ref_specs(jm.paged_cache_defs(jc, 4, 33, 16), mesh)
    got = tshard.pool_pspecs(tc, 4, 33, 16, mesh)
    assert _flat(got) == _flat(want)
    # the port's defs carry the reference's logical names leaf by leaf
    jl = jshd.jax.tree.leaves(jm.model_param_defs(jc),
                              is_leaf=lambda x: isinstance(x, jshd.ParamDef))
    tl = tree_leaves(tm.model_param_defs(tc))
    assert [(d.shape, d.logical) for d in tl] == \
        [(d.shape, d.logical) for d in jl]
    assert tshd.tree_nbytes(tm.model_param_defs(tc)) == \
        jshd.tree_nbytes(jm.model_param_defs(jc))
    assert tshd.tree_count(tm.model_param_defs(tc)) == \
        jshd.tree_count(jm.model_param_defs(jc))


def _mla_dense(mod, block):
    return dataclasses.replace(
        mod.smoke(mod.get_config("deepseek-v2-236b")), name="mla-dense-smoke",
        block_pattern=(block("mla", "dense"),), n_layers=2, d_ff=128,
        n_experts=0, moe_top_k=0, moe_d_ff=0, n_shared_experts=0,
        moe_first_dense=0)


def _configs():
    out = []
    for arch in jcfg.ALL_ARCHS:
        for shrink in (False, True):
            j, t = jcfg.get_config(arch), tcfg.get_config(arch)
            if shrink:
                j, t = jcfg.smoke(j), tcfg.smoke(t)
            out.append((f"{arch}{'-smoke' if shrink else ''}", j, t))
    out.append(("mla-dense-smoke", _mla_dense(jcfg, JBlock),
                _mla_dense(tcfg, TBlock)))
    return out


CONFIGS = _configs()


@pytest.mark.parametrize("name,jc,tc", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_gates_local_configs_and_ici_bytes_equal_reference(name, jc, tc):
    for tp in range(1, 9):
        jerr, terr = jshard.tp_sharding_error(jc, tp), \
            tshard.tp_sharding_error(tc, tp)
        assert (jerr is None) == (terr is None), (tp, jerr, terr)
        if jerr is not None:
            # the same gate refuses: the same leading clause
            assert terr.split(":")[1].split()[:2] == \
                jerr.split(":")[1].split()[:2], (jerr, terr)
            with pytest.raises(NotImplementedError):
                tshard.tp_local_config(tc, tp)
        else:
            for ov in ("none", "ring"):
                assert dataclasses.asdict(tshard.tp_local_config(tc, tp, ov)) \
                    == dataclasses.asdict(jshard.tp_local_config(jc, tp, ov))
        assert tsch.kv_shard_fraction(tc, tp) == \
            jsch.kv_shard_fraction(jc, tp)
        for batch, n_tok in ((1, 1), (4, 1), (4, 4), (7, 3)):
            assert tsch.decode_step_ici_bytes(tc, batch, tp, n_tok) == \
                jsch.decode_step_ici_bytes(jc, batch, tp, n_tok)
    assert tsch.decode_collective_count(tc) == \
        jsch.decode_collective_count(jc)
    assert tshard.supports_tp(tc, 2) == jshard.supports_tp(jc, 2)


def test_qwen3_14b_step_bytes():
    """The [tp] phase's hold: 40 layers x 2 all-reduces of a (4, 5120)
    bf16 activation at the ring cost, plus the untied head's gather."""
    cfg = tcfg.get_config("qwen3-14b")
    want = 80 * 2 * 4 * 5120 * 2 * 0.5 + 4 * 151936 * 2 * 0.5
    assert tsch.decode_step_ici_bytes(cfg, 4, 2) == want == 3_884_544


def test_parse_mesh_and_scopes_equal_reference():
    for spec in ("2", "1,2", " 1 , 4 ", "3,1"):
        assert tshard.parse_mesh(spec) == jshard.parse_mesh(spec)
    with pytest.raises(ValueError):
        tshard.parse_mesh("1,2,3")
    chip = thw.H100_SXM
    pairs = [(thw.chip_scope(chip), jhw.chip_scope()),
             (thw.tp_scope(chip, 1), jhw.tp_scope(jhw.TPU_V5E, 1)),
             (thw.tp_scope(chip, 4), jhw.tp_scope(jhw.TPU_V5E, 4)),
             (thw.pod_scope(chip, 8), jhw.pod_scope(jhw.TPU_V5E, 8)),
             (thw.multipod_scope(chip, 2, 8),
              jhw.multipod_scope(jhw.TPU_V5E, 2, 8))]
    for mesh in ({"data": 1, "model": 1}, {"data": 2, "model": 4},
                 {"pod": 2, "data": 1, "model": 2}):
        pairs.append((thw.scope_for_mesh(mesh, chip),
                      jhw.scope_for_mesh(mesh)))
    for t, j in pairs:
        assert (t.name, t.n_chips, t.interconnect) == \
            (j.name, j.n_chips, j.interconnect)
    s = thw.tp_scope(chip, 4)
    assert s.interconnect_bw == 4 * 450e9 and s.per_chip_link_bw("dcn") \
        == 50e9 and thw.chip_scope(chip).interconnect_bw == float("inf")


@pytest.mark.parametrize("arch", ["qwen3-14b", "deepseek-v2-236b"])
def test_tp_ledger_terms_equal_reference(arch):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    kw = dict(peak_flops=989e12, peak_flops_by_dtype={"bfloat16": 989e12},
              hbm_bw=3.35e12, hbm_bytes=80 * 10**9, vmem_bw=2e13,
              host_bw=64e9, ici_bw=450e9, dcn_bw=50e9)
    jchip = jhw.ChipSpec(name="c", ici_links=1, vmem_bytes=50 * 10**6, **kw)
    tchip = thw.ChipSpec(name="c", **kw)
    jl, tl = jsch.RooflineLedger(), tsch.RooflineLedger()
    for ctx, batch in [(17, 1), (60, 3), (200, 4)]:
        ici = jsch.decode_step_ici_bytes(jc, 4, 2) / batch
        jl.add_decode_token(jc, ctx, batch, ici_bytes=ici, vmem_bytes=1e6)
        tl.add_decode_token(tc, ctx, batch, ici_bytes=ici, vmem_bytes=1e6)
        ici = jsch.decode_step_ici_bytes(jc, 4, 2, n_tokens=4) / batch
        jl.add_verify_step(jc, ctx, 4, 3, 2, 3, batch, ici_bytes=ici)
        tl.add_verify_step(tc, ctx, 4, 3, 2, 3, batch, ici_bytes=ici)
    jl.swap_bytes = tl.swap_bytes = 2.5e6
    assert tl.decode_ici_bytes == jl.decode_ici_bytes > 0
    for n in (1, 2, 4):
        j, t = jl.terms(jc, jchip, n_chips=n), tl.terms(tc, tchip, n_chips=n)
        assert (t.scope, t.n_chips) == (j.scope, j.n_chips)
        for f in ("flops_dev", "hbm_bytes_dev", "ici_wire_bytes_dev",
                  "vmem_bytes_dev", "host_bytes_dev"):
            assert getattr(t, f) == pytest.approx(getattr(j, f), rel=1e-12)
        assert t.binding_roof == j.binding_roof
        for k, v in j.roofs().items():
            assert t.roofs()[k] == pytest.approx(v, rel=1e-12)


@pytest.mark.parametrize("pipeline", ["off", "double"])
@pytest.mark.parametrize("overlap", ["none", "ring"])
def test_overlapped_levels_equal_reference(pipeline, overlap):
    """``ici`` is an overlapped level exactly when the tensor-parallel
    epilogues run as ring matmuls, as in the reference."""
    import repro.serve as jserve
    import repro.serve.crosscheck as jxc
    from repro_torch.serve import EngineConfig
    from repro_torch.serve.crosscheck import overlapped_levels
    got = overlapped_levels(EngineConfig(pipeline=pipeline, overlap=overlap,
                                         device="cpu"))
    assert got == jxc.overlapped_levels(
        jserve.EngineConfig(pipeline=pipeline, overlap=overlap))
    assert ("ici" in got) == (overlap == "ring")
