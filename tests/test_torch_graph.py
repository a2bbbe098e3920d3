"""The port's captured-step plumbing and the paper's dispatch floor on the
CPU, against the JAX package's engine where it has a counterpart.

CUDA graphs cannot exist on the CPU: here the same step bodies run
eagerly over the same persistent input buffers.  What the CPU can show:

* ``Engine._no_kernel_cfg`` equals ``repro``'s twin field by field except
  ``head_dim``, ``kv_lora_rank`` and ``rope_head_dim``, raised to the
  smallest sizes the port's CUDA kernels take;
* ``reset_phases``, ``step_count`` and ``measure_dispatch_overhead``
  behave as ``repro``'s;
* ``cuda_graphs=True`` on the CPU raises;
* the static-buffer step bodies give ``repro``'s greedy streams;
* the decode, verify, catch-up and draft step bodies, run on meta
  tensors (standing for the card: shapes without data, and any host data
  that meets them is a CPU tensor) with the paged-attention ops stubbed,
  make no host sync, no ``nonzero`` and no cross-device copy: what a
  capture would refuse.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jcfg
import repro.models as jm
import repro.serve as jserve
import repro_torch.configs as tcfg
import repro_torch.models as tm
import repro_torch.serve as tserve
from repro_torch import bridge
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.models.params import tree_map
from repro_torch.serve import engine as teng_mod
from repro_torch.serve import graphs as tgraphs

# the three fields the port raises above the reference's floors, and the
# smallest size each kernel takes
RAISED = {"head_dim": min(tpa.KERNEL_HEAD_DIMS),
          "kv_lora_rank": min(tpa.MLA_LATENT_DIMS),
          "rope_head_dim": min(tpa.MLA_ROPE_DIMS)}
PAGED_OPS = ("paged_attention", "paged_attention_verify",
             "mla_paged_attention", "mla_paged_attention_verify")


def _load(arch):
    jc = jcfg.smoke(jcfg.get_config(arch))
    tc = tcfg.smoke(tcfg.get_config(arch))
    jp = jm.init_params(jc, jax.random.key(0))
    tp = tm.prepare_params(
        bridge.to_torch(jax.tree.map(np.asarray, jp), device="cpu"), tc)
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def qwen():
    return _load("qwen3-0.6b")


@pytest.fixture(scope="module")
def deepseek():
    return _load("deepseek-v2-236b")


def _prompt(seed, length, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, length).astype(
        np.int32)


def _twins(cfg_port, cfg_ref):
    """Both engines' no-kernel twins (the method reads only ``cfg``)."""
    port = tserve.Engine._no_kernel_cfg(types.SimpleNamespace(cfg=cfg_port))
    ref = jserve.Engine._no_kernel_cfg(types.SimpleNamespace(cfg=cfg_ref))
    return port, ref


def _value(v):
    if isinstance(v, tuple):
        return tuple(dataclasses.astuple(x) if dataclasses.is_dataclass(x)
                     else x for x in v)
    return v


@pytest.mark.parametrize("arch", tcfg.ALL_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_no_kernel_cfg_equals_reference_but_kernel_floors(arch, smoke):
    tc, jc = tcfg.get_config(arch), jcfg.get_config(arch)
    if smoke:
        tc, jc = tcfg.smoke(tc), jcfg.smoke(jc)
    port, ref = _twins(tc, jc)
    assert port.name == ref.name == tc.name + "-nokernel"
    for f in dataclasses.fields(port):
        if f.name in RAISED:
            continue
        assert _value(getattr(port, f.name)) == _value(
            getattr(ref, f.name)), f.name
    # the raised fields: the reference's floor, lifted to the kernel's
    # smallest size, never above this config's own
    assert port.hd == min(tc.hd, max(ref.hd, RAISED["head_dim"]))
    assert port.hd in tpa.KERNEL_HEAD_DIMS
    if tc.kv_lora_rank:
        assert port.kv_lora_rank == min(
            tc.kv_lora_rank, max(ref.kv_lora_rank, RAISED["kv_lora_rank"]))
        assert port.kv_lora_rank in tpa.MLA_LATENT_DIMS
        assert port.rope_head_dim in tpa.MLA_ROPE_DIMS
    else:
        assert port.kv_lora_rank == ref.kv_lora_rank == 0
    assert port.rope_head_dim == min(
        tc.rope_head_dim, max(ref.rope_head_dim, RAISED["rope_head_dim"]))
    # at full width every one of the three is floored by the reference
    # below the kernels' smallest size, so each is raised
    if not smoke and tc.kv_lora_rank:
        assert {k for k in RAISED
                if getattr(port, k) != getattr(ref, k)} == set(RAISED)


def _engines(model, **ecfg):
    jc, tc, jp, tp = model
    jeng = jserve.Engine(jc, jp, jserve.EngineConfig(**ecfg))
    teng = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu", **ecfg))
    return jeng, teng


ECFG = dict(num_slots=2, page_size=4, max_len=32)


def test_reset_phases_and_step_count_as_the_reference(qwen):
    jeng, teng = _engines(qwen, **ECFG)
    for eng in (jeng, teng):
        eng.reset_phases()                       # no scheduler yet: no-op
        assert eng.step_count == 0
    gen = dict(max_new_tokens=5)
    for i, s in enumerate([5, 7, 6]):
        jeng.submit(_prompt(30 + i, s), jserve.GenerateConfig(**gen))
        teng.submit(_prompt(30 + i, s), tserve.GenerateConfig(**gen))
    while jeng._sched.has_work():
        jeng.step()
        teng.step()
        assert teng.step_count == jeng.step_count
    assert not teng._sched.has_work()
    assert teng.step_count == jeng.step_count > 3
    keys = set(jeng.phases)
    assert set(teng.phases) == keys and "decode" in keys
    jeng.reset_phases()
    teng.reset_phases()
    assert dict(jeng.phases) == dict(teng.phases) == {}
    assert teng.step_count == jeng.step_count      # phases only
    jeng.reset()
    teng.reset()
    assert teng.step_count == jeng.step_count == 0


def test_measure_dispatch_overhead_is_cached_until_reset(qwen, monkeypatch):
    _, teng = _engines(qwen, **ECFG)
    teng.reset()
    built = []
    real = teng_mod.Engine.__init__

    def spy(self, cfg, *a, **kw):
        built.append(cfg.name)
        real(self, cfg, *a, **kw)

    monkeypatch.setattr(teng_mod.Engine, "__init__", spy)
    calls = {op: 0 for op in PAGED_OPS}
    saved = ops.registered_kernels()

    def counted(op):
        def f(*a, **kw):
            calls[op] += 1
            return saved[op]["cpu"](*a, **kw)
        return f

    try:
        for op in PAGED_OPS:
            ops.register_kernel(op, cuda=saved[op]["cuda"],
                                reference=counted(op),
                                ring=saved[op].get("ring"))
        s = teng.measure_dispatch_overhead(repeats=3)
    finally:
        for op in PAGED_OPS:
            ops.register_kernel(op, cuda=saved[op]["cuda"],
                                reference=saved[op]["cpu"],
                                ring=saved[op].get("ring"))
    assert isinstance(s, float) and s > 0.0
    assert built == [teng.cfg.name + "-nokernel"]
    # the twin's decode step went through the paged-attention op, once per
    # layer and call (1 untimed + 3 timed)
    assert calls["paged_attention"] == 4 * teng.cfg.n_layers
    assert teng.measure_dispatch_overhead(repeats=3) == s
    assert len(built) == 1                       # cached: no second twin
    teng.reset()
    assert teng._dispatch_s is None
    s2 = teng.measure_dispatch_overhead(repeats=2)
    assert s2 > 0.0 and len(built) == 2


def test_cuda_graphs_true_on_the_cpu_raises(qwen):
    _, tc, _, tp = qwen
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu",
                                                  cuda_graphs=True))
    with pytest.raises(ValueError, match="cuda_graphs=True"):
        tserve.SpecEngine(tc, tp, tserve.EngineConfig(
            device="cpu", cuda_graphs=True), tserve.SpecConfig(k=2))
    cpu = torch.device("cpu")
    assert tgraphs.graphs_enabled(None, cpu) is False
    assert tgraphs.graphs_enabled(False, cpu) is False
    eng = tserve.Engine(tc, tp, tserve.EngineConfig(device="cpu"))
    assert eng.graphs is False
    eng.reset()
    assert eng._graphs.enabled is False and eng.graph_capture_s == 0.0


def _watch_bodies(monkeypatch, module, name):
    """Record the (tables, tokens, positions) tensors each call of the
    model function ``module.name`` receives."""
    seen = []
    real = getattr(module, name)

    def spy(params, cfg, pools, bt, tok, pos, **kw):
        seen.append((bt, tok, pos))
        return real(params, cfg, pools, bt, tok, pos, **kw)

    monkeypatch.setattr(module, name, spy)
    return seen


@pytest.mark.parametrize("arch", ["qwen", "deepseek"])
def test_static_buffer_step_streams_equal_the_reference(
        arch, qwen, deepseek, monkeypatch):
    model = {"qwen": qwen, "deepseek": deepseek}[arch]
    seen = _watch_bodies(monkeypatch, teng_mod, "decode_step_paged")
    jeng, teng = _engines(model, **ECFG, prefill_chunk=3)
    gen = dict(max_new_tokens=6)
    prompts = [_prompt(40 + i, s) for i, s in enumerate([5, 8, 6, 7])]
    jreqs = [jeng.submit(p, jserve.GenerateConfig(**gen)) for p in prompts]
    treqs = [teng.submit(p, tserve.GenerateConfig(**gen)) for p in prompts]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.generated == [int(x) for x in j.generated]
    # every decode step read the same three persistent buffers
    assert len(seen) == teng.decode_steps > 0
    bufs = (teng._kv.tables.tensor, teng._tok_in.tensor, teng._pos_in.tensor)
    for args in seen:
        assert all(a is b for a, b in zip(args, bufs))


def test_static_buffer_spec_streams_equal_the_reference(qwen, monkeypatch):
    jc, tc, jp, tp = qwen
    from repro_torch.serve import proposer as tprop
    from repro_torch.serve import spec as tspec
    verify = _watch_bodies(monkeypatch, tspec, "decode_step_verify_paged")
    catch = _watch_bodies(monkeypatch, tprop, "decode_step_verify_paged")
    draft = _watch_bodies(monkeypatch, tprop, "decode_step_paged")
    ecfg = dict(num_slots=2, page_size=4, max_len=40)
    jeng = jserve.SpecEngine(jc, jp, jserve.EngineConfig(**ecfg),
                             jserve.SpecConfig(k=3, proposer="draft",
                                               draft_cfg=jc, draft_params=jp))
    teng = tserve.SpecEngine(tc, tp, tserve.EngineConfig(device="cpu",
                                                         **ecfg),
                             tserve.SpecConfig(k=3, proposer="draft",
                                               draft_cfg=tc, draft_params=tp))
    gen = dict(max_new_tokens=7)
    prompts = [_prompt(50 + i, s) for i, s in enumerate([6, 9, 5])]
    jreqs = [jeng.submit(p, jserve.GenerateConfig(**gen)) for p in prompts]
    treqs = [teng.submit(p, tserve.GenerateConfig(**gen)) for p in prompts]
    jeng.run()
    teng.run()
    for j, t in zip(jreqs, treqs):
        assert t.generated == [int(x) for x in j.generated]
    prop = teng.proposer
    assert len(verify) == teng.verify_steps == len(catch) > 0
    assert len(draft) == 2 * len(catch)              # k - 1 draft steps
    for seen, bufs in (
            (verify, (teng._kv.tables.tensor, teng._feed_in.tensor,
                      teng._pos_in.tensor)),
            (catch, (prop.kv.tables.tensor, prop._feed_in.tensor,
                     prop._pos_in.tensor)),
            (draft, (prop.kv.tables.tensor, prop._step_tok,
                     prop._step_pos))):
        for args in seen:
            assert all(a is b for a, b in zip(args, bufs))


# -- capturability: no host sync, no nonzero, no cross-device copy ---------

FORBIDDEN = ("aten::_local_scalar_dense", "aten::nonzero",
             "aten::lift_fresh")


class HostTraffic(TorchDispatchMode):
    """Records each op of a step body that a CUDA graph capture would
    refuse or bake in: a device-to-host read (``.item()`` and the like
    dispatch ``_local_scalar_dense``), ``nonzero`` (a host sync for its
    size), host data turned into a tensor, and any copy or op mixing a
    device tensor with a CPU one that is not a 0-dim scalar."""

    def __init__(self):
        super().__init__()
        self.found = []
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.ops += 1
        name = func._schema.name
        if name in FORBIDDEN:
            self.found.append(name)
        devs = set()
        for a in list(args) + list(kwargs.values()):
            for t in (a if isinstance(a, (list, tuple)) else [a]):
                if isinstance(t, torch.Tensor) and not (
                        t.device.type == "cpu" and t.dim() == 0):
                    devs.add(t.device.type)
        if "device" in kwargs and kwargs["device"] is not None:
            devs.add(torch.device(kwargs["device"]).type)
        if len(devs) > 1:
            self.found.append(f"{name} across {sorted(devs)}")
        return func(*args, **kwargs)


@pytest.fixture
def stubbed_paged_ops(monkeypatch):
    """The paged-attention ops stubbed to shape-true zeros on any device,
    so their plain versions' host reads do not count."""
    def stub(q, *a, **kw):
        return torch.zeros_like(q)

    monkeypatch.setattr(ops, "resolve", lambda name, device, pipeline=None:
                        stub)


def _on_meta(x):
    return tree_map(lambda t: t.to("meta"), x)


def _meta_buffers(owner, attrs):
    for a in attrs:
        obj = getattr(owner, a)
        if isinstance(obj, tgraphs.StaticInput):
            obj.tensor = _on_meta(obj.tensor)
        else:
            setattr(owner, a, _on_meta(obj))


def _capturable(body):
    watch = HostTraffic()
    with watch:
        out = body()
    assert out.device.type == "meta"
    return watch


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
@pytest.mark.parametrize("arch", ["qwen", "deepseek"])
def test_step_bodies_are_capturable(arch, kv_dtype, qwen, deepseek,
                                    stubbed_paged_ops):
    _, tc, _, tp = {"qwen": qwen, "deepseek": deepseek}[arch]
    eng = tserve.SpecEngine(
        tc, tp, tserve.EngineConfig(device="cpu", kv_dtype=kv_dtype, **ECFG),
        tserve.SpecConfig(k=3, proposer="draft", draft_cfg=tc,
                          draft_params=tp))
    eng.reset()
    prop = eng.proposer
    for owner in (eng, prop):
        owner.params = _on_meta(owner.params)
    for kv in (eng._kv, prop.kv):
        kv.pools = _on_meta(kv.pools)
        kv.tables.tensor = _on_meta(kv.tables.tensor)
    _meta_buffers(eng, ["_tok_in", "_pos_in", "_feed_in"])
    _meta_buffers(prop, ["_feed_in", "_pos_in", "_step_tok", "_step_pos"])
    bodies = {"decode": eng._decode_body, "verify": eng._verify_body,
              "catch-up": prop._catchup_body, "draft": prop._draft_body}
    for name, body in bodies.items():
        watch = _capturable(body)
        assert watch.ops > 50, name
        assert watch.found == [], (name, watch.found)


def test_host_traffic_catches_what_a_capture_refuses():
    """The watcher itself: each forbidden pattern is seen."""
    x = torch.zeros(4, device="meta")
    for bad, want in (
            (lambda: x.sum().item(), "_local_scalar_dense"),
            (lambda: torch.nonzero(x), "nonzero"),
            (lambda: x + torch.ones(4), "across"),
            (lambda: torch.as_tensor(np.zeros(4)).to("meta"), "across")):
        watch = HostTraffic()
        with watch:
            try:
                bad()
            except Exception:
                pass                       # meta tensors may refuse it too
        assert any(want in f for f in watch.found), (want, watch.found)
