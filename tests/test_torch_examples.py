"""The examples' torch legs on the CPU (``--device cpu``) and
``core/analysis.py::kernel_character``.

* ``launch/quickstart.py`` (``examples/quickstart.py``): the train step's
  roofline report before any step, 5 steps, 8 decoded tokens for 2
  prompts;
* ``launch/roofline_analysis.py`` (``examples/roofline_analysis.py``):
  the host's roofs measured, matmul / GELU / LayerNorm at 512 x 512
  placed on them, an archived dry-run cell read back through
  ``launch/reanalyze.py`` (the cell walked here, on a smoke config);
* ``launch/serve_lm.py`` (``examples/serve_lm.py``): three families, 6
  requests over 3 slots, the reference's line for each.

``kernel_character`` returns the reference's keys.  Its W / Q are the
op walk's, held against the port's shape counts (``core/analysis.py``'s
``*_character``) and the reference's ``kernel_character`` (its HLO
cost walk) on the same primitives.  Where the two walks' conventions
differ the difference is held exactly:

* the matrix product: equal, W, Q and transcendentals;
* GELU: the walk counts ``x ** 3`` as one op where the shape count (and
  the reference's walk) counts two multiplies: W is 8 / 9 of theirs; the
  eight aten ops each read their operands and write their result, 18
  element passes where the fused least traffic is 2: Q is 9 times;
* LayerNorm: the reference's XLA:CPU program recomputes the mean's
  division (one per row) and sums long rows in windows of 32 (two row
  sums: ``2 r partials(d)``); the walk has neither: W is theirs less
  r (2 partials(d) + 1); its ten aten ops move 14 r d + 9 r + 2 d
  elements against the least 2 r d + 2 d; the reference's fusions move
  less than the walk, more than the least.
"""

import re

import jax.numpy as jnp
import pytest
import torch

from repro.core.analysis import kernel_character as ref_character
from repro.kernels import ref as jref
from repro_torch.core import analysis
from repro_torch.core.analysis import kernel_character
from repro_torch.kernels import ref as tref
from repro_torch.launch import (dryrun, quickstart, reanalyze,
                                roofline_analysis, serve_lm)
from repro_torch.launch.mesh import make_production_mesh

torch.set_num_threads(2)


def xla_cpu_row_sum_partials(d: int) -> int:
    """Partial sums XLA:CPU adds when it sums a row of more than 32 values
    in windows of 32 (again over the partials while more than 32),
    ``tests/test_torch_norm_pool_attention.py``'s count."""
    extra = 0
    while d > 32:
        d = -(-d // 32)
        extra += d
    return extra


# --------------------------------------------------------------------------
# kernel_character
# --------------------------------------------------------------------------

def test_kernel_character_returns_the_reference_keys():
    x = torch.ones(8, 8)
    mine = kernel_character(tref.gelu, x)
    theirs = ref_character(jref.gelu, jnp.ones((8, 8)))
    assert set(mine) == set(theirs) == {"W_flops", "Q_bytes",
                                        "transcendentals", "AI"}
    assert mine["AI"] == mine["W_flops"] / mine["Q_bytes"]


@pytest.mark.parametrize("m,k,n", [(256, 384, 512), (512, 512, 512)])
def test_matmul_character_equals_shape_count_and_reference(m, k, n):
    mine = kernel_character(tref.inner_product, torch.ones(m, k),
                            torch.ones(k, n))
    shape = analysis.inner_product_character(m, k, n)
    theirs = ref_character(jref.inner_product, jnp.ones((m, k)),
                           jnp.ones((k, n)))
    for key in ("W_flops", "Q_bytes", "transcendentals"):
        assert mine[key] == shape[key] == theirs[key], key


@pytest.mark.parametrize("shape", [(512, 512), (4096, 512), (64, 100)])
def test_gelu_character_against_shape_count_and_reference(shape):
    mine = kernel_character(tref.gelu, torch.ones(shape))
    count = analysis.gelu_character(shape)
    theirs = ref_character(jref.gelu, jnp.ones(shape))
    e = shape[0] * shape[1]
    assert count["W_flops"] == theirs["W_flops"] == 9 * e
    assert mine["W_flops"] == 8 * e                     # x ** 3: one op
    assert mine["transcendentals"] == theirs["transcendentals"] == e
    assert count["Q_bytes"] == theirs["Q_bytes"] == 2 * e * 4
    assert mine["Q_bytes"] == 9 * count["Q_bytes"]      # 8 ops, unfused


@pytest.mark.parametrize("r,d", [(512, 512), (64, 100), (128, 1024)])
def test_layernorm_character_against_shape_count_and_reference(r, d):
    args = (torch.ones(r, d), torch.ones(d), torch.zeros(d))
    mine = kernel_character(tref.layernorm, *args)
    count = analysis.layernorm_character(r, d)
    theirs = ref_character(jref.layernorm, jnp.ones((r, d)), jnp.ones((d,)),
                           jnp.zeros((d,)))
    partials = xla_cpu_row_sum_partials(d)
    assert theirs["W_flops"] == count["W_flops"] + 2 * r * partials
    assert mine["W_flops"] == count["W_flops"] - r
    assert mine["W_flops"] == theirs["W_flops"] - r * (2 * partials + 1)
    assert mine["transcendentals"] == theirs["transcendentals"] == r
    assert count["Q_bytes"] == (2 * r * d + 2 * d) * 4
    assert mine["Q_bytes"] == (14 * r * d + 9 * r + 2 * d) * 4
    assert count["Q_bytes"] < theirs["Q_bytes"] < mine["Q_bytes"]


def test_kernel_character_computes_nothing():
    """The walk runs on fake tensors: a product far too large to compute
    here is characterised at once."""
    n = 1 << 16
    big = torch.empty((n, n), device="meta")
    c = kernel_character(tref.inner_product, big, big)
    assert c["W_flops"] == 2.0 * n ** 3


# --------------------------------------------------------------------------
# the legs
# --------------------------------------------------------------------------

def test_quickstart_leg(capsys):
    out = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert re.search(r"^model: qwen3-0\.6b-smoke, [0-9.]+M params$", text,
                     re.M)
    # the report comes before the first step
    assert text.index("== roofline: quickstart train step ==") < \
        text.index("  step 0: loss=")
    steps = re.findall(r"^  step (\d): loss=([0-9.]+) lr=", text, re.M)
    assert [int(s) for s, _ in steps] == list(range(quickstart.TRAIN_STEPS))
    assert all(torch.isfinite(torch.tensor(out["losses"])))
    assert out["report"].character.flops_dev > 0
    toks = out["tokens"]
    assert toks.shape == (quickstart.PROMPTS,
                          quickstart.PROMPT_LEN + quickstart.NEW)
    assert re.search(r"^decoded: \[(\d+, ){7}\d+\]$", text, re.M)


def test_roofline_analysis_leg(capsys, tmp_path, monkeypatch):
    d = str(tmp_path / "dryrun_torch")
    monkeypatch.setattr(reanalyze, "RESULTS_DIR", d)
    import repro_torch.configs as tcfg
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: tcfg.smoke(tcfg.get_config(a)))
    with make_production_mesh() as mesh:
        walked = dryrun.run_cell("qwen3-14b", "train_4k", mesh,
                                 verbose=False)
    out = roofline_analysis.main(["--device", "cpu", "--cache", ""])
    text = capsys.readouterr().out
    assert re.search(r"^device cpu: pi=[0-9.]+ GFLOP/s \(float32\), "
                     r"beta=[0-9.]+ GB/s$", text, re.M)
    names = [p[0] for p in out["points"]]
    assert names == ["matmul", "gelu", "layernorm"]
    for name, ai, perf in out["points"]:
        assert ai > 0 and perf > 0
        assert f" = {name}: AI=" in text
    assert out["points"][0][1] == pytest.approx(512 / 6)   # 2 n^3 / 12 n^2
    assert out["cell"]["t_lower_s"] == walked["t_lower_s"]
    assert "qwen3-14b/train_4k on a 16 x 16 H100 mesh" in text


@pytest.mark.parametrize("arch", serve_lm.ARCHS)
def test_serve_lm_leg(capsys, arch):
    res, = serve_lm.main(["--device", "cpu", "--arch", arch])
    text = capsys.readouterr().out
    kind = {"qwen3-0.6b": "kv", "deepseek-v2-236b": "latent",
            "xlstm-350m": "state"}[arch]
    assert res["kind"] == kind
    assert res["requests"] == 6 and res["finished"]
    assert res["tokens"] == 6 * 16
    line = (rf"^{re.escape(arch)} +cache={kind} +6 reqs/3 slots +[0-9.]+ "
            r"tok/s  AI= *[0-9.]+ (memory|compute)-bound  sample=\[")
    assert re.search(line, text, re.M), text
