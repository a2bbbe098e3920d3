"""The port's top-k / top-p filter against the JAX package's dispatch,
``repro.serve.sampling._filter_logits``: the sort below V 1024 or when
some k exceeds V / 8, the sort-free threshold scan otherwise.  Kept sets
must be equal, ties included (every logit tied at the k-th value counts
in the scan's nucleus mass, where the sort counts exactly k ranks).

Margin: the nucleus boundary compares a float32 sum of probabilities with
top_p, summed in another order by XLA and by torch, so where that mass
lies within 1e-6 of top_p the two may differ by one token.  The random
rows of :func:`test_untied_rows_equal_reference_outside_the_margin` keep
only rows whose nucleus boundary (float64) is more than 1e-6 from top_p;
every other test's rows are chosen so that no boundary mass comes near
it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as js
from repro_torch.serve import sampling as ts

# the float32 summation-order margin at the nucleus boundary (see above)
NUCLEUS_MARGIN = 1e-6


def _kept(logits, top_ks, top_ps, temps):
    """Kept masks of the reference's and the port's dispatchers."""
    want = np.asarray(js._filter_logits(
        jnp.asarray(logits), jnp.asarray(top_ks), jnp.asarray(top_ps),
        jnp.asarray(temps))) > ts.NEG_INF / 2
    got = ts._filter_logits(
        torch.from_numpy(logits), torch.from_numpy(top_ks),
        torch.from_numpy(top_ps), torch.from_numpy(temps)).numpy() \
        > ts.NEG_INF / 2
    return want, got


def test_tied_case_keeps_four_tokens():
    """V 2048, logits 6, 5, 5, 5 and the rest -3, top_k 2, top_p 0.5: the
    three-way tie at the k-th value is kept, and the nucleus counts it."""
    logits = np.full((1, 2048), -3.0, np.float32)
    logits[0, :4] = [6.0, 5.0, 5.0, 5.0]
    args = (np.array([2], np.int32), np.array([0.5], np.float32),
            np.array([1.0], np.float32))
    want, got = _kept(logits, *args)
    assert want.sum() == 4 and got.sum() == 4
    np.testing.assert_array_equal(got, want)
    through_engine_path = ts._filtered(torch.from_numpy(logits), args[2],
                                       args[0], args[1])
    assert int((through_engine_path > ts.NEG_INF / 2).sum()) == 4


def _tied_rows(rng, B, V):
    """Logits on a quarter-unit grid: many values tie at every rank."""
    return (np.round(rng.standard_normal((B, V)) * 12) / 4).astype(np.float32)


@pytest.mark.parametrize("V", [257, 2048, 4096])
@pytest.mark.parametrize("seed", range(3))
def test_tied_rows_equal_reference(V, seed):
    rng = np.random.RandomState(seed)
    B = 8
    logits = _tied_rows(rng, B, V)
    top_ks = rng.choice([0, 1, 2, 5, 40], B).astype(np.int32)
    top_ps = rng.choice([0.0, 0.3, 0.9, 1.0], B).astype(np.float32)
    temps = rng.choice([0.5, 1.0, 2.0], B).astype(np.float32)
    want, got = _kept(logits, top_ks, top_ps, temps)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("V", [2048, 4096])
@pytest.mark.parametrize("extra", [0, 1], ids=["k=V/8 scan", "k>V/8 sort"])
def test_dispatch_switches_at_v_over_8(V, extra, monkeypatch):
    """A k at V / 8 keeps the scan, one past it takes the sort (for the
    whole batch), and the kept sets equal the reference's either way."""
    calls = []
    for fn in ("_filter_logits_scan", "_filter_logits_sort"):
        real = getattr(ts, fn)
        monkeypatch.setattr(ts, fn, lambda *a, _r=real, _n=fn: (
            calls.append(_n), _r(*a))[1])
    rng = np.random.RandomState(V + extra)
    B = 4
    logits = _tied_rows(rng, B, V)
    top_ks = np.array([V // 8 + extra, 3, 0, 7], np.int32)
    top_ps = np.array([0.9, 0.0, 0.5, 1.0], np.float32)
    temps = np.ones((B,), np.float32)
    want, got = _kept(logits, top_ks, top_ps, temps)
    np.testing.assert_array_equal(got, want)
    assert calls == ["_filter_logits_scan" if extra == 0
                     else "_filter_logits_sort"]


def test_small_vocab_takes_the_sort(monkeypatch):
    calls = []
    monkeypatch.setattr(ts, "_filter_logits_scan",
                        lambda *a: calls.append("scan"))
    logits = torch.from_numpy(_tied_rows(np.random.RandomState(0), 2, 1023))
    ts._filter_logits(logits, torch.tensor([1, 2]), torch.tensor([0.5, 0.0]),
                      torch.ones(2))
    assert calls == []


def _nucleus_margin(logits, top_ks, top_ps, temps):
    """Per row, the float64 distance of top_p from the nearest cumulative
    mass of the tempered, top-k-renormalized distribution."""
    out = np.full(logits.shape[0], np.inf)
    for b in range(logits.shape[0]):
        row = np.sort(logits[b].astype(np.float64))[::-1] / temps[b]
        k = top_ks[b] if top_ks[b] > 0 else row.size
        row = row[:k]
        p = np.exp(row - row.max())
        cum = np.cumsum(p / p.sum())
        out[b] = np.abs(cum - top_ps[b]).min()
    return out


@pytest.mark.parametrize("V", [257, 2048, 151936])
@pytest.mark.parametrize("seed", range(2))
def test_untied_rows_equal_reference_outside_the_margin(V, seed):
    rng = np.random.RandomState(100 + seed)
    B = 16
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    top_ks = rng.choice([0, 1, 5, 50, 200], B).astype(np.int32)
    top_ps = rng.choice([0.0, 0.3, 0.8, 0.95], B).astype(np.float32)
    temps = rng.choice([0.7, 1.0, 1.5], B).astype(np.float32)
    clear = _nucleus_margin(logits, top_ks, top_ps, temps) > NUCLEUS_MARGIN
    assert clear.sum() >= B - 2          # the margin excludes few rows
    rows = np.flatnonzero(clear)
    want, got = _kept(logits[rows], top_ks[rows], top_ps[rows], temps[rows])
    np.testing.assert_array_equal(got, want)


def test_maybe_filter_leaves_unfiltered_batches_alone():
    logits = torch.randn(3, 2048)
    out = ts._maybe_filter(logits, torch.zeros(3, dtype=torch.int32),
                           torch.tensor([0.0, 1.0, 0.0]), torch.ones(3))
    assert out is logits
    out = ts._maybe_filter(logits, torch.tensor([0, 4, 0]),
                           torch.zeros(3), torch.ones(3))
    assert int((out[1] > ts.NEG_INF / 2).sum()) == 4
    assert torch.equal(out[0], logits[0])


@pytest.mark.parametrize("sampler", ["sample_tokens", "sample_with_probs",
                                     "spec_accept"])
def test_samplers_draw_only_from_the_reference_kept_set(sampler):
    """Every sampler reaches the dispatch: on the tied V 2048 row the
    draws and the proposal / target distributions stay on the 4 kept
    tokens, the set the reference keeps (the sort would keep 1)."""
    V, n = 2048, 64
    row = np.full((V,), -3.0, np.float32)
    row[:4] = [6.0, 5.0, 5.0, 5.0]
    seeds = np.arange(n, dtype=np.int64)
    steps = np.zeros((n,), np.int32)
    temps = np.full((n,), 1.0, np.float32)
    top_ks = np.full((n,), 2, np.int32)
    top_ps = np.full((n,), 0.5, np.float32)
    kept = set(range(4))
    logits = torch.from_numpy(np.broadcast_to(row, (n, V)).copy())
    if sampler == "sample_tokens":
        toks = ts.sample_tokens(logits, seeds, steps, temps, top_ks, top_ps)
        assert set(toks.tolist()) <= kept and len(set(toks.tolist())) > 1
    elif sampler == "sample_with_probs":
        toks, probs = ts.sample_with_probs(logits, seeds, steps, temps,
                                           top_ks, top_ps)
        assert set(toks.tolist()) <= kept
        assert torch.all((probs[:, 4:] == 0)) and torch.all(probs[:, 1:4] > 0)
    else:
        T = 2
        out, n_out = ts.spec_accept(
            logits[:, None].expand(n, T, V).contiguous(),
            np.full((n, 1), 4, np.int32), None, np.ones((n,), np.int32),
            seeds, steps, temps, top_ks, top_ps)
        # draft token 4 lies outside the kept set: always rejected, and
        # the resampled token comes from the kept set
        assert torch.all(n_out == 1)
        assert set(out[:, 0].tolist()) <= kept
