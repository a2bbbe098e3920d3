"""Training's loss and gradients on the recurrent mixers' archs
(xlstm-350m: mLSTM and sLSTM; jamba-v0.1-52b: mamba, attention and MoE):
the port against the JAX package, as test_torch_train_grads.py holds
the others (its helpers, its tolerances: loss rtol 1e-5; gradients rtol
1e-4, atol 1e-5 in units of the leaf's largest gradient where that
exceeds 1; remat bit for bit)."""

import pytest

from test_torch_train_grads import (RECURRENT, _check_grads, _check_loss,
                                    _check_remat, two_threads)  # noqa: F401


@pytest.mark.parametrize("arch", RECURRENT)
def test_loss_matches_reference(arch):
    _check_loss(arch)


@pytest.mark.parametrize("arch", RECURRENT)
def test_grads_match_reference(arch):
    _check_grads(arch)


def test_remat_gives_the_same_gradients():
    _check_remat("jamba-v0.1-52b")
