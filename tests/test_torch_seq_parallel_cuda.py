"""Context-parallel training on the card, small: ``chip_smoke.py``'s
``[dryrun]`` part (c) at 2 layers, runnable alone.  minicpm-2b's widths
(36 heads, which 5 does not divide) at (data 1, model 5): five gloo
ranks sharing the one card, bf16, remat full, one step from one state,
under deterministic algorithms.  Imports no JAX; compares with the
undistributed port on the same rows and weights:

* the rank's local config is context parallel (36 heads whole a rank,
  attention over its S / 8 query rows);
* loss within ``chip_smoke.py``'s ``tp_loss_bar`` at B x S tokens (its
  derivation beside ``CP_LAYERS`` there: the 5-way FFN reduce and the
  row-count-dependent bf16 products move the final hidden state less
  than the 80-edge walk ``TP_LOGITS_ATOL`` was derived for), grad norm
  within rtol 2^-6;
* replicated leaves (the attention weights, the whole vocabulary, the
  norms) bit-equal on every rank after the step;
* the step's walked ``model`` bytes equal ``train.step.tp_wire_bytes``
  (rtol 1e-9), the sequence gathers included.
"""

import dataclasses
import hashlib
import math

import pytest
import torch

import repro_torch.configs as tcfg
from repro_torch.core.roofline.op_collectives import CollectiveWalk, summarize
from repro_torch.models.common import layout_of
from repro_torch.models.params import tree_paths
from repro_torch.parallel.mesh import (batch_shard, batch_shards,
                                       make_host_mesh, spawn)
from repro_torch.train import (OptConfig, SyntheticLMData, TrainConfig,
                               make_initial_state, make_train_step)
from repro_torch.train.loop import state_shards
from repro_torch.train.step import tp_wire_bytes, train_local_config

pytestmark = pytest.mark.cuda

# 5: the narrowest axis the 36 heads do not divide (at 8 the ranks'
# replicated float32 tied tables and their moments overflow one card)
MODEL, LAYERS, B, S = 5, 2, 2, 320
OPT = OptConfig(lr=1e-3, warmup_steps=0, total_steps=1)
GNORM_RTOL = 2.0 ** -6
# chip_smoke.py's tp_loss_bar(B x S): 2 x TP_LOGITS_ATOL a token, p 1e-6
LOSS_ATOL = 2 * 0.03 * math.sqrt(2 * math.log(2 / 1e-6) / (B * S))


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def cp_cfg():
    return dataclasses.replace(tcfg.get_config("minicpm-2b"),
                               n_layers=LAYERS)


def _rank(rank: int, world: int) -> dict:
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_host_mesh(model=world)
    cfg = cp_cfg()
    tc = TrainConfig(opt=OPT)
    data = SyntheticLMData(cfg, B, S, device=dev, shard=batch_shard(mesh),
                           shards=batch_shards(mesh))
    torch.use_deterministic_algorithms(True, warn_only=True)
    state = make_initial_state(cfg, 0, dev, mesh=mesh)()
    with CollectiveWalk(mesh=mesh) as walk:
        state, m = make_train_step(cfg, tc, mesh)(state, data.batch_at(0))
    sh = dict(tree_paths(state_shards(cfg, mesh)))
    digests = {k: hashlib.sha1(v.contiguous().reshape(-1).view(
        torch.uint8).cpu().numpy().tobytes()).hexdigest()
        for k, v in tree_paths(state) if sh[k] is None}
    every = [None] * world
    dist.all_gather_object(every, digests)
    out = {"loss": float(m["loss"]), "gnorm": float(m["grad_norm"]),
           "walked": {k[0]: v for k, v in
                      summarize(walk.ops).by_axes.items()},
           "tp": tp_wire_bytes(cfg, mesh.sizes, B, S, tc)["model"],
           "local": layout_of(train_local_config(cfg, mesh)
                              ).context_parallel,
           "equal": all(d == every[0] for d in every)}
    del state
    torch.cuda.empty_cache()
    dist.barrier()
    if rank == 0:
        state = make_initial_state(cfg, 0, dev)()
        _, m = make_train_step(cfg, tc)(
            state, SyntheticLMData(cfg, B, S, device=dev).batch_at(0))
        out["one"] = (float(m["loss"]), float(m["grad_norm"]))
    dist.barrier()
    return out


def test_context_parallel_step_on_the_card():
    got = spawn(_rank, MODEL, backend="gloo", device="cuda", timeout=600)
    assert got["local"]
    loss, gnorm = got["one"]
    assert abs(got["loss"] - loss) <= LOSS_ATOL, (got["loss"], loss)
    assert abs(got["gnorm"] - gnorm) <= GNORM_RTOL * gnorm
    assert got["equal"]
    assert got["walked"]["model"] == pytest.approx(got["tp"], rel=1e-9)
