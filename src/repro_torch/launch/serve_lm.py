"""Continuous-batching serving on three architecture families (dense GQA
paged KV, MLA paged latent cache, recurrent slot state): the JAX
package's ``examples/serve_lm.py`` on the port.

More requests than decode slots: completions free slots mid-flight and
queued requests are admitted into them.  Each request finishes with a
decode roofline ledger (I = W/Q per token, bound class).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve_lm        # the card

Smoke configs (qwen3-0.6b, deepseek-v2-236b, xlstm-350m), 6 requests of
16-token prompts and 16 new tokens over 3 slots with 8-line pages.  On
the card the GQA and MLA decode steps launch the paged-attention kernels
(``kernels/paged_attention.py``: rows 1 and 4).  Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, smoke
from ..device import resolve_device
from ..models import init_params
from ..serve import Engine, EngineConfig, GenerateConfig

ARCHS = ("qwen3-0.6b", "deepseek-v2-236b", "xlstm-350m")


def run(arch: str, device, requests: int = 6, slots: int = 3,
        prompt_len: int = 16, new: int = 16) -> dict:
    """Serve ``requests`` random prompts of ``arch``'s smoke config and
    print the reference's line: cache kind, tok/s, the first request's
    decode AI and bound class, its first 8 tokens."""
    cfg = smoke(get_config(arch))
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, gen, device)
    engine = Engine(cfg, params, EngineConfig(
        num_slots=slots, page_size=8, max_len=prompt_len + new,
        device=device))
    g = GenerateConfig(max_new_tokens=new)
    for i in range(requests):
        prompt = np.random.default_rng(100 + i).integers(
            0, cfg.vocab_size, prompt_len).astype(np.int32)
        engine.submit(prompt, g)
    t0 = time.perf_counter()
    done = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n_new = sum(len(r.generated) for r in done)
    first = min(done, key=lambda r: r.request_id)
    terms = first.ledger.terms(cfg)
    kind = ("latent" if cfg.use_mla
            else ("state" if cfg.subquadratic else "kv"))
    print(f"{arch:<22} cache={kind:<6} {requests} reqs/{slots} slots "
          f"{n_new / dt:7.1f} tok/s  AI={terms.arithmetic_intensity:5.2f} "
          f"{terms.bound_class()}  sample={first.generated[:8]}")
    return {"arch": arch, "kind": kind, "requests": len(done),
            "tokens": n_new, "tok_s": n_new / dt,
            "finished": all(len(r.generated) == new for r in done),
            "ai": terms.arithmetic_intensity,
            "bound": terms.bound_class(), "sample": first.generated[:8]}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arch", choices=ARCHS, action="append")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    return [run(arch, dev) for arch in (args.arch or ARCHS)]


if __name__ == "__main__":
    main()
