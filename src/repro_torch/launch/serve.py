"""Serving launcher: batched requests through the hybrid scheduler.

Real decode runs on the device for reduced configs; the production-
config path plans the batch with roofline latency models and reports the
cost/makespan outcome versus the all-private / all-elastic baselines.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 64 --deadline-frac 0.5 --order spt [--execute-smoke]

Everything runs on ``--device`` (``cuda`` unless given; it raises without
a GPU): the smoke model's weights are drawn there from a seeded generator,
and the ridge fit runs there. The baselines and the one (order, C_max)
schedule replay on the host's DES, as in the JAX package's launcher.
"""
import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs.registry import ARCHS, get_config, get_smoke_config
from ..core.vectorsim import resolve_device
from ..models.model import Model
from ..serving.engine import InferenceEngine, Request
from ..serving.hybrid import HybridServingScheduler


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="llama3-8b")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--deadline-frac", type=float, default=0.5,
                    help="C_max as a fraction of the all-private makespan")
    ap.add_argument("--order", choices=("spt", "hcf"), default="spt")
    ap.add_argument("--execute-smoke", action="store_true",
                    help="also run a real reduced-model decode batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and the fit")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    if args.execute_smoke:
        cfg = get_smoke_config(args.arch)
        model = Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        eng = InferenceEngine(model, cache_len=192)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(8, 96))
                                        ).astype(np.int32), 16)
                for i in range(min(args.requests, 8))]
        outs = eng.generate_batch(reqs)
        print(f"executed {len(outs)} requests on {dev} "
              f"(prefill {outs[0].prefill_s * 1e3:.1f} ms, "
              f"decode {outs[0].decode_s * 1e3:.1f} ms)")

    sched = HybridServingScheduler(get_config(args.arch), device=dev)
    sched.fit_perf_models(n_train=200, seed=args.seed)
    plen = rng.integers(128, 4096, args.requests)
    ntok = rng.integers(32, 512, args.requests)
    pub, priv = sched.baselines(plen, ntok, seed=args.seed + 1)
    c_max = priv.makespan * args.deadline_frac
    rep = sched.schedule(plen, ntok, c_max=c_max, order=args.order,
                         seed=args.seed + 1)
    r = rep.result
    print(f"arch={args.arch} J={args.requests} order={args.order}")
    print(f"all-private: {priv.makespan:8.2f}s  $0")
    print(f"all-public : {pub.makespan:8.2f}s  ${pub.cost_usd:.4f}")
    print(f"hybrid     : {r.makespan:8.2f}s  ${r.cost_usd:.4f} "
          f"(C_max={c_max:.2f}s, met={r.makespan <= c_max * 1.05}, "
          f"{100 * r.cost_usd / max(pub.cost_usd, 1e-12):.0f}% of all-public, "
          f"{r.n_offloaded_stages} stage executions offloaded)")


if __name__ == "__main__":
    main()
