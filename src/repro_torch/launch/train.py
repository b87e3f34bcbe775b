"""Training launcher: real steps on one device, or sharded over a mesh.

Port of the reference's ``launch/train.py``. The model's weights are
drawn on ``--device`` (``cuda`` unless given; it raises without a GPU)
from a ``torch.Generator`` seeded with ``--seed``; steps run with remat
on, checkpoints every ``--ckpt-every`` steps, preemption handling and
restart from the latest checkpoint.

``--mesh none`` trains on one device. ``--mesh test`` (a (2, 2) mesh of
('data', 'model')), ``single`` (16 x 16) and ``multi`` (2 x 16 x 16)
train over a ``torch.distributed`` group of one process per device
(``nccl`` on CUDA, ``gloo`` on the CPU; rank and world size from
``torchrun``'s environment): the parameters held as shards by the
reference's ``ShardingRules``, the moments as ZeRO-1 parts, each rank
computing its rows of every batch, checkpoints whole and restored on any
mesh (``repro_torch.distributed``). Unlike the reference's meshed branch,
remat stays on. ``python -m repro_torch.launch.dryrun`` traces the
production meshes' steps without a GPU.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
        --state-dtype int8 [--smoke] [--steps 50] [--ckpt DIR]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --mesh test --smoke --device cpu --steps 2
"""
import argparse
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..configs.registry import ARCHS, get_config, get_smoke_config
from ..core.vectorsim import resolve_device
from ..data.pipeline import DataConfig, SyntheticLM
from ..distributed.sharding import MeshSharder, ShardingRules
from ..models.config import ModelConfig
from ..models.model import Model
from ..training.fault import PreemptionGuard, run_with_restarts
from ..training.optimizer import AdamWConfig
from ..training.train_loop import Trainer
from .mesh import init_distributed, make_production_mesh, make_test_mesh

MESHES = ("none", "test", "single", "multi")


def run(cfg: ModelConfig, steps: int = 100, batch: int = 8, seq: int = 128,
        lr: float = 1e-3, ckpt: Optional[str] = None, ckpt_every: int = 50,
        state_dtype: str = "float32", max_restarts: int = 2, device=None,
        seed: int = 0, log_every: int = 10, guard=None, mesh=None):
    """Train ``cfg`` for ``steps`` steps on ``SyntheticLM`` batches of
    ``batch`` x ``seq`` tokens, resuming from ``ckpt`` where it holds a
    checkpoint; over ``mesh`` (a ``launch.mesh.Mesh``) sharded by the
    reference's rules. Returns (trainer, params, optimizer state, metric
    log)."""
    dev = resolve_device(device)
    ocfg = AdamWConfig(lr=lr, warmup_steps=max(steps // 10, 1),
                       total_steps=steps, state_dtype=state_dtype)
    data = SyntheticLM(cfg, DataConfig(seq_len=seq, global_batch=batch))
    guard = guard or PreemptionGuard()
    out = {}

    def attempt(attempt_idx: int):
        rules = None if mesh is None else ShardingRules(cfg, mesh)
        model = Model(cfg, device=dev, remat=True,
                      **({} if rules is None
                         else {"shard": MeshSharder(rules)}))
        trainer = Trainer(model, ocfg, ckpt_dir=ckpt, ckpt_every=ckpt_every,
                          rules=rules)
        params, opt = trainer.init_state(
            torch.Generator(device=dev).manual_seed(seed))
        params, opt, start = trainer.maybe_restore(params, opt)
        out["trainer"] = trainer
        return trainer.fit(params, opt, data.iterate(start), steps=steps,
                           start_step=start, log_every=log_every,
                           guard=guard)

    params, opt, log = run_with_restarts(attempt, max_restarts=max_restarts)
    return out["trainer"], params, opt, log


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--state-dtype", default="float32",
                    choices=("float32", "bfloat16", "int8"))
    ap.add_argument("--mesh", choices=MESHES, default="none")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model and its steps (under a "
                         "mesh, CUDA takes device LOCAL_RANK)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights' torch.Generator")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    device = args.device
    started = False
    mesh = None
    try:
        if args.mesh != "none":
            resolve_device(device)
            started = not dist.is_initialized()
            init_distributed(device)
            if torch.device(device).type == "cuda":
                device = torch.device("cuda", torch.cuda.current_device())
            mesh = (make_test_mesh() if args.mesh == "test" else
                    make_production_mesh(multi_pod=args.mesh == "multi"))
        _, _, _, log = run(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, lr=args.lr, ckpt=args.ckpt,
                           ckpt_every=args.ckpt_every,
                           state_dtype=args.state_dtype,
                           max_restarts=args.max_restarts, device=device,
                           seed=args.seed, mesh=mesh)
    finally:
        if started:
            dist.destroy_process_group()
    if mesh is not None and mesh.rank != 0:
        return
    for e in log:
        print(f"step {e['step']:5d} loss={e['loss']:.4f} lr={e['lr']:.2e}"
              + (" [straggled]" if e.get("straggled") else ""))


if __name__ == "__main__":
    main()
