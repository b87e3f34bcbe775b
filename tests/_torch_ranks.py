"""Rank processes for the port's multi-rank CPU tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_tensor_parallel.
py``): each rank is a process of its own,
in a ``gloo`` group of ``world`` ranks that meet through a file store.

    python -m tests._torch_ranks RANK WORLD STORE_FILE CASE ARGS_JSON OUT

runs ``CASES[CASE](**ARGS_JSON)`` on every rank and saves what rank 0
returns to ``OUT`` (``torch.save``). Imports torch and the port only.
:func:`spawn` starts the ranks, joins them within a limit and fails if
any rank fails.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: every collective of a rank gives up after this long
RANK_TIMEOUT = datetime.timedelta(seconds=60)


def spawn(case: str, world: int, timeout: float = 120, **kwargs):
    """Run ``case`` on ``world`` rank processes; rank 0's result."""
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "out.pt")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.join(ROOT, "src"), ROOT]), OMP_NUM_THREADS="1")
        env.pop("MASTER_ADDR", None)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "tests._torch_ranks", str(r), str(world),
             os.path.join(d, "store"), case, json.dumps(kwargs), out],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        bad = [(r, p.returncode) for r, p in enumerate(procs)
               if p.returncode != 0]
        if bad:
            raise AssertionError(f"ranks failed {bad}:\n" + "\n".join(
                f"--- rank {r}\n{log[-4000:]}" for r, log in enumerate(logs)))
        return torch.load(out, weights_only=False)


# -- what the ranks run ---------------------------------------------------------

def _cfg(arch):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               kv_dtype="float32")


def _whole(trainer, params, opt):
    """The whole parameters and moments (gathered on every rank)."""
    from repro_torch.training.checkpoint import _leaves
    if trainer.layout is None:
        return {k: t.clone() for k, t in _leaves({"params": params,
                                                  "opt": opt})}
    psh, osh = trainer.shardings(opt)
    sh = dict(_leaves({"params": psh, "opt": osh},
                      is_leaf=lambda x: hasattr(x, "box")))
    return {k: sh[k].gather(t) for k, t in _leaves({"params": params,
                                                    "opt": opt})}


def _train(cfg, mesh, state_dtype, steps, batch, seq, seed=0, ckpt=None,
           restore_seed=None):
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.distributed import MeshSharder, ShardingRules
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, Trainer

    rules = None if mesh is None else ShardingRules(cfg, mesh)
    model = Model(cfg, device="cpu", **({} if rules is None else
                                        {"shard": MeshSharder(rules)}))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps,
                       state_dtype=state_dtype)
    tr = Trainer(model, ocfg, ckpt_dir=ckpt, ckpt_every=10 ** 9,
                 rules=rules)
    p, o = tr.init_state(torch.Generator().manual_seed(
        seed if restore_seed is None else restore_seed))
    start = 0
    if restore_seed is not None:
        p, o, start = tr.maybe_restore(p, o)
        return tr, p, o, [], start
    p, o, log = tr.fit(p, o, SyntheticLM(cfg, DataConfig(seq, batch))
                       .iterate(), steps=steps, log_every=1)
    return tr, p, o, log, start


def case_train(runs, steps=2, batch=8, seq=32):
    """Each run (arch, mesh shape, state dtype): ``steps`` sharded steps
    and, on rank 0, the unsharded port's on the same weights and batches
    in this process: their logs and whole parameters and moments."""
    from repro_torch.launch.mesh import Mesh

    out = []
    for arch, shape, state_dtype in runs:
        cfg = _cfg(arch)
        mesh = Mesh(shape, ("data", "model"))
        tr, p, o, log, _ = _train(cfg, mesh, state_dtype, steps, batch, seq)
        got = dict(log=log, state=_whole(tr, p, o))
        want = None
        if mesh.rank == 0:
            tr0, p0, o0, log0, _ = _train(cfg, None, state_dtype, steps,
                                          batch, seq)
            want = dict(log=log0, state=_whole(tr0, p0, o0))
        out.append((arch, tuple(shape), state_dtype, got, want))
    return out


def case_ckpt(ckpt, shape, arch="llama3-8b", state_dtype="int8", steps=2,
              batch=8, seq=32, save=True):
    """Save (``save``: train ``steps`` sharded steps on mesh ``shape``,
    the trainer's checkpoint at the end) or restore (a fresh trainer on
    ``shape`` resumes from ``ckpt``): the whole state on rank 0."""
    from repro_torch.launch.mesh import Mesh

    cfg = _cfg(arch)
    mesh = Mesh(shape, ("data", "model")) if shape else None
    if save:
        tr, p, o, _, start = _train(cfg, mesh, state_dtype, steps, batch,
                                    seq, ckpt=ckpt)
        start = steps
    else:
        tr, p, o, _, start = _train(cfg, mesh, state_dtype, steps, batch,
                                    seq, ckpt=ckpt, restore_seed=99)
    return dict(step=start, state=_whole(tr, p, o))


def case_gpipe(xs, ws):
    """The port's gpipe over a ('stage',) mesh of every rank, tanh(x @ w)
    stages, on numpy inputs; and the stages run one after another."""
    from repro_torch.distributed import NamedSharding, P
    from repro_torch.distributed.pipeline import gpipe
    from repro_torch.launch.mesh import Mesh

    xs, ws = (torch.tensor(np.asarray(a, np.float32)) for a in (xs, ws))
    n = dist.get_world_size()
    mesh = Mesh((n,), ("stage",))
    local = {"w": NamedSharding(mesh, P("stage")).local(ws)}
    out = gpipe(lambda p, x: torch.tanh(x @ p["w"]), mesh, "stage", n,
                xs.shape[0])(local, xs)
    seq = xs
    for s in range(n):
        seq = torch.tanh(seq @ ws[s])
    return dict(out=out.numpy(), sequential=seq.numpy())


def case_compress(w, batch):
    """The port's compressed data-parallel step over a ('data',) mesh of
    every rank on numpy inputs: each rank its rows of the batch."""
    from repro_torch.distributed import NamedSharding, P
    from repro_torch.distributed.compression import make_compressed_dp_step
    from repro_torch.launch.mesh import Mesh

    w, batch = (torch.tensor(np.asarray(a, np.float32)) for a in (w, batch))
    mesh = Mesh((dist.get_world_size(),), ("data",))
    x = NamedSharding(mesh, P("data")).local(batch)
    fn = make_compressed_dp_step(
        lambda p, xb: torch.mean((xb @ p["w"] - xb) ** 2), mesh, "data")
    g, ef, loss = fn({"w": w}, x, {"w": torch.zeros_like(w)})
    return dict(g=g["w"].numpy(), ef=ef["w"].numpy(), loss=float(loss),
                ef_by_rank=_gathered(ef["w"]))


def _gathered(t):
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t.contiguous())
    return [o.numpy() for o in out]


def _serve_inputs(cfg, batch, seq, seed):
    """Tokens [batch, seq + 1] and a config's frames or patches, from
    ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq + 1))
           .astype(np.int64)}
    if cfg.is_encdec:
        out["frames"] = rng.normal(
            size=(batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.vision_patches:
        out["patches"] = rng.normal(
            size=(batch, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return out


def _serve(model, inputs, seq, cache_len, steps, rows=slice(None),
           plus_one=False):
    """Prefill ``seq`` tokens of the rows ``rows`` into ``cache_len``
    slots, then ``steps`` greedy decode steps: (logits of every step [steps
    + 1, B, V], greedy tokens [steps + 1, B], the caches after them); with
    ``plus_one`` also the logits of one decode step on token ``seq`` and
    of a prefill of ``seq + 1`` tokens."""
    kw = {k: torch.as_tensor(v[rows]).to(model.embed.dtype)
          for k, v in inputs.items() if k != "tokens"}
    toks = torch.as_tensor(inputs["tokens"][rows])
    n_prefix = model.cfg.vision_patches if "patches" in kw else 0
    logits, cache = model.prefill(toks[:, :seq], cache_len=cache_len, **kw)
    out = [logits]
    extra = {}
    if plus_one:
        extra["decode"] = model.decode_step(
            cache, toks[:, seq], seq + n_prefix)[0]
        extra["prefill"] = model.prefill(toks[:, :seq + 1],
                                         cache_len=cache_len, **kw)[0]
        logits, cache = model.prefill(toks[:, :seq], cache_len=cache_len,
                                      **kw)
    for i in range(steps):
        tok = out[-1].argmax(-1)
        logits, cache = model.decode_step(cache, tok, seq + n_prefix + i)
        out.append(logits)
    logits = torch.stack(out)
    return logits, logits.argmax(-1), cache, extra


def _tree_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tree_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _tree_leaves(x, path + (str(i),))
    else:
        yield path, tree


def case_serve(runs, weights=None):
    """Each run (a dict: ``arch``, mesh ``shape``, ``dtype``, ``batch``,
    ``seq``, ``cache_len``, ``steps``, config ``overrides``, ``plus_one``):
    the tensor-parallel prefill and greedy decode steps of the smoke
    config over the mesh (weights drawn from seed 0, or, where ``ref`` is
    set, the reference's from ``weights``, an ``.npz`` of ``arch/name``
    arrays), their logits,
    tokens and caches gathered whole; and, on rank 0, the unsharded
    port's on the same weights and inputs in this process."""
    from repro_torch.core.convert import model_params_from_fields
    from repro_torch.distributed import (MeshParams, MeshSharder,
                                         NamedSharding, P, ShardingRules,
                                         cache_shardings)
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import Model

    bank = (np.load(weights) if any(r.get("ref") for r in runs)
            else None)
    meshes = {}
    out = []
    for run in runs:
        cfg = dataclasses.replace(_cfg(run["arch"]), dtype=run["dtype"],
                                  kv_dtype=run["dtype"],
                                  **run.get("overrides", {}))
        shape = tuple(run["shape"])
        if shape not in meshes:
            meshes[shape] = Mesh(shape, ("data", "model"))
        mesh = meshes[shape]

        def build(device="cpu"):
            if not run.get("ref"):
                return Model(cfg, device=device).init(
                    torch.Generator().manual_seed(0))
            pre = run["arch"] + "/"
            return model_params_from_fields(cfg, {
                k[len(pre):]: bank[k] for k in bank.files
                if k.startswith(pre)}, device=device)

        inputs = _serve_inputs(cfg, run["batch"], run["seq"], run["seed"])
        rules = ShardingRules(cfg, mesh)
        model = build()
        model.shard = MeshSharder(rules)
        layout = MeshParams(model, rules)
        b = run["batch"]
        rows_sh = NamedSharding(mesh, P(rules.batch_dim(b)))
        (lo, hi), = rows_sh.bounds((b,))
        layout.sharder.global_batch = b
        logits, toks, cache, extra = _serve(
            model, inputs, run["seq"], run["cache_len"], run["steps"],
            slice(lo, hi), run.get("plus_one", False))
        whole_rows = NamedSharding(mesh, P(None, rules.batch_dim(b)))
        got = {"logits": whole_rows.gather(logits.clone()),
               "tokens": whole_rows.gather(toks.clone())}
        got.update({k: NamedSharding(mesh, P(rules.batch_dim(b))).gather(
            v.clone()) for k, v in extra.items()})
        shapes = Model(cfg, device="meta").init_cache(b, run["cache_len"])
        shs = cache_shardings(rules, shapes)
        got["cache"] = {"/".join(path): sh.gather(leaf.clone())
                        for (path, leaf), (_, sh) in zip(
                            _tree_leaves(cache), _tree_leaves(shs))}
        got["local_cache"] = {"/".join(path): tuple(leaf.shape)
                              for path, leaf in _tree_leaves(cache)}
        want = None
        if mesh.rank == 0:
            plain = build()
            logits, toks, cache, extra = _serve(
                plain, inputs, run["seq"], run["cache_len"], run["steps"],
                plus_one=run.get("plus_one", False))
            want = {"logits": logits, "tokens": toks, **extra,
                    "cache": {"/".join(path): leaf for path, leaf in
                              _tree_leaves(cache)}}
        out.append((run, got, want))
    return out


def case_suite(cases):
    """Several cases, one after another, in one group: their results."""
    return [CASES[name](**kw) for name, kw in cases]


CASES = {"train": case_train, "ckpt": case_ckpt, "gpipe": case_gpipe,
         "compress": case_compress, "serve": case_serve,
         "suite": case_suite}


def main(argv):
    rank, world, store, case, args, out = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed
    init_distributed("cpu", rank, world, init_file=store,
                     timeout=RANK_TIMEOUT)
    try:
        result = CASES[case](**json.loads(args))
        if rank == 0:
            torch.save(result, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
