"""The port's training substrate (``repro_torch.training``,
``repro_torch.data``, ``repro_torch.launch.train``) against the
reference's (``repro.training``, ``repro.data``).

The same seeded numpy inputs go through both. Tolerances, and where the
two differ by design:

- ``adamw_update`` at float32 and bfloat16 moments: bit for bit, given
  the same global norm. The norm itself is a float32 sum whose order XLA's
  CPU reduction chooses (lanes and partial sums that no fixed order
  reproduces): within a relative 1e-6 (ROADMAP Queue 3 item 22). So the
  update's comparison hands both packages the reference's norm.
- int8 moments: the first moment's ``q`` and ``scale`` bit for bit; the
  second moment's log-domain quantization runs through ``log`` and
  ``exp``, which XLA's CPU computes with its own approximations (about
  1.4% and 9.5% of float32 inputs off the correctly rounded result,
  where torch's CPU is 0.004% and 1%): its ``lo`` within a relative 1e-6,
  ``q`` within one step, and the parameters within a relative 1e-5 of
  their scale (ROADMAP Queue 3 item 23).
- ``_lr_at``: bit for bit in the warm-up; in the cosine phase within a
  relative 1e-6 (XLA's cosine is its own approximation; near the end of
  the schedule ``1 + cos`` is small and an ulp of it moves lr by up to
  3 ulps), equal at most steps.
- ``Trainer.fit`` over 5 float32 smoke steps: losses within a relative
  1e-5 (measured: under 1e-6).
- ``SyntheticLM`` batches and checkpoints across the packages: bit for
  bit.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.convert import (adamw_state_from_fields,
                                      model_params_from_fields)
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models import Model
from repro_torch.training import (AdamWConfig, PreemptionGuard, Trainer,
                                  adamw_init, adamw_update, latest_step,
                                  restore, run_with_restarts, save,
                                  train_params)
from repro_torch.training import checkpoint as TC
from repro_torch.training import optimizer as TO
from tests.test_torch_harness import reference

STATE_DTYPES = ("float32", "bfloat16", "int8")
NORM_RTOL = 1e-6
LOSS_RTOL = 1e-5
INT8_PARAM_OF_SCALE = 1e-5
SHAPES = {"scan_layers.slot0.ffn.w_up": (3, 64, 512), "final_norm.scale":
          (64,), "rest_layers.0.mixer.wq": (5, 300), "embed": (40, 256)}


@pytest.fixture(scope="module")
def ref():
    R = reference()
    from repro.data import pipeline
    from repro.training import checkpoint, optimizer, train_loop
    R.optimizer, R.checkpoint, R.train_loop, R.pipeline = (
        optimizer, checkpoint, train_loop, pipeline)
    return R


def nested(flat):
    """{dotted: leaf} -> the reference's nested tree: dicts, and a list at
    every level of numeric keys (gaps filled with empty arrays)."""
    out = {}
    for name, v in flat.items():
        node = out
        parts = name.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node.get(str(i), np.zeros(0)))
                    for i in range(max(map(int, node)) + 1)]
        return {k: fix(v) for k, v in node.items()}
    return fix(out)


def draws(seed, scales):
    rng = np.random.default_rng(seed)
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, sc, s).astype(np.float32)
              for k, s in SHAPES.items()} for sc in scales]
    return params, grads


def as_np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# -- quantization and the optimizer --------------------------------------------

def test_quantize_q8_matches_reference(ref):
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    for shape in ((7, 512), (3, 4, 300), (64,)):
        x = (rng.normal(0, 1, shape) * rng.lognormal(0, 3, shape[-1])
             ).astype(np.float32)
        want = ref.optimizer.quantize_q8(jnp.asarray(x))
        got = TO.quantize_q8(torch.from_numpy(x))
        for k in ("q", "scale"):
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)
        np.testing.assert_array_equal(
            TO.dequantize_q8(got, shape).numpy(),
            np.asarray(ref.optimizer.dequantize_q8(want, shape)))


def test_quantize_q8_log_matches_reference_but_for_xla_log(ref):
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = np.abs(rng.normal(0, 1, (16, 512)) * rng.lognormal(0, 4, 512)
               ).astype(np.float32)
    x[0, :256] = 0.0                          # a block at the 1e-30 floor
    want = ref.optimizer.quantize_q8_log(jnp.asarray(x))
    got = TO.quantize_q8_log(torch.from_numpy(x))
    np.testing.assert_allclose(got["lo"].numpy(), np.asarray(want["lo"]),
                               rtol=NORM_RTOL)
    np.testing.assert_allclose(got["scale"].numpy(),
                               np.asarray(want["scale"]), rtol=NORM_RTOL)
    dq = np.abs(got["q"].numpy().astype(int) - np.asarray(want["q"]))
    assert dq.max() <= 1 and dq.mean() < 0.01
    back = TO.dequantize_q8_log(got, x.shape).numpy()
    np.testing.assert_allclose(back, np.asarray(
        ref.optimizer.dequantize_q8_log(want, x.shape)), rtol=2e-2)
    assert (back[0, :256] == 0).all()


def test_global_norm_and_schedule_match_reference(ref):
    import jax.numpy as jnp

    _, grads = draws(2, (0.01, 1.0, 30.0))
    for g in grads:
        want = float(ref.optimizer.global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}))
        got = float(TO.global_norm({k: torch.from_numpy(v)
                                    for k, v in g.items()}))
        np.testing.assert_allclose(got, want, rtol=NORM_RTOL)
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=200, min_lr_frac=0.1)
    steps = np.arange(0, 260, dtype=np.int32)
    want = np.array([float(ref.optimizer._lr_at(
        ref.optimizer.AdamWConfig(**cfg), jnp.asarray(s))) for s in steps],
        np.float32)
    got = np.array([float(TO._lr_at(TO.AdamWConfig(**cfg),
                                    torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps], np.float32)
    np.testing.assert_array_equal(got[:10], want[:10])      # warm-up
    np.testing.assert_allclose(got, want, rtol=NORM_RTOL)
    assert np.mean(got == want) > 0.9


def test_tree_order_is_the_references_leaf_order(ref):
    import jax

    names = list(SHAPES) + ["rest_layers.10.mixer.wq",
                            "rest_layers.2.mixer.wq", "lm_head"]
    paths = [".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in kp)
             for kp, leaf in jax.tree_util.tree_leaves_with_path(
                 nested({n: np.zeros(1) for n in names})) if leaf.size]
    assert TO.tree_order(names) == paths


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_adamw_update_matches_reference(ref, monkeypatch, state_dtype):
    """Six steps from the same parameters and gradients (clipped and not,
    warm-up and cosine), each given the reference's global norm."""
    import jax.numpy as jnp

    R = ref.optimizer
    params, grads = draws(3, (0.01, 0.02, 1.0, 0.5, 0.003, 2.0))
    kw = dict(state_dtype=state_dtype, warmup_steps=3, total_steps=8,
              lr=1e-2)
    rc, tc = R.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jp = nested({k: jnp.asarray(v) for k, v in params.items()})
    js = R.adamw_init(jp, rc)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = adamw_init(tp, tc)
    ref_norm = R.global_norm
    for g in grads:
        norm = ref_norm({k: jnp.asarray(v) for k, v in g.items()})
        monkeypatch.setattr(R, "global_norm", lambda t: norm)
        monkeypatch.setattr(TO, "global_norm",
                            lambda t: torch.tensor(float(norm)))
        jp, js, jm = R.adamw_update(
            nested({k: jnp.asarray(v) for k, v in g.items()}), js, jp, rc)
        tp, ts, tm = adamw_update({k: torch.from_numpy(v)
                                   for k, v in g.items()}, ts, tp, tc)
        assert float(tm["lr"]) == float(jm["lr"])
        want = {k: np.asarray(v) for k, v in _flat(jp).items()}
        if state_dtype != "int8":
            for k in SHAPES:
                np.testing.assert_array_equal(tp[k].numpy(), want[k],
                                              err_msg=k)
                for mom, jmom in ((ts.m, js.m), (ts.v, js.v)):
                    np.testing.assert_array_equal(
                        as_np(mom[k]),
                        np.asarray(_flat(jmom)[k]).astype(np.float32),
                        err_msg=k)
            continue
        jmf = _flat(js.m, moments=True)
        jvf = _flat(js.v, moments=True)
        for k in SHAPES:
            for part in ("q", "scale"):
                np.testing.assert_array_equal(
                    ts.m[k][part].numpy(), np.asarray(jmf[k][part]),
                    err_msg=f"{k} m {part}")
            np.testing.assert_allclose(ts.v[k]["lo"].numpy(),
                                       np.asarray(jvf[k]["lo"]),
                                       rtol=NORM_RTOL)
            dq = np.abs(ts.v[k]["q"].numpy().astype(int)
                        - np.asarray(jvf[k]["q"]))
            assert dq.max() <= 1, k
            scale = np.abs(want[k]).max()
            assert np.abs(tp[k].numpy() - want[k]).max() \
                <= INT8_PARAM_OF_SCALE * scale, k
        assert int(ts.step) == int(js.step)


def _flat(tree, moments=False, prefix=""):
    """{dotted: leaf} of a reference tree (an int8 moment's dict kept
    whole where ``moments``)."""
    out = {}
    if isinstance(tree, dict) and not (moments and "q" in tree):
        for k, v in tree.items():
            out.update(_flat(v, moments, f"{prefix}{k}."))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            out.update(_flat(v, moments, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = tree
    return out


@pytest.mark.parametrize("state_dtype", STATE_DTYPES)
def test_sliced_update_equals_the_whole_leaf(monkeypatch, state_dtype):
    """Slicing along the leading axes changes no bit of the update
    (quantization blocks run along the last dim, which is never cut), the
    global norm held fixed: its float32 sum goes slice by slice."""
    params, grads = draws(4, (0.5, 2.0))
    outs = []
    monkeypatch.setattr(TO, "global_norm", lambda t: torch.tensor(3.0))
    for limit in (TO.SLICE_ELEMS, 1000):
        monkeypatch.setattr(TO, "SLICE_ELEMS", limit)
        monkeypatch.setattr(TO._slices, "__defaults__", (limit,))
        cfg = TO.AdamWConfig(state_dtype=state_dtype, warmup_steps=1)
        tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        ts = adamw_init(tp, cfg)
        for g in grads:
            tp, ts, _ = adamw_update({k: torch.from_numpy(v)
                                      for k, v in g.items()}, ts, tp, cfg)
        outs.append((tp, ts))
    assert len(list(TO._slices((3, 64, 512), 1000))) > 3
    (a, sa), (b, sb) = outs
    for k in SHAPES:
        assert torch.equal(a[k], b[k]), k
        for ma, mb in ((sa.m[k], sb.m[k]), (sa.v[k], sb.v[k])):
            if isinstance(ma, dict):
                assert all(torch.equal(ma[p], mb[p]) for p in ma), k
            else:
                assert torch.equal(ma, mb), k


# -- data ------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "internvl2-76b",
                                  "whisper-large-v3"])
def test_synthetic_batches_match_reference_bitwise(ref, arch):
    cfg = ref.configs.get_smoke_config(arch)
    want = ref.pipeline.SyntheticLM(cfg, ref.pipeline.DataConfig(
        seq_len=24, global_batch=3, seed=5))
    got = SyntheticLM(get_smoke_config(arch), DataConfig(
        seq_len=24, global_batch=3, seed=5))
    for i in (0, 7):
        w, g = want.batch(i), got.batch(i)
        assert sorted(w) == sorted(g)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert "patches" in g or not cfg.vision_patches
    assert "frames" in g or not cfg.is_encdec


# -- checkpoints -------------------------------------------------------------------

def _pair_state(ref, arch, dtype, state_dtype, steps=2):
    """The reference's params and AdamW state after ``steps`` updates, and
    the port's model and state holding the same numbers."""
    import jax
    import jax.numpy as jnp

    cfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                              dtype=dtype, kv_dtype=dtype)
    jm = ref.models.Model(cfg)
    params = jm.init(jax.random.PRNGKey(1))
    ocfg = ref.optimizer.AdamWConfig(state_dtype=state_dtype)
    opt = ref.optimizer.adamw_init(params, ocfg)
    rng = np.random.default_rng(6)
    for _ in range(steps):
        g = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(0, 0.1, p.shape), p.dtype),
            params)
        params, opt, _ = ref.optimizer.adamw_update(g, opt, params, ocfg)
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    port = model_params_from_fields(
        dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                            kv_dtype=dtype), np_tree, device="cpu")
    tp = train_params(port)
    ts = adamw_state_from_fields(
        jax.tree_util.tree_map(np.asarray, opt._asdict()), tp, device="cpu")
    return params, opt, tp, ts


def _assert_same(port_tree, ref_tree):
    import jax

    a = dict(TC._leaves(port_tree))
    b = {"::".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
         np.asarray(v)
         for kp, v in jax.tree_util.tree_leaves_with_path(ref_tree)}
    assert sorted(a) == sorted(b)
    for k, t in a.items():
        w = b[k]
        assert tuple(t.shape) == w.shape, k
        got = TC._to_host(t)[0]
        want = w.view(got.dtype) if w.dtype.itemsize == got.dtype.itemsize \
            and w.dtype != got.dtype else w
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.mark.parametrize("arch,dtype,state_dtype", [
    pytest.param("llama3-8b", d, sd, id=f"{d}-{sd}")
    for d, sd in (("float32", "float32"), ("bfloat16", "bfloat16"),
                  ("bfloat16", "int8"), ("float32", "int8"))] + [
    ("rwkv6-1.6b", "bfloat16", "int8"),
    ("recurrentgemma-9b", "float32", "float32")])
def test_checkpoints_cross_between_the_packages(ref, tmp_path, arch, dtype,
                                                state_dtype):
    import jax

    params, opt, tp, ts = _pair_state(ref, arch, dtype, state_dtype)
    ref_tree = {"params": params, "opt": opt}
    _assert_same({"params": tp, "opt": ts}, ref_tree)
    # the port writes, the reference restores
    port_dir = str(tmp_path / "port")
    save({"params": tp, "opt": ts}, port_dir, 7)
    like = jax.tree_util.tree_map(lambda x: x * 0, ref_tree)
    got, step = ref.checkpoint.restore(port_dir, like)
    assert step == 7
    _assert_same({"params": tp, "opt": ts}, got)
    # the reference writes, the port restores (into zeroed tensors)
    ref_dir = str(tmp_path / "ref")
    ref.checkpoint.save(ref_tree, ref_dir, 9)
    _, _, tp2, ts2 = _pair_state(ref, arch, dtype, state_dtype, steps=0)
    with torch.no_grad():
        for t in TC._leaves({"params": tp2, "opt": ts2}):
            t[1].zero_()
    restored, step = restore(ref_dir, {"params": tp2, "opt": ts2})
    assert step == 9 and latest_step(ref_dir) == 9
    _assert_same(restored, ref_tree)
    # the same files, the same manifest keys and dtypes
    with open(os.path.join(port_dir, "step_00000007", "manifest.json")) as f:
        mp = json.load(f)
    with open(os.path.join(ref_dir, "step_00000009", "manifest.json")) as f:
        mr = json.load(f)
    assert dict(mp, step=9) == mr
    assert sorted(os.listdir(os.path.join(port_dir, "step_00000007"))) == \
        sorted(os.listdir(os.path.join(ref_dir, "step_00000009")))


def test_checkpoint_commit_and_gc(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)}}
    d = str(tmp_path)
    for s in (1, 2, 3, 4):
        save(tree, d, s, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004"]
    os.makedirs(os.path.join(d, "step_00000009.tmp"))   # a preempted save
    assert latest_step(d) == 4
    like = {"params": {"w": torch.zeros(2, 3)}}
    restore(d, like)
    assert torch.equal(like["params"]["w"], tree["params"]["w"])
    with pytest.raises(ValueError, match="shape"):
        restore(d, {"params": {"w": torch.zeros(3, 2)}})
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), like)


# -- the trainer -------------------------------------------------------------------

def _trainers(ref, arch, state_dtype, ckpt=None):
    import jax

    cfg = dataclasses.replace(ref.configs.get_smoke_config(arch),
                              dtype="float32", kv_dtype="float32")
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=5,
              state_dtype=state_dtype)
    rt = ref.train_loop.Trainer(ref.models.Model(cfg),
                                ref.optimizer.AdamWConfig(**kw))
    p, o = rt.init_state(jax.random.PRNGKey(0))
    port = model_params_from_fields(
        dataclasses.replace(get_smoke_config(arch), dtype="float32",
                            kv_dtype="float32"),
        jax.tree_util.tree_map(np.asarray, p), device="cpu")
    return cfg, rt, p, o, Trainer(port, AdamWConfig(**kw), ckpt_dir=ckpt,
                                  ckpt_every=2)


#: per step, the gradient norms' tolerance against the reference's where it
#: is not LOSS_RTOL (their losses are held to LOSS_RTOL at every step).
#: rwkv6-1.6b's smoke gradients are ill-conditioned once trained: at the
#: reference's own parameters after 4 steps, the port's gradient moves by
#: 1e-4 of scale when only its forward's summation order changes
#: (``ref.rwkv6_ordered`` for ``rwkv6_plain``), and AdamW carries that into
#: the next steps' norms. Measured, steps 1-5: float32 1.1e-7, 1.3e-5,
#: 3.4e-6, 6.8e-6, 6.7e-3; int8 1.1e-7, 1.3e-5, 8.2e-5, 5.5e-5, 1.1e-3 (the
#: same at 1 and 8 CPU threads); the limits sit 2.4-8x above them
NORM_RTOL_BY_STEP = {"rwkv6-1.6b": (LOSS_RTOL, 1e-4, 2e-4, 2e-4, 2e-2)}


@pytest.mark.parametrize("arch,state_dtype", [
    ("llama3-8b", "float32"), ("llama3-8b", "int8"),
    ("internvl2-76b", "float32"), ("rwkv6-1.6b", "float32"),
    ("rwkv6-1.6b", "int8"), ("recurrentgemma-9b", "float32")])
def test_trainer_fit_matches_reference_losses(ref, arch, state_dtype):
    cfg, rt, p, o, tt = _trainers(ref, arch, state_dtype)
    _, _, want = rt.fit(p, o, ref.pipeline.SyntheticLM(
        cfg, ref.pipeline.DataConfig(32, 4)).iterate(), steps=5,
        log_every=1)
    tp = train_params(tt.model)
    _, _, got = tt.fit(tp, adamw_init(tp, tt.ocfg), SyntheticLM(
        tt.model.cfg, DataConfig(32, 4)).iterate(), steps=5, log_every=1)
    assert [e["step"] for e in got] == [e["step"] for e in want]
    assert len(tt.step_times) == 5
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(
            g["grad_norm"], w["grad_norm"],
            rtol=NORM_RTOL_BY_STEP.get(arch, [LOSS_RTOL] * 5)[i])
        assert g["lr"] == w["lr"] and g["tokens"] == w["tokens"]


def test_restart_from_checkpoint_resumes_the_same_losses(tmp_path):
    """A run killed at step 3 restarts from its step-2 checkpoint and logs
    the uninterrupted run's losses bit for bit (the CPU is deterministic)."""
    cfg = get_smoke_config("llama3-8b")
    data = SyntheticLM(cfg, DataConfig(16, 2))
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6,
                       state_dtype="int8")

    def attempt(ckpt, fail):
        def run(i):
            tr = Trainer(Model(cfg, device="cpu"), ocfg, ckpt_dir=ckpt,
                         ckpt_every=2)
            p, o = tr.init_state(torch.Generator().manual_seed(0))
            p, o, start = tr.maybe_restore(p, o)
            _, _, log = tr.fit(p, o, data.iterate(start), steps=6,
                               start_step=start, log_every=1,
                               fail_at=3 if fail and i == 0 else None)
            return start, log
        return run

    start, resumed = run_with_restarts(attempt(str(tmp_path), True),
                                       max_restarts=1)
    _, straight = attempt(None, False)(0)
    assert start == 2 and [e["step"] for e in resumed] == [3, 4, 5, 6]
    assert [e["loss"] for e in resumed] == [e["loss"] for e in straight[2:]]


def test_preemption_guard_saves_after_one_step(tmp_path):
    cfg = get_smoke_config("llama3-8b")
    tr = Trainer(Model(cfg, device="cpu"), AdamWConfig(),
                 ckpt_dir=str(tmp_path), ckpt_every=1000)
    p, o = tr.init_state(torch.Generator().manual_seed(0))
    guard = PreemptionGuard(signals=())
    guard._stop = True
    tr.fit(p, o, SyntheticLM(cfg, DataConfig(8, 2)).iterate(), steps=50,
           guard=guard)
    assert latest_step(str(tmp_path)) == 1


def test_launch_train_runs_on_the_cpu_and_refuses_meshes(capsys, tmp_path):
    launch_train.main(["--arch", "llama3-8b", "--smoke", "--steps", "3",
                       "--batch", "2", "--seq", "16", "--device", "cpu",
                       "--state-dtype", "int8", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("step     3 loss=")
    assert latest_step(str(tmp_path)) == 3
    # one process: the meshes need more ranks than it has (the multi-rank
    # runs are tests/test_torch_distributed.py's)
    for mesh, ranks in (("test", 4), ("single", 256), ("multi", 512)):
        with pytest.raises(RuntimeError, match=f"need {ranks} ranks"):
            launch_train.main(["--smoke", "--mesh", mesh, "--device",
                               "cpu"])
        assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.run(get_smoke_config("llama3-8b"), steps=1)


# -- the optimizer on shards ------------------------------------------------------

@pytest.mark.parametrize("whole,lo,hi", [
    ((3, 64, 512), 256, 512),      # a shard of whole 256-element blocks
    ((3, 64, 1024), 0, 768),
    ((5, 300), 0, 300),            # 300 is no multiple of 256: whole rows
    ((4, 96), 0, 96)])
def test_shard_keeps_the_whole_leafs_blocks(whole, lo, hi, state_dtype="int8"):
    """A moment shard along the last dim, widened to whole blocks of the
    whole leaf (``MeshParams``), quantizes as the whole leaf does there:
    the blocks and scales come from the whole leaf's shape, never the
    shard's."""
    x = torch.from_numpy(np.random.default_rng(hi).normal(
        0, 1, whole).astype(np.float32))
    part = x[..., lo:hi]
    block = TO._last_block(part.shape, whole)
    assert block == TO._last_block(whole)
    assert TO._blocks_shape(part.shape, whole) == (
        tuple(whole[:-1]) + ((hi - lo) // block, 1))
    for q, dq in ((TO.quantize_q8, TO.dequantize_q8),
                  (TO.quantize_q8_log, TO.dequantize_q8_log)):
        got = q(part.abs(), block)
        want = q(x.abs())
        b0, b1 = lo // block, hi // block
        assert torch.equal(got["q"], want["q"][..., lo:hi])
        for k in got:
            if k != "q":
                assert torch.equal(got[k], want[k][..., b0:b1, :])
        assert torch.equal(dq(got, part.shape, block=block),
                           dq(want, x.shape)[..., lo:hi])
    m = TO._moment_init(part.shape, "cpu", "int8", "v", block)
    assert m["scale"].shape == TO._blocks_shape(part.shape, whole)
