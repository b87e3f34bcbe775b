"""Time the vector engine's three inner loops on one CUDA card.

    python tools/time_engine_twins.py [--J 512] [--rounds 3]

The Fig.-4 grid of ``chip_smoke.py`` (its generator: 30 scenarios over
three applications) at ``--J`` jobs, uncapped and at chip_smoke's
congested point, under ``engine_impl`` ``kernel``, ``scan`` and ``loop``:

1. walls: ``--rounds`` rounds per load, the impls in alternating order
   (kernel, scan, loop, then loop, scan, kernel, ...), the prep cache
   cleared before every sweep. Prints each sweep's wall, engine seconds
   and body steps, each impl's median, and each round's ratio of a
   twin's wall to that round's ``kernel`` wall;
2. parts: one more sweep per impl and load with the ACD step
   (``ops.acd_evict`` as the engine calls it, or
   ``vectorsim._acd_twin`` and inside it the
   host's ``vectorsim._acd_round``) and the capped chain
   (``ops.fifo_dispatch`` or ``vectorsim._slot_chain``) each bracketed
   by ``torch.cuda.synchronize``: their summed wall and calls beside
   that sweep's own wall (the brackets add syncs, so the sweep is not
   one of the timed ones);
3. device: one uncapped sweep per impl under ``torch.profiler``: the
   device-busy share of its wall, device events per body step and the
   top device events.

Prints the card's name and power limit first; exits 1 without CUDA.
"""
import argparse
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPLS = ("kernel", "scan", "loop")


def sweep(tasks, kw, impl):
    """One timed sweep on the card with the prep cache cleared first;
    returns (wall s, engine s, body steps)."""
    import torch

    from repro_torch.core import sweep_scenarios, vectorsim

    vectorsim._PREP_CACHE.clear()
    t0 = time.perf_counter()
    sweep_scenarios(tasks, device="cuda", engine_impl=impl, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = vectorsim._LAST_RUN_STATS
    return wall, stats["engine_s"], sum(sum(t) for t in stats["trips"])


def walls(tasks, kw, load, rounds):
    """Part 1: alternating rounds; prints every sweep and the summary."""
    got = {impl: [] for impl in IMPLS}
    ratios = {impl: [] for impl in IMPLS[1:]}
    for r in range(rounds):
        order = IMPLS if r % 2 == 0 else IMPLS[::-1]
        this = {}
        for impl in order:
            this[impl] = sweep(tasks, kw, impl)
            wall, eng, steps = this[impl]
            got[impl].append(this[impl])
            print(f"walls {load} round {r} {impl}: wall {wall!r} s, engine "
                  f"{eng!r} s, {steps} body steps, "
                  f"{wall * 1e3 / steps!r} ms of wall a step")
        for impl in IMPLS[1:]:
            ratios[impl].append(this[impl][0] / this["kernel"][0])
    for impl in IMPLS:
        w = statistics.median(x[0] for x in got[impl])
        e = statistics.median(x[1] for x in got[impl])
        steps = got[impl][0][2]
        line = (f"walls {load} {impl} median of {rounds}: wall {w!r} s, "
                f"engine {e!r} s, {steps} body steps, "
                f"{w * 1e3 / steps!r} ms of wall a step")
        if impl != "kernel":
            line += (f"; wall / the round's kernel wall "
                     f"{[round(x, 4) for x in ratios[impl]]}")
        print(line)


def parts(tasks, kw, load):
    """Part 2: the ACD step and the capped chain timed alone."""
    import torch

    from repro_torch.core import vectorsim
    from repro_torch.kernels import ops

    class Ops:
        """The engine's view of ``ops``, its two wrappers timed (the
        wrappers themselves stay in place: they count their launches
        through their own names)."""

        def __getattr__(self, name):
            return getattr(ops, name)

    seam = Ops()
    names = {"acd_evict": (seam, "acd_evict"),
             "fifo_dispatch": (seam, "fifo_dispatch"),
             "_acd_twin": (vectorsim, "_acd_twin"),
             "_acd_round": (vectorsim, "_acd_round"),
             "_slot_chain": (vectorsim, "_slot_chain")}
    real = {k: getattr(mod, attr) for k, (mod, attr) in names.items()}
    rec = {k: [0, 0.0] for k in names}

    def timed(key):
        fn = real[key]

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            rec[key][0] += 1
            rec[key][1] += time.perf_counter() - t0
            return out
        return wrapped

    for key, (mod, attr) in names.items():
        setattr(mod, attr, timed(key))
    vectorsim._kernel_ops = seam
    try:
        for impl in IMPLS:
            for v in rec.values():
                v[:] = [0, 0.0]
            wall, eng, steps = sweep(tasks, kw, impl)
            acd = rec["acd_evict"] if impl == "kernel" else rec["_acd_twin"]
            chain = (rec["fifo_dispatch"] if impl == "kernel"
                     else rec["_slot_chain"])
            line = (f"parts {load} {impl}: bracketed sweep wall {wall!r} s, "
                    f"{steps} body steps; ACD step {acd[1]!r} s in "
                    f"{acd[0]} calls ({acd[1] / wall:.4f} of the wall)")
            if impl != "kernel":
                host = rec["_acd_round"]
                line += (f", of it the host's sequential round {host[1]!r} s"
                         f" and the copies and masking {acd[1] - host[1]!r} "
                         f"s")
            line += (f"; capped chain {chain[1]!r} s in {chain[0]} calls "
                     f"({chain[1] / wall:.4f} of the wall); rest of the "
                     f"sweep {wall - acd[1] - chain[1]!r} s")
            print(line)
    finally:
        vectorsim._kernel_ops = ops
        for key, (mod, attr) in names.items():
            setattr(mod, attr, real[key])


def device(tasks):
    """Part 3: one uncapped sweep per impl under the profiler."""
    import chip_smoke
    from repro_torch.core import sweep_scenarios, vectorsim

    for impl in IMPLS:
        vectorsim._PREP_CACHE.clear()
        got = chip_smoke.device_profile(f"device {impl}", lambda: (
            sweep_scenarios(tasks, device="cuda", engine_impl=impl)))
        if got is None:
            continue
        busy_s, wall_p, events = got
        steps = sum(sum(t) for t in vectorsim._LAST_RUN_STATS["trips"])
        n = sum(e.count for e in events)
        print(f"device uncapped {impl}: busy {busy_s!r} s of a {wall_p!r} s "
              f"profiled wall ({busy_s / wall_p:.4f} busy), {n} device "
              f"events, {n / steps:.2f} a body step ({steps} steps)")
        chip_smoke.print_top_events(events)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--J", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_engine_twins: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke
    from repro_torch.core import APPS, ColdStartModel, demo_portfolio
    from repro_torch.kernels import build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    build.build_all(["acd_evict", "fifo_dispatch"])
    cs = ColdStartModel(warm_up_s=chip_smoke.LOAD_WARM_UP_S,
                        keep_alive_s=2.0 * chip_smoke.LOAD_WARM_UP_S,
                        scale_to_zero=True)
    loads = {"uncapped": {},
             "congested": dict(
                 portfolio=demo_portfolio(chip_smoke.LOAD_PROVIDERS),
                 concurrency=chip_smoke.LOAD_CAP, coldstart=cs)}
    tasks = chip_smoke.fig4_workload(APPS, args.J)
    warm = chip_smoke.fig4_workload(APPS, 64)
    for kw in loads.values():
        for impl in IMPLS:
            sweep(warm, kw, impl)
    for load, kw in loads.items():
        walls(tasks, kw, load, args.rounds)
    for load, kw in loads.items():
        parts(tasks, kw, load)
    device(tasks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
