"""The tier-1 test run's cost on this host (host CPU time, not a device
number): runs the tier-1 pytest command given after `--` (ROADMAP.md,
"Tier-1 verify", as it is run) from a tree with a new, empty JAX
compilation cache, `-v` (one more per `-q`) and `--durations=0` added, and
prints what the run spent:

  * the wall seconds and the outcome counts;
  * per xdist worker, when its last test ended (the run's critical path);
  * the summed test seconds per file, the port's (`test_torch_*`) and the
    JAX package's apart;
  * the longest tests (setup + call + teardown) and every setup over 5 s
    (a module fixture built on more than one worker shows up once per
    worker);
  * the busy CPU cores over time (from /proc/stat, every 10 s).

    python tests/torch_tier1_cost.py [--tree DIR] [--cores 0-7] [--log FILE]
        [--skip-port] [--compiles] -- python -m pytest tests/ ...
    python tests/torch_tier1_cost.py --summarize LOG

`--skip-port` skips every `test_torch_*` test at its setup, so the run
keeps the collected count and xdist's first dispatch but does only the JAX
package's tests: the floor the port's tests add to.  `--compiles` also
records every XLA compile over 0.5 s (seconds, test, whether the
persistent cache held it, and its cache key, so one program compiled by
two tests shows as one key) from JAX's compile-duration events and its
cache log, and prints them by program.  `--summarize LOG` prints the
summary of an earlier run's log (and of its `LOG.compiles`, if any).  Not
collected by pytest (a full run takes 15-25 minutes on 8 cores with a
cold cache).
"""

import argparse
import collections
import json
import logging
import os
import re
import subprocess
import tempfile
import threading
import time

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NODE = {"id": None}


@pytest.hookimpl(tryfirst=True)
def pytest_runtest_setup(item):
    """Loaded as a plugin (`--skip-port`, `--compiles`): skip the port's
    tests where asked."""
    if os.environ.get("TIER1_SKIP_PORT") and "test_torch_" in item.nodeid:
        pytest.skip("the port's tests left out of this run (--skip-port)")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    _NODE["id"] = item.nodeid
    yield
    _NODE["id"] = None


class _CacheKeys(logging.Handler):
    """The persistent cache's hit/miss records (logged just before the
    compile or load they name), per thread."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.last = threading.local()

    def emit(self, record):
        msg = str(record.msg)
        if msg.startswith(("Persistent compilation cache hit", "PERSISTENT COMPILATION CACHE MISS")):
            self.last.key = (str(record.args[1]), msg.startswith("Persistent"))


def pytest_configure(config):
    """With `--compiles`, record every XLA compile of this process."""
    out = os.environ.get("TIER1_COMPILES")
    if not out:
        return
    import jax

    keys = _CacheKeys()
    log = logging.getLogger("jax._src.compiler")
    log.setLevel(logging.DEBUG)
    log.addHandler(keys)

    def on_duration(event, secs, **kw):
        if event == "/jax/core/compile/backend_compile_duration" and secs > 0.5:
            key, hit = getattr(keys.last, "key", ("?", False))
            keys.last.key = ("?", False)
            with open(out, "a") as f:
                f.write(json.dumps(dict(s=round(secs, 2), test=_NODE["id"], hit=hit,
                                        fun=kw.get("fun_name"), program=key[-12:])) + "\n")

    jax.monitoring.register_event_duration_secs_listener(on_duration)


def compiles(path):
    """The compiles of a `--compiles` run by program, largest first."""
    by = collections.defaultdict(list)
    for line in open(path):
        r = json.loads(line)
        by[r["program"]].append(r)
    recs = [r for v in by.values() for r in v]
    print(f"XLA compiles over 0.5 s: {len(recs)}, {sum(r['s'] for r in recs):.1f} s "
          f"({sum(r['hit'] for r in recs)} loaded from the cache)")
    for prog, rs in sorted(by.items(), key=lambda x: -sum(r["s"] for r in x[1]))[:40]:
        print(f"  {prog} " + "; ".join(f"{r['s']:.1f} s{' (hit)' if r['hit'] else ''} {r['test']}"
                                       for r in rs))


def _busy_cores(stop, out):
    """Append (seconds since start, busy cores) every 10 s until `stop`."""
    def read():
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
        return sum(v[:3]) + sum(v[5:8]), sum(v)
    t0, (b0, a0) = time.time(), read()
    while not stop.wait(10):
        b1, a1 = read()
        out.append((time.time() - t0, os.cpu_count() * (b1 - b0) / max(1, a1 - a0)))
        b0, a0 = b1, a1


def run(cmd, tree, cores, log, extra_env=()):
    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=cache, **dict(extra_env))
        if cores:
            cmd = ["taskset", "-c", cores] + cmd
        stop, busy = threading.Event(), []
        sampler = threading.Thread(target=_busy_cores, args=(stop, busy), daemon=True)
        sampler.start()
        t0 = time.time()
        with open(log, "w") as f:
            proc = subprocess.Popen(cmd, cwd=tree, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            for line in proc.stdout:
                f.write(f"{time.time() - t0:8.1f} {line}")
            rc = proc.wait()
            f.write(f"RC={rc} WALL={time.time() - t0:.1f}\n")
            f.write(f"BUSY {_by_100(busy)}\n")
        stop.set()
        sampler.join()
    return rc


def _by_100(busy):
    bins = collections.defaultdict(list)
    for t, b in busy:
        bins[int(t // 100) * 100].append(b)
    return " ".join(f"{k}:{sum(v) / len(v):.1f}" for k, v in sorted(bins.items()))


def summarize(log, longest=25):
    lines = open(log).read().splitlines()
    ends, phases = {}, collections.defaultdict(dict)
    for line in lines:
        m = re.match(r"\s*([\d.]+) \[(gw\d+)\] \[\s*\d+%\] (PASSED|FAILED|SKIPPED|ERROR) (\S+)", line)
        if m:
            ends[m.group(4)] = (float(m.group(1)), m.group(2))
        m = re.match(r"\s*[\d.]+ ([\d.]+)s (setup|call|teardown)\s+(\S+)", line)
        if m:
            phases[m.group(3)][m.group(2)] = float(m.group(1))
    print(*[line for line in lines if line.startswith(("RC=", "BUSY")) or " passed" in line][-3:],
          sep="\n")
    wall = [float(m.group(1)) for line in lines if (m := re.match(r"RC=\S+ WALL=([\d.]+)", line))]
    busy = [line.split()[1:] for line in lines if line.startswith("BUSY ")]
    if wall and busy:  # each bin's mean busy cores over its 100 s (the last one to the end)
        bins = [(int(k), float(v)) for k, v in (b.split(":") for b in busy[-1])]
        stops = [k for k, _ in bins[1:]] + [wall[-1]]
        print(f"busy core-seconds: {sum(v * (e - k) for (k, v), e in zip(bins, stops)):.0f}")
    last = {}
    for node, (t, w) in ends.items():
        if t > last.get(w, (0, ""))[0]:
            last[w] = (t, node)
    print("last test end per worker:")
    for w in sorted(last, key=lambda w: int(w[2:])):
        print(f"  {w} {last[w][0]:7.1f} {last[w][1]}")
    total = {n: sum(p.values()) for n, p in phases.items()}
    files = collections.Counter()
    for n, d in total.items():
        files[n.split("::")[0]] += d
    port = sum(d for f, d in files.items() if "test_torch_" in f)
    print(f"summed test seconds: port {port:.1f}, JAX package {sum(files.values()) - port:.1f}")
    for f, d in files.most_common():
        print(f"  {d:7.1f} {f}")
    print(f"{longest} longest tests (setup + call + teardown; worker, end):")
    for n, d in sorted(total.items(), key=lambda x: -x[1])[:longest]:
        print(f"  {d:7.1f} {ends.get(n, ('?', '?'))[1]} {ends.get(n, ('?', '?'))[0]} {n}")
    print("setups over 5 s:")
    for n, p in sorted(phases.items(), key=lambda x: -x[1].get("setup", 0)):
        if p.get("setup", 0) > 5:
            print(f"  {p['setup']:7.1f} {ends.get(n, ('?', '?'))[1]} {n}")
    if os.path.exists(log + ".compiles"):
        compiles(log + ".compiles")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=_REPO)
    ap.add_argument("--cores", default="0-7", help="taskset core list ('' for none)")
    ap.add_argument("--log", default=os.path.join(tempfile.gettempdir(), "tier1_cost.log"))
    ap.add_argument("--skip-port", action="store_true")
    ap.add_argument("--compiles", action="store_true")
    ap.add_argument("--summarize", metavar="LOG")
    ap.add_argument("cmd", nargs="*", help="the tier-1 pytest command, after --")
    args = ap.parse_args()
    if args.summarize:
        return summarize(args.summarize)
    if not args.cmd:
        ap.error("give the tier-1 pytest command after --")
    # -v per -q in the command and one more: one line per test with its worker
    cmd, extra = args.cmd + ["-v"] * (1 + args.cmd.count("-q")) + ["--durations=0"], {}
    if args.skip_port or args.compiles:
        cmd += ["-p", "torch_tier1_cost"]
        extra["PYTHONPATH"] = os.pathsep.join(
            filter(None, [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH")]))
    if args.skip_port:
        extra["TIER1_SKIP_PORT"] = "1"
    if args.compiles:
        extra["TIER1_COMPILES"] = os.path.abspath(args.log) + ".compiles"
        open(extra["TIER1_COMPILES"], "w").close()
    run(cmd, os.path.abspath(args.tree), args.cores, args.log, extra.items())
    summarize(args.log)


if __name__ == "__main__":
    main()
